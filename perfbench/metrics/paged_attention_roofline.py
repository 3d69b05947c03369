"""The paged decode attention kernel's share of its roofline in the traced
span: the least time the chip could take for the live rows of the ticks
inside the span (``perfbench/counts/kernels.paged_decode``, each layer
once) over the device time of its split and combine kernels."""

from perfbench.counts import kernels, peaks

LAYER = "paged attention kernel (kernels/paged_attention.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "itl_mean_ms"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    dev = tr.kernel_seconds(lambda n: "paged_attention" in n or "combine_splits" in n)
    layers = rec.model["num_hidden_layers"]
    bound = sum(layers * peaks.bound_s(*kernels.paged_decode(rec.model, ctxs))
                for ctxs in rec.ticks(tr.start, tr.end))
    return 100.0 * bound / dev if dev and bound else None
