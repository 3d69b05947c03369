"""The SSD chunk kernel's share of its roofline in the traced span: the
least time the chip could take for the prefill chunks of the admissions
inside the span (``perfbench/counts/kernels.ssd_chunk``, each layer once)
over the device time of its bodies."""

from perfbench.counts import kernels, peaks

LAYER = "SSD kernel (kernels/ssd_chunk.py)"
UNIT = "%"
BETTER = "higher"
MOVES = "itl_mean_ms"


def read(rec):
    tr = rec.trace
    if tr is None:
        return None
    dev = tr.kernel_seconds(lambda n: "ssd_tc_kernel" in n or "ssd_chunk_kernel" in n)
    layers = rec.model["n_layer"]
    bound = sum(layers * peaks.bound_s(*kernels.ssd_chunk(rec.model, n))
                for _, length, _, _ in rec.admits(tr.start, tr.end)
                for n, _ in rec.chunks(length))
    return 100.0 * bound / dev if dev and bound else None
