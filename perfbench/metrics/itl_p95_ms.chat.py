"""The tail of the gaps between tokens: the 95th percentile of every gap
between consecutive tokens of a request, both stamped inside the window,
as ``itl_mean_ms`` takes their mean (``perfbench/harness/endtoend.py``).
It lands where the ticks that carry a prefill chunk begin, and swings from
run to run by more than an end-to-end bound can hold (PERF.md section 2)."""

from perfbench.harness.endtoend import itls, percentile

LAYER = "engine (runtime/serving.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "itl_mean_ms"


def read(rec):
    g = itls(rec.win)
    return 1e3 * percentile(g, 95) if g else None
