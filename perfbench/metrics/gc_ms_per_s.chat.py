"""The time Python's collector took in the window (``Record.gc_ms_per_s``),
in the chat cells: the loop runs the program as it leaves the collector,
so its pauses are part of every host-paced step."""

LAYER = "Python collector (host)"
UNIT = "ms/s"
BETTER = "lower"
MOVES = "itl_mean_ms"


def read(rec):
    return rec.gc_ms_per_s()
