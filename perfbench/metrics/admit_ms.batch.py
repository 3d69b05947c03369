"""The engine's mean admission over the window (``Record.admit_ms``), in
the closed-loop batch cells."""

LAYER = "engine (runtime/serving.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "tokens_per_s"


def read(rec):
    return rec.admit_ms()
