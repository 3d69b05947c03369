"""The engine's mean admission over the window (``Record.admit_ms``), in
the chat cells."""

LAYER = "engine (runtime/serving.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "ttft_p90_ms"


def read(rec):
    return rec.admit_ms()
