"""The model step's share of the chip's bf16 peak (``Record.mfu``), in
the chat cells."""

LAYER = "model step (models/)"
UNIT = "%"
BETTER = "higher"
MOVES = "itl_mean_ms"


def read(rec):
    return rec.mfu()
