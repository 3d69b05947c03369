"""The model step's share of the chip's bf16 peak (``Record.mfu``), in
the closed-loop batch cells."""

LAYER = "model step (models/)"
UNIT = "%"
BETTER = "higher"
MOVES = "tokens_per_s"


def read(rec):
    return rec.mfu()
