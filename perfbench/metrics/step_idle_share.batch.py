"""The share of the traced span's ``step()`` time with no kernel running
(``Record.step_idle_share``), in the closed-loop batch cells."""

LAYER = "device (H100)"
UNIT = "%"
BETTER = "lower"
MOVES = "tokens_per_s"


def read(rec):
    return rec.step_idle_share()
