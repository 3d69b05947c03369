"""The share of the traced span's ``step()`` time with no kernel running
(``Record.step_idle_share``), in the chat cells."""

LAYER = "device (H100)"
UNIT = "%"
BETTER = "lower"
MOVES = "itl_mean_ms"


def read(rec):
    return rec.step_idle_share()
