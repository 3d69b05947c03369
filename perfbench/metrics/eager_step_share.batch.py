"""The share of the window's step-graph runs that ran eagerly
(``Record.eager_step_share``), in the closed-loop batch cells."""

LAYER = "step graphs (runtime/graphs.py)"
UNIT = "%"
BETTER = "lower"
MOVES = "tokens_per_s"


def read(rec):
    return rec.eager_step_share()
