"""The share of the window's step-graph runs that ran eagerly
(``Record.eager_step_share``), in the chat cells."""

LAYER = "step graphs (runtime/graphs.py)"
UNIT = "%"
BETTER = "lower"
MOVES = "ttft_p90_ms"


def read(rec):
    return rec.eager_step_share()
