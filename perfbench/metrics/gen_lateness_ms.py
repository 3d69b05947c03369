"""How late the load generator submitted the requests due in the window:
the 95th percentile of submit time less due time (a request that comes
due during a long ``step()`` waits for it to return)."""

from perfbench.harness.endtoend import percentile

LAYER = "load generator (perfbench/harness/loop.py)"
UNIT = "ms"
BETTER = "lower"
MOVES = "ttft_p90_ms"


def read(rec):
    win = rec.win
    late = [win.submitted[i] - d for i, d in win.due.items() if d < win.seconds]
    return 1e3 * percentile(late, 95) if late else None
