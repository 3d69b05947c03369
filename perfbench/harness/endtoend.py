"""The end-to-end metrics, from one window's host-clock stamps.

* ``tokens_per_s``: the prompt tokens prefilled plus the tokens served
  inside the window, over the window's length.  An admission that
  straddles an edge counts the share of its prompt that its time inside
  the window is of its whole time.
* ``ttft_p90_ms``: over every request due inside the window, the 90th
  percentile of its first token's stamp (right after the token's
  device-to-host read) minus its due time.  A request refused, or still
  without a token when the drain gave up, counts as waiting until then.
* ``itl_mean_ms``: the mean of every gap between consecutive tokens of a
  request, both stamped inside the window.  (Its 95th percentile is the
  per-layer metric ``itl_p95_ms.chat``: PERF.md section 2 says why.)
* ``setup_s`` is taken by the command itself (process start to window
  start).
"""

from __future__ import annotations

import numpy as np

from perfbench.harness.loop import DRAIN_LIMIT_S, Window


def percentile(values, p: float) -> float:
    """The ``p``-th percentile (0-100), linear between order statistics;
    NaN for no values."""
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, p)) if v.size else float("nan")


def prompt_tokens_in(win: Window) -> float:
    total = 0.0
    for _, n, a, b in win.admits:
        inside = max(0.0, min(b, win.seconds) - max(a, 0.0))
        total += n * (inside / (b - a) if b > a else float(0.0 <= b <= win.seconds))
    return total


def served_in(win: Window) -> int:
    return sum(1 for ts in win.token_times.values() for t in ts if 0.0 <= t <= win.seconds)


def tokens_per_s(win: Window) -> float:
    return (prompt_tokens_in(win) + served_in(win)) / win.seconds


def ttft_by_due(win: Window) -> list[tuple[float, float]]:
    """(due time, seconds from it to the first token) of each request due
    in the window, by due time."""
    out = []
    give_up = win.seconds + DRAIN_LIMIT_S
    for idx, due in win.due.items():
        if due < win.seconds:
            ts = win.token_times.get(win.uid.get(idx, -1))
            out.append((due, (ts[0] if ts else give_up) - due))
    return sorted(out)


def ttfts(win: Window) -> list[float]:
    return [t for _, t in ttft_by_due(win)]


def itls(win: Window) -> list[float]:
    out = []
    for ts in win.token_times.values():
        inside = [t for t in ts if 0.0 <= t <= win.seconds]
        out.extend(np.diff(inside).tolist())
    return out


READERS = {
    "tokens_per_s": tokens_per_s,
    "ttft_p90_ms": lambda w: 1e3 * percentile(ttfts(w), 90),
    "itl_mean_ms": lambda w: 1e3 * float(np.mean(itls(w))),
}
