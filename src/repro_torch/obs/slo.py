"""Per-request SLO policy: TTFT / inter-token-latency targets.

The paper's streaming wins only matter if they land where users feel
them: time-to-first-token (queue wait + admission) and the worst
inter-token gap (a mid-decode eviction stall shows up exactly there).
``SLOPolicy`` holds the two targets; the engine scores every finished
request against it at reap time (``StreamedBatchEngine(slo=...)``) into
``slo.*`` counters, and ``metrics_snapshot()["derived"]["slo"]`` reports
the attainment rate and *goodput* — tokens/s counting only tokens from
SLO-met requests, the admission-control currency the ROADMAP's frontend
item needs.

``score_timelines`` applies the same policy offline to reconstructed
``RequestTimeline``s (``obs.requests``), so a trace can be scored after
the fact without re-running the workload.

The port's copy of the reference ``obs/slo.py``; stdlib only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable

__all__ = ["SLOPolicy", "score_timelines"]


@dataclass(frozen=True)
class SLOPolicy:
    """Latency targets a request must meet to count toward goodput.

    ``ttft_s`` bounds submit -> first token (queue wait included);
    ``itl_s`` bounds the request's *worst* per-token inter-token latency
    (so one eviction stall can fail a request whose median was fine).
    ``inf`` disables a target.
    """

    ttft_s: float = math.inf
    itl_s: float = math.inf

    def __post_init__(self) -> None:
        if self.ttft_s <= 0 or self.itl_s <= 0:
            raise ValueError(
                f"SLO targets must be positive (got ttft_s={self.ttft_s}, "
                f"itl_s={self.itl_s}); use inf to disable one")

    @classmethod
    def from_ms(cls, ttft_ms: float | None = None,
                itl_ms: float | None = None) -> "SLOPolicy":
        """CLI-friendly constructor (``None`` = target disabled)."""
        return cls(
            ttft_s=ttft_ms * 1e-3 if ttft_ms is not None else math.inf,
            itl_s=itl_ms * 1e-3 if itl_ms is not None else math.inf)

    def ttft_ok(self, ttft_s: float) -> bool:
        return ttft_s <= self.ttft_s

    def itl_ok(self, itl_s: float) -> bool:
        return itl_s <= self.itl_s

    def met(self, *, ttft_s: float, itl_s: float) -> bool:
        return self.ttft_ok(ttft_s) and self.itl_ok(itl_s)

    def as_dict(self) -> dict[str, Any]:
        """JSON-safe policy echo for the snapshot (inf -> None)."""
        return {
            "ttft_s": self.ttft_s if math.isfinite(self.ttft_s) else None,
            "itl_s": self.itl_s if math.isfinite(self.itl_s) else None,
        }


def score_timelines(timelines: Iterable[Any],
                    policy: SLOPolicy,
                    *, wall_s: float | None = None) -> dict[str, Any]:
    """Score reconstructed ``RequestTimeline``s against ``policy``.

    Mirrors the engine's reap-time accounting: a timeline is met when its
    submit-relative TTFT and worst per-token ITL are inside the targets.
    Unfinished or partial timelines are skipped (their worst-case gap is
    unknowable).  ``wall_s`` turns met tokens into goodput tokens/s.
    """
    requests = met = goodput_tokens = 0
    ttft_violations = itl_violations = 0
    for tl in timelines:
        if not tl.finished or tl.partial:
            continue
        requests += 1
        worst_itl = max(tl.itl_s) if tl.itl_s else 0.0
        ok = policy.met(ttft_s=tl.ttft_s, itl_s=worst_itl)
        if ok:
            met += 1
            goodput_tokens += tl.tokens
        else:
            if not policy.ttft_ok(tl.ttft_s):
                ttft_violations += 1
            if not policy.itl_ok(worst_itl):
                itl_violations += 1
    return {
        "policy": policy.as_dict(),
        "requests": requests,
        "met": met,
        "attainment": met / requests if requests else 0.0,
        "goodput_tokens": goodput_tokens,
        "goodput_tokens_per_s": (goodput_tokens / wall_s
                                 if wall_s else 0.0),
        "ttft_violations": ttft_violations,
        "itl_violations": itl_violations,
    }
