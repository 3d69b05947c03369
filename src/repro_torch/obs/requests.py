"""Per-request lifecycle timelines reconstructed from a trace.

The engine's spans carry request identity (``uid=`` on admission, eviction and
staging spans; ``uids=``/``toks=`` attribution lists on every decode
tick), so a full request lifecycle can be rebuilt from the trace alone:
queue wait, TTFT, every per-token inter-token latency, stall intervals
while evicted, and the pages/bytes the request dragged across the
transfer track.  That is what this module does — the data layer under
``obs.doctor`` and the offline twin of the engine's reap-time SLO
accounting (``obs.slo.score_timelines``).

Reconstruction is defensive about the ring buffer: when the tracer
``dropped`` spans (ring wrap), or a request's decode ticks appear
without its admission span, the affected timelines are flagged
``partial`` and a warning is emitted — a partial timeline's aggregates
are biased and must not be scored silently.

The port's copy of the reference ``obs/requests.py``; stdlib only.
"""

from __future__ import annotations

import json
import warnings
from dataclasses import dataclass, field
from typing import Any, Iterable

from .trace import Span, read_trace

__all__ = [
    "RequestTimeline",
    "reconstruct_timelines",
    "timelines_from_trace",
    "timeline_aggregates",
]

#: Decode-track span names that carry per-slot attribution lists.
_TICK_NAMES = ("decode_tick", "spec_tick")


@dataclass
class RequestTimeline:
    """One request's reconstructed lifecycle (times in seconds).

    ``ttft_s`` is submit-relative (queue wait + admission), matching the
    engine's SLO accounting; ``itl_s`` holds one entry per decoded token
    (a spec tick's burst of ``n`` tokens contributes ``n`` equal gaps).
    ``stalls`` are [evicted, readmitted) intervals in trace nanoseconds;
    an eviction the trace never saw resolved is closed at the trace end
    and flagged ``open_stall``.
    """

    uid: int
    queue_wait_s: float = 0.0
    admit_s: float = 0.0  # queue pop -> first token (the ttft_s histogram)
    ttft_s: float = 0.0  # submit -> first token (queue_wait + admit)
    prompt_len: int = 0
    shared_len: int = 0  # prompt tokens covered by a mapped shared prefix
    max_new: int | None = None
    tokens: int = 0  # tokens seen in the trace (first token included)
    itl_s: list[float] = field(default_factory=list)
    stalls: list[tuple[int, int]] = field(default_factory=list)
    open_stall: bool = False
    evictions: int = 0
    pages_moved: int = 0  # scatter + evict-gather + readmit page traffic
    h2d_bytes: int = 0  # prompt staging bytes attributed to this request
    slots: list[int] = field(default_factory=list)  # slots occupied, in order
    partial: bool = False  # ring wrap lost spans; aggregates are biased
    finished: bool = False  # tokens reached max_new inside the trace

    @property
    def stall_s(self) -> float:
        return sum(t1 - t0 for t0, t1 in self.stalls) * 1e-9

    @property
    def itl_mean_s(self) -> float:
        return sum(self.itl_s) / len(self.itl_s) if self.itl_s else 0.0

    @property
    def itl_max_s(self) -> float:
        return max(self.itl_s) if self.itl_s else 0.0


def _get(tl_map: dict[int, RequestTimeline], uid: int,
         *, headless: bool) -> RequestTimeline:
    tl = tl_map.get(uid)
    if tl is None:
        tl = tl_map[uid] = RequestTimeline(uid=uid)
        if headless:
            # First sighting is not the admission span: the ring (or a
            # filtered trace) lost this request's head.
            tl.partial = True
    return tl


def reconstruct_timelines(spans: Iterable[Span], *, dropped: int = 0,
                          warn: bool = True) -> list[RequestTimeline]:
    """Rebuild per-request timelines from engine spans.

    ``dropped`` is the tracer's ring-wrap count (``Tracer.dropped`` /
    the Chrome export's ``otherData.dropped_spans``): when positive,
    every timeline is flagged partial and a ``RuntimeWarning`` is
    emitted (suppress with ``warn=False``).  Spans from engines that
    predate request attribution simply contribute nothing.
    """
    spans = sorted(spans, key=lambda s: (s.t0_ns, s.t1_ns))
    tls: dict[int, RequestTimeline] = {}
    last_emit: dict[int, int] = {}  # uid -> t1_ns of last emitted token
    open_stall: dict[int, int] = {}  # uid -> eviction t1_ns
    end_ns = max((s.t1_ns for s in spans), default=0)
    for s in spans:
        a = s.args
        if s.name == "admit":
            uid = a.get("uid")
            if uid is None:
                continue
            tl = _get(tls, uid, headless=False)
            tl.queue_wait_s = float(a.get("queue_wait_s", 0.0))
            tl.admit_s = s.dur_s
            tl.ttft_s = tl.queue_wait_s + tl.admit_s
            tl.prompt_len = int(a.get("prompt_len", 0))
            tl.shared_len = int(a.get("shared_len", 0))
            if "max_new" in a:
                tl.max_new = int(a["max_new"])
            if "slot" in a:
                tl.slots.append(int(a["slot"]))
            tl.tokens += 1  # admission samples the first token
            last_emit[uid] = s.t1_ns
        elif s.name in _TICK_NAMES:
            uids = a.get("uids") or []
            toks = a.get("toks") or []
            for uid, n in zip(uids, toks):
                n = int(n)
                if n <= 0:
                    continue
                tl = _get(tls, uid, headless=True)
                tl.tokens += n
                prev = last_emit.get(uid)
                if prev is not None and s.t1_ns > prev:
                    # The slot's whole gap, split across the burst — the
                    # same per-token value the engine's itl_s histogram
                    # observes.
                    gap = (s.t1_ns - prev) * 1e-9 / n
                    tl.itl_s.extend([gap] * n)
                last_emit[uid] = s.t1_ns
        elif s.name == "evict":
            uid = a.get("uid")
            if uid is None:
                continue
            tl = _get(tls, uid, headless=uid not in tls)
            tl.evictions += 1
            tl.pages_moved += int(a.get("pages", 0))
            open_stall[uid] = s.t1_ns
        elif s.name == "readmit":
            uid = a.get("uid")
            if uid is None:
                continue
            tl = _get(tls, uid, headless=uid not in tls)
            tl.pages_moved += int(a.get("pages", 0))
            if "slot" in a:
                tl.slots.append(int(a["slot"]))
            t0 = open_stall.pop(uid, None)
            if t0 is not None and s.t1_ns > t0:
                tl.stalls.append((t0, s.t1_ns))
        elif s.name == "h2d_stage":
            uid = a.get("uid")
            if uid is not None and uid in tls:
                tls[uid].h2d_bytes += int(a.get("h2d_bytes", 0))
            elif uid is not None:
                _get(tls, uid, headless=True).h2d_bytes += int(
                    a.get("h2d_bytes", 0))
        elif s.name == "page_scatter":
            uid = a.get("uid")
            if uid is not None:
                _get(tls, uid, headless=uid not in tls).pages_moved += int(
                    a.get("pages", 0))
    # Evictions the trace never saw resolved: close the stall at the
    # trace end so stall_s stays meaningful, and say so.
    for uid, t0 in open_stall.items():
        tl = tls[uid]
        tl.open_stall = True
        if end_ns > t0:
            tl.stalls.append((t0, end_ns))
    for tl in tls.values():
        tl.finished = tl.max_new is not None and tl.tokens >= tl.max_new
        if dropped > 0:
            tl.partial = True
    if dropped > 0 and warn and tls:
        warnings.warn(
            f"trace ring dropped {dropped} spans; the {len(tls)} "
            "reconstructed timelines are partial (grow Tracer capacity "
            "to keep full lifecycles)", RuntimeWarning, stacklevel=2)
    return sorted(tls.values(), key=lambda t: t.uid)


def timelines_from_trace(path: str, *,
                         warn: bool = True) -> list[RequestTimeline]:
    """Timelines straight from a Chrome trace file written by
    ``Tracer.to_chrome`` (the export's ``dropped_spans`` count rides
    along into the partial flags)."""
    with open(path) as f:
        doc = json.load(f)
    dropped = int(doc.get("otherData", {}).get("dropped_spans", 0))
    return reconstruct_timelines(read_trace(path), dropped=dropped,
                                 warn=warn)


def _median(vals: list[float]) -> float:
    if not vals:
        return 0.0
    vals = sorted(vals)
    n = len(vals)
    mid = n // 2
    return vals[mid] if n % 2 else (vals[mid - 1] + vals[mid]) / 2.0


def timeline_aggregates(timelines: Iterable[RequestTimeline]) -> dict[str, Any]:
    """Cross-request aggregates in the engine-histogram's units, for the
    agreement check against ``metrics_snapshot()`` (``latency.ttft_s``
    observes the admit duration; ``latency.itl_s`` observes per-token
    gaps — the same quantities the timelines carry)."""
    tls = list(timelines)
    admits = [t.admit_s for t in tls if t.admit_s > 0]
    itls = [g for t in tls for g in t.itl_s]
    queue = [t.queue_wait_s for t in tls]
    return {
        "requests": len(tls),
        "finished": sum(1 for t in tls if t.finished),
        "partial": sum(1 for t in tls if t.partial),
        "tokens": sum(t.tokens for t in tls),
        "evictions": sum(t.evictions for t in tls),
        "ttft_mean_s": sum(admits) / len(admits) if admits else 0.0,
        "ttft_p50_s": _median(admits),
        "itl_count": len(itls),
        "itl_mean_s": sum(itls) / len(itls) if itls else 0.0,
        "itl_p50_s": _median(itls),
        "queue_wait_mean_s": (sum(queue) / len(queue)) if queue else 0.0,
        "queue_wait_p50_s": _median(queue),
    }
