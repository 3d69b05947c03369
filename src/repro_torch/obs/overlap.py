"""Reconstruct measured overlap efficiency from a trace and compare it
with the R-gate's analytic prediction.

The paper's claim is that multi-stream execution hides transfer-like
stages behind compute; the R gate (``core.rmetric``) predicts how much.
This module closes the loop: given the span timeline the engine actually
produced, measure how much of the prefill/transfer in-flight time was
covered by concurrent decode work, and report it next to the model's
prediction so the two can be compared per workload category.

Semantics of "measured":

* The engine records each prefill chunk's span as its *in-flight window*
  — from host dispatch to the end of the decode ticks interleaved behind
  it (CUDA launches are asynchronous; the chunk computes inside that
  window).
  ``transfer``-track spans (scatter, staging) are in-flight the same way.
* A nanosecond of that window is *hidden* when a span on the ``decode``
  track covers it: the engine was producing tokens while the chunk /
  transfer was in flight.  Efficiency = hidden / total, in [0, 1].

Semantics of "predicted" (from ``StageTimes`` via the paper's model):
of the transfer time ``h2d + d2h`` in a single-stream step, pipelining
with ``n`` streams hides ``(sum - max) * (1 - 1/n)`` seconds (the
difference between the serial and the Gomez-Luna pipelined time), so

    predicted = (sum - max) * (1 - 1/n) / (h2d + d2h)

clamped to [0, 1], and 0 when the gate says NOT_WORTHWHILE (the engine
then runs single-stream and hides nothing by design).

The port's copy of the reference ``obs/overlap.py``, over the port's
``core/rmetric.py``; stdlib only.
"""

from __future__ import annotations

import statistics
from typing import Any, Iterable, Sequence

from repro_torch.core.rmetric import (
    StageTimes,
    StreamDecision,
    multi_stream_time,
    optimal_streams,
    single_stream_time,
    streaming_decision,
)
from .trace import Span

__all__ = [
    "interval_union",
    "covered_time",
    "measured_overlap",
    "predicted_overlap",
    "overlap_report",
    "stage_times_from_trace",
]

#: Tracks whose spans represent hideable (transfer-like) in-flight time.
HIDE_TRACKS = ("prefill", "transfer")
#: Tracks whose spans represent useful concurrent work that hides them.
UNDER_TRACKS = ("decode",)


def interval_union(intervals: Iterable[tuple[int, int]]) -> list[tuple[int, int]]:
    """Merge possibly-overlapping [t0, t1) intervals into a disjoint union."""
    out: list[tuple[int, int]] = []
    for t0, t1 in sorted(i for i in intervals if i[1] > i[0]):
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def covered_time(target: Sequence[tuple[int, int]],
                 cover: Sequence[tuple[int, int]]) -> int:
    """Nanoseconds of the ``target`` union covered by the ``cover`` union."""
    total = 0
    j = 0
    for t0, t1 in target:
        while j < len(cover) and cover[j][1] <= t0:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < t1:
            total += min(t1, cover[k][1]) - max(t0, cover[k][0])
            k += 1
    return total


def measured_overlap(spans: Iterable[Span],
                     hide_tracks: Sequence[str] = HIDE_TRACKS,
                     under_tracks: Sequence[str] = UNDER_TRACKS,
                     *, dropped: int = 0) -> dict[str, Any]:
    """Fraction of transfer-like in-flight time hidden under decode work.

    ``dropped`` is the tracer's ring-wrap count: a wrapped ring lost the
    timeline's head, so the efficiency is computed from a truncated
    window and flagged ``partial`` rather than silently reported."""
    hide = interval_union((s.t0_ns, s.t1_ns) for s in spans
                          if s.track in hide_tracks and s.dur_ns > 0)
    under = interval_union((s.t0_ns, s.t1_ns) for s in spans
                           if s.track in under_tracks and s.dur_ns > 0)
    total = sum(t1 - t0 for t0, t1 in hide)
    hidden = covered_time(hide, under)
    return {
        "hidden_s": hidden * 1e-9,
        "total_s": total * 1e-9,
        "efficiency": (hidden / total) if total > 0 else 0.0,
        "partial": dropped > 0,
        "dropped_spans": dropped,
    }


def predicted_overlap(times: StageTimes, *, max_streams: int = 16) -> dict[str, Any]:
    """The R-gate's analytic overlap-efficiency prediction for ``times``."""
    decision = streaming_decision(times)
    n = optimal_streams(times, max_streams=max_streams)
    transfer = times.h2d + times.d2h
    if (decision is not StreamDecision.STREAM or n <= 1 or transfer <= 0.0):
        eff = 0.0
    else:
        hidden = single_stream_time(times) - multi_stream_time(times, n)
        eff = min(1.0, max(0.0, hidden / transfer))
    return {
        "efficiency": eff,
        "decision": decision.value,
        "n_streams": n,
        "r": times.transfer_ratio(),
    }


def overlap_report(spans: Iterable[Span],
                   stage_times: StageTimes | None = None,
                   *, category: str | None = None,
                   dropped: int = 0) -> dict[str, Any]:
    """Measured overlap, optionally against the analytic prediction."""
    spans = list(spans)
    report: dict[str, Any] = {
        "measured": measured_overlap(spans, dropped=dropped)}
    if category is not None:
        report["category"] = category
    if stage_times is not None:
        report["predicted"] = predicted_overlap(stage_times)
        report["gap"] = (report["measured"]["efficiency"]
                        - report["predicted"]["efficiency"])
    return report


def stage_times_from_trace(spans: Iterable[Span],
                           *, min_samples: int = 2) -> StageTimes | None:
    """Estimate the paper's stage triple from recorded spans.

    ``kex`` (the compute stage) is the median decode-tick duration — the
    tick span is bounded by a blocking ``host_fetch``, so it is a true
    device-step latency.  ``h2d`` (the transfer-like stage the engine
    tries to hide) is the median per-chunk prefill cost, recovered from
    each admission span as (admit duration - decode-tick time contained
    in it) / chunks, since chunk spans themselves are async in-flight
    windows rather than compute time.  ``d2h`` is the per-tick fetch,
    already inside the tick span, so it stays 0 here.

    Returns None when there are not enough samples of either kind —
    callers fall back to direct probing (``tuning.profiler``).
    """
    spans = list(spans)
    ticks = [s for s in spans if s.track == "decode"
             and s.name in ("decode_tick", "spec_tick") and s.dur_ns > 0]
    admits = [s for s in spans if s.track == "prefill" and s.name == "admit"]
    if len(ticks) < min_samples or not admits:
        return None
    tick_iv = interval_union((s.t0_ns, s.t1_ns) for s in ticks)
    chunk_costs = []
    for a in admits:
        chunks = int(a.args.get("chunks", 0) or 0)
        if chunks <= 0:
            continue
        inside = covered_time([(a.t0_ns, a.t1_ns)], tick_iv)
        cost = (a.dur_ns - inside) / chunks
        if cost > 0:
            chunk_costs.append(cost)
    if not chunk_costs:
        return None
    return StageTimes(
        h2d=statistics.median(chunk_costs) * 1e-9,
        kex=statistics.median(s.dur_ns for s in ticks) * 1e-9,
        d2h=0.0,
    )
