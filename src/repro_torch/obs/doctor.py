"""Trace-driven bottleneck diagnosis: ``python -m repro_torch.obs.doctor``.

Given a Chrome trace (``serve.py --trace``) and optionally a metrics
snapshot (``serve.py --metrics-out``), rank the symptoms the telemetry
layer can see and map each to the paper's dependency-category story and
to the concrete knob that moves it:

========  ==========================================  =================
rule      symptom                                     first knob
========  ==========================================  =================
DOC001    measured overlap far below the R-gate        ``prefill_chunk``
          prediction (chunk chain not hiding           / ``decode_interleave``
          transfer — TRUE_DEPENDENT pipeline broken)
DOC002    TTFT dominated by queue wait (admission      ``max_batch`` /
          starved, pool pressure — INDEPENDENT tasks   ``num_blocks``
          serialized behind the pool)
DOC003    speculative acceptance collapsed             ``spec_k`` /
          (ITERATIVE chunked decode paying k+1x        drafter
          verify compute for nothing)
DOC004    pool thrash: evict/readmit churn             ``num_blocks`` /
          (page pressure turning decode into           ``max_batch``
          re-staging — the SYNC transfer repaid
          per request)
DOC005    live STR002: a step fetched more bytes       transfer budget /
          than its declared ``@transfer_budget``       step fetch layout
DOC006    ring wrap: the trace dropped spans, every    ``Tracer(capacity=...)``
          number above is from a truncated window
========  ==========================================  =================

Severity is ``high`` (the stack is misbehaving — CI fails on these) /
``medium`` (leaving predicted performance on the table) / ``info``.
Output is a ranked human report or ``--json``; ``--fail-on high`` turns
the diagnosis into a gate.  Known-bad fixture traces in
``tests/test_obs_doctor.py`` each trip exactly one rule, in this copy as
in the reference ``obs/doctor.py`` (``tests/test_torch_obs.py``).

stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass, field
from typing import Any, Iterable

from .overlap import measured_overlap, predicted_overlap, stage_times_from_trace
from .requests import reconstruct_timelines, timeline_aggregates, _median
from .trace import Span, read_trace

__all__ = ["Finding", "diagnose", "render", "report_json", "main"]

#: Severity rank for sorting (and for --fail-on comparisons).
SEVERITIES = ("high", "medium", "info")

# Thresholds, named so the fixture tests and the docs agree with the
# code.  The overlap gap runs ~0.2-0.55 on a healthy CPU-interpret stack
# (the analytic model assumes transfer-bound stages the CPU backend
# doesn't have), so the gap only escalates past "info" well above that.
OVERLAP_GAP_INFO = 0.30
OVERLAP_GAP_MEDIUM = 0.70
OVERLAP_PRED_MIN = 0.30  # below this the gate said "don't bother" anyway
QUEUE_FRACTION_MEDIUM = 0.75  # median queue_wait/ttft
QUEUE_MIN_REQUESTS = 4  # fewer finished timelines -> info (median is noise)
SPEC_PROPOSED_MIN = 64  # acceptance is meaningless on fewer drafts
SPEC_ACCEPT_COLLAPSE = 0.35
THRASH_PER_REQUEST = 1.0  # evictions per admission
THRASH_MIN_EVICTIONS = 4


@dataclass
class Finding:
    """One diagnosed symptom, ranked by (severity, score)."""

    rule: str
    severity: str  # "high" | "medium" | "info"
    title: str
    detail: str
    category: str  # the paper dependency-category story it maps to
    knobs: list[str] = field(default_factory=list)
    score: float = 0.0  # magnitude within the severity band (sort key)
    evidence: dict[str, Any] = field(default_factory=dict)

    def as_dict(self) -> dict[str, Any]:
        return {
            "rule": self.rule, "severity": self.severity,
            "title": self.title, "detail": self.detail,
            "category": self.category, "knobs": list(self.knobs),
            "score": self.score, "evidence": dict(self.evidence),
        }


def _counters(snapshot: dict[str, Any] | None) -> dict[str, Any]:
    return (snapshot or {}).get("counters", {})


def diagnose(spans: Iterable[Span], *, dropped: int = 0,
             snapshot: dict[str, Any] | None = None,
             max_streams: int = 16) -> list[Finding]:
    """Run every rule over ``spans`` (+ optional metrics snapshot);
    returns findings ranked most-severe first."""
    spans = list(spans)
    c = _counters(snapshot)
    findings: list[Finding] = []
    tls = reconstruct_timelines(spans, dropped=dropped, warn=False)
    agg = timeline_aggregates(tls)

    # DOC001 — measured overlap below the R-gate prediction.
    st = stage_times_from_trace(spans)
    if st is not None:
        pred = predicted_overlap(st, max_streams=max_streams)
        meas = measured_overlap(spans, dropped=dropped)
        gap = pred["efficiency"] - meas["efficiency"]
        if pred["efficiency"] >= OVERLAP_PRED_MIN and gap > OVERLAP_GAP_INFO:
            sev = "medium" if gap > OVERLAP_GAP_MEDIUM else "info"
            findings.append(Finding(
                rule="DOC001", severity=sev,
                title="measured overlap below the R-gate prediction",
                detail=(
                    f"the trace hides {meas['efficiency']:.2f} of the "
                    f"prefill/transfer in-flight time under decode, but the "
                    f"R gate predicts {pred['efficiency']:.2f} from the "
                    f"traced stage times (gap {gap:.2f}) — the chunk chain "
                    "is not overlapping the way the plan assumed; try a "
                    "smaller prefill_chunk (finer pipeline grain) or more "
                    "decode_interleave ticks per chunk"),
                category="TRUE_DEPENDENT (chunked pipeline, paper §4.3)",
                knobs=["prefill_chunk", "decode_interleave"],
                score=gap,
                evidence={"measured": meas["efficiency"],
                          "predicted": pred["efficiency"], "gap": gap,
                          "decision": pred["decision"],
                          "n_streams": pred["n_streams"]}))

    # DOC002 — TTFT dominated by queue wait.
    fracs = [t.queue_wait_s / t.ttft_s
             for t in tls if t.ttft_s > 0 and not t.partial]
    med_frac = _median(fracs)
    if len(fracs) >= 2 and med_frac > QUEUE_FRACTION_MEDIUM:
        sev = "medium" if len(fracs) >= QUEUE_MIN_REQUESTS else "info"
        findings.append(Finding(
            rule="DOC002", severity=sev,
            title="TTFT dominated by admission queue wait",
            detail=(
                f"the median request spends {med_frac:.0%} of its TTFT "
                "waiting in the admission queue, not prefilling — the slot "
                "pool (or the page pool backing it) is the bottleneck; "
                "grow max_batch / num_blocks, or admit by predicted "
                "latency instead of FIFO"),
            category="INDEPENDENT (task parallelism starved, paper §4.1)",
            knobs=["max_batch", "num_blocks", "admission policy"],
            score=med_frac,
            evidence={"median_queue_fraction": med_frac,
                      "queue_wait_p50_s": agg["queue_wait_p50_s"],
                      "requests": len(fracs)}))

    # DOC003 — speculative acceptance collapse.  Prefer snapshot
    # counters; fall back to the spec_draft spans' proposed counts and
    # the tick attribution's accepted tokens.
    proposed = c.get("serving.spec_proposed", 0)
    accepted = c.get("serving.spec_accepted", 0)
    if not proposed:
        proposed = sum(int(s.args.get("proposed", 0)) for s in spans
                       if s.name == "spec_draft")
        accepted = sum(int(s.args.get("accepted", 0)) for s in spans
                       if s.name == "spec_rollback")
    if proposed >= SPEC_PROPOSED_MIN:
        rate = accepted / proposed
        if rate < SPEC_ACCEPT_COLLAPSE:
            findings.append(Finding(
                rule="DOC003", severity="medium",
                title="speculative acceptance collapsed",
                detail=(
                    f"only {rate:.0%} of {proposed} drafted tokens were "
                    "accepted — every verify tick pays (k+1)x a plain "
                    "tick's compute for almost no extra tokens; shrink "
                    "spec_k, switch the drafter, or turn spec_decode off "
                    "for this workload"),
                category="ITERATIVE (chunked decode stream, paper §4.2)",
                knobs=["spec_k", "spec_decode", "drafter"],
                score=SPEC_ACCEPT_COLLAPSE - rate,
                evidence={"proposed": proposed, "accepted": accepted,
                          "acceptance": rate}))

    # DOC004 — pool thrash (evict/readmit churn).
    evictions = max(agg["evictions"], c.get("serving.preemptions", 0))
    admissions = max(agg["requests"], c.get("serving.admissions", 0))
    if (admissions > 0 and evictions >= THRASH_MIN_EVICTIONS
            and evictions / admissions >= THRASH_PER_REQUEST):
        per_req = evictions / admissions
        findings.append(Finding(
            rule="DOC004", severity="high",
            title="page-pool thrash: evict/readmit churn",
            detail=(
                f"{evictions} evictions across {admissions} requests "
                f"({per_req:.1f} per request) — the pool is so tight that "
                "decode progress is being traded for page re-staging (the "
                "SYNC transfer repaid over and over); grow num_blocks or "
                "admit fewer concurrent requests (max_batch)"),
            category="SYNC transfer repaid per request (paper §4.1)",
            knobs=["num_blocks", "max_batch", "preemption policy"],
            score=per_req,
            evidence={"evictions": evictions, "admissions": admissions,
                      "per_request": per_req,
                      "stall_s_total": sum(t.stall_s for t in tls)}))

    # DOC005 — live STR002 (runtime transfer accounting tripped).
    live = c.get("analysis.str002_live", 0)
    markers = sum(1 for s in spans if s.name == "STR002")
    if live or markers:
        n = max(int(live), markers)
        findings.append(Finding(
            rule="DOC005", severity="high",
            title="live STR002: tick fetched over its transfer budget",
            detail=(
                f"{n} decode/verify ticks fetched more device bytes than "
                "the step's declared @transfer_budget — a hidden sync or "
                "an oversized fetch crept onto the tick path; re-run "
                "make lint-streams and check the step's fetch layout "
                "against its budget declaration"),
            category="transfer budget (analyzer STR002, runtime twin)",
            knobs=["@transfer_budget", "step fetch layout"],
            score=float(n),
            evidence={"counter": int(live), "trace_markers": markers}))

    # DOC006 — ring wrap: everything above is from a truncated window.
    if dropped > 0:
        findings.append(Finding(
            rule="DOC006", severity="info",
            title="trace ring wrapped: spans dropped",
            detail=(
                f"the tracer dropped {dropped} spans to ring wrap-around; "
                f"{agg['partial']} of {agg['requests']} timelines are "
                "partial and every aggregate above is computed from a "
                "truncated window — grow Tracer(capacity=...) to cover "
                "the full run"),
            category="telemetry integrity",
            knobs=["Tracer(capacity=...)"],
            score=float(dropped),
            evidence={"dropped_spans": dropped,
                      "partial_timelines": agg["partial"]}))

    findings.sort(key=lambda f: (SEVERITIES.index(f.severity), -f.score))
    return findings


def render(findings: list[Finding], *, spans: int = 0,
           requests: int = 0, dropped: int = 0) -> str:
    """Human-readable ranked report."""
    lines = [f"obs.doctor: {spans} spans, {requests} requests, "
             f"{dropped} dropped"]
    if not findings:
        lines.append("no findings — the trace looks healthy")
        return "\n".join(lines)
    for i, f in enumerate(findings, 1):
        lines.append(f"{i}. [{f.severity.upper()}] {f.rule}: {f.title}")
        lines.append(f"   {f.detail}")
        lines.append(f"   category: {f.category}")
        lines.append(f"   knobs: {', '.join(f.knobs)}")
    return "\n".join(lines)


def report_json(findings: list[Finding], *, spans: int = 0,
                requests: int = 0, dropped: int = 0) -> dict[str, Any]:
    worst = findings[0].severity if findings else None
    return {
        "schema": 1,
        "summary": {
            "spans": spans,
            "requests": requests,
            "dropped_spans": dropped,
            "findings": len(findings),
            "worst_severity": worst,
            "by_severity": {sev: sum(1 for f in findings
                                     if f.severity == sev)
                            for sev in SEVERITIES},
        },
        "findings": [f.as_dict() for f in findings],
    }


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.doctor",
        description="Diagnose a serving trace: rank bottleneck symptoms "
                    "and map them to paper categories and knobs.")
    p.add_argument("trace", help="Chrome trace.json from serve.py --trace")
    p.add_argument("--metrics", default=None,
                   help="metrics snapshot JSON (serve.py --metrics-out)")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="emit the machine-readable report")
    p.add_argument("--fail-on", default="never",
                   choices=["high", "medium", "info", "never"],
                   help="exit 1 when any finding is at/above this severity")
    args = p.parse_args(argv)

    spans = read_trace(args.trace)
    with open(args.trace) as f:
        doc = json.load(f)
    dropped = int(doc.get("otherData", {}).get("dropped_spans", 0))
    snapshot = None
    if args.metrics:
        with open(args.metrics) as f:
            snapshot = json.load(f)
    findings = diagnose(spans, dropped=dropped, snapshot=snapshot)
    n_requests = timeline_aggregates(
        reconstruct_timelines(spans, dropped=dropped,
                              warn=False))["requests"]
    meta = dict(spans=len(spans), requests=n_requests, dropped=dropped)
    if args.as_json:
        print(json.dumps(report_json(findings, **meta), indent=1))
    else:
        print(render(findings, **meta))
    if args.fail_on != "never":
        bar = SEVERITIES.index(args.fail_on)
        if any(SEVERITIES.index(f.severity) <= bar for f in findings):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
