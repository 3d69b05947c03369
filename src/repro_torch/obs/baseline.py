"""Perf-regression sentinel: fresh bench results vs baseline files (the
reference ``obs/baseline.py``, copied).

The comparator of two ``BENCH_serving.json`` / ``BENCH_obs.json`` shaped
documents: noise-tolerant *ratio* gates (wall-clock numbers move with the
host, so the bounds are wide: the sentinel catches collapses, not
percent-level drift) plus hard zero-gates on the correctness-adjacent
counters (dropped spans, live STR002).

Gate semantics:

* throughput (``*_tokens_per_s``): fresh must keep at least
  ``min_ratio`` of the baseline (default 0.4: a 2.5x collapse fails).
* latency (``*_admit_ms*``, traced TTFT/ITL p99): fresh must stay under
  ``max_ratio`` x baseline (default 4.0).
* overlap efficiency: fresh measured overlap per mode must stay within
  ``overlap_slack`` (absolute, default 0.35) of the baseline.
* hard zeros: a fresh run may never report ``dropped_spans`` or
  ``str002_live`` > 0 (those are bugs, not noise).
* schema drift: a metric/mode present in the baseline but missing from
  the fresh run is a violation (silent gate erosion).

    PYTHONPATH=src python -m repro_torch.obs.baseline \\
        --serving FRESH_serving.json --baseline-serving BASE_serving.json \\
        --obs FRESH_obs.json --baseline-obs BASE_obs.json

Unlike the reference there is no ``--run`` (it re-runs the reference's
``benchmarks/bench_serving``), and each baseline path is required with its
fresh file: the repository's ``BENCH_*.json`` measure the JAX package, not
this one.  Exit 1 on any violation.  Stdlib only.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import dataclass
from typing import Any

__all__ = [
    "Violation",
    "compare_serving",
    "compare_obs",
    "render",
    "main",
]

DEFAULT_MIN_RATIO = 0.4
DEFAULT_MAX_RATIO = 4.0
DEFAULT_OVERLAP_SLACK = 0.35

#: BENCH_serving.json metrics gated higher-is-better (tokens/s family).
#: tuning_* is excluded on purpose: the search's trial count dominates
#: its wall numbers, which makes the ratio a coin flip.
SERVING_HIGHER = (
    "serving_tokens_per_s",
    "serving_seq_tokens_per_s",
    "serving_paged_tokens_per_s",
    "serving_prefix_tokens_per_s",
    "serving_quant_tokens_per_s",
    "serving_spec_tokens_per_s",
)
#: Gated lower-is-better (latency family, ms).
SERVING_LOWER = (
    "serving_admit_ms",
    "serving_admit_ms_p50",
    "serving_admit_ms_p99",
    "serving_prefix_admit_ms",
)


@dataclass(frozen=True)
class Violation:
    """One failed gate: ``where`` names the metric/mode, ``detail`` says
    what moved and past which bound."""

    where: str
    kind: str  # "throughput" | "latency" | "overlap" | "zero" | "missing"
    fresh: Any
    base: Any
    detail: str


def _metric_value(doc: dict[str, Any], name: str) -> float | None:
    rec = doc.get("metrics", {}).get(name)
    if rec is None:
        return None
    v = rec.get("value")
    return float(v) if isinstance(v, (int, float)) else None


def compare_serving(fresh: dict[str, Any], base: dict[str, Any], *,
                    min_ratio: float = DEFAULT_MIN_RATIO,
                    max_ratio: float = DEFAULT_MAX_RATIO) -> list[Violation]:
    """Gate a fresh ``BENCH_serving.json`` doc against the committed one."""
    out: list[Violation] = []
    for name in SERVING_HIGHER:
        bv = _metric_value(base, name)
        if bv is None or bv <= 0:
            continue  # baseline never measured it: nothing to hold
        fv = _metric_value(fresh, name)
        if fv is None:
            out.append(Violation(name, "missing", None, bv,
                                 f"{name} present in baseline but missing "
                                 "from the fresh run"))
            continue
        if fv < bv * min_ratio:
            out.append(Violation(
                name, "throughput", fv, bv,
                f"{name}: {fv:.1f} fresh vs {bv:.1f} baseline — below "
                f"{min_ratio:.0%} of baseline"))
    for name in SERVING_LOWER:
        bv = _metric_value(base, name)
        if bv is None or bv <= 0:
            continue
        fv = _metric_value(fresh, name)
        if fv is None:
            out.append(Violation(name, "missing", None, bv,
                                 f"{name} present in baseline but missing "
                                 "from the fresh run"))
            continue
        if fv > bv * max_ratio:
            out.append(Violation(
                name, "latency", fv, bv,
                f"{name}: {fv:.2f} fresh vs {bv:.2f} baseline — over "
                f"{max_ratio:.0f}x the baseline"))
    return out


def compare_obs(fresh: dict[str, Any], base: dict[str, Any], *,
                min_ratio: float = DEFAULT_MIN_RATIO,
                max_ratio: float = DEFAULT_MAX_RATIO,
                overlap_slack: float = DEFAULT_OVERLAP_SLACK) -> list[Violation]:
    """Gate a fresh ``BENCH_obs.json`` doc against the committed one,
    mode by mode."""
    out: list[Violation] = []
    fresh_modes = {m["mode"]: m for m in fresh.get("modes", [])}
    for bm in base.get("modes", []):
        mode = bm["mode"]
        fm = fresh_modes.get(mode)
        if fm is None:
            out.append(Violation(mode, "missing", None, None,
                                 f"mode {mode} present in baseline but "
                                 "missing from the fresh run"))
            continue
        b_tps = bm.get("tokens_per_s", {}).get("untraced", 0.0)
        f_tps = fm.get("tokens_per_s", {}).get("untraced", 0.0)
        if b_tps > 0 and f_tps < b_tps * min_ratio:
            out.append(Violation(
                f"{mode}.tokens_per_s", "throughput", f_tps, b_tps,
                f"{mode}: {f_tps:.1f} tokens/s fresh vs {b_tps:.1f} "
                f"baseline — below {min_ratio:.0%}"))
        for lat in ("ttft_ms", "itl_ms"):
            bl = bm.get(lat, {}).get("p99", 0.0)
            fl = fm.get(lat, {}).get("p99", 0.0)
            if bl > 0 and fl > bl * max_ratio:
                out.append(Violation(
                    f"{mode}.{lat}.p99", "latency", fl, bl,
                    f"{mode}: {lat} p99 {fl:.2f}ms fresh vs {bl:.2f}ms "
                    f"baseline — over {max_ratio:.0f}x"))
        b_ov = bm.get("overlap", {}).get("measured", 0.0)
        f_ov = fm.get("overlap", {}).get("measured", 0.0)
        if f_ov < b_ov - overlap_slack:
            out.append(Violation(
                f"{mode}.overlap.measured", "overlap", f_ov, b_ov,
                f"{mode}: measured overlap {f_ov:.3f} fresh vs {b_ov:.3f} "
                f"baseline — fell more than {overlap_slack}"))
        for hard in ("dropped_spans", "str002_live"):
            fv = fm.get(hard, 0)
            if fv:
                out.append(Violation(
                    f"{mode}.{hard}", "zero", fv, 0,
                    f"{mode}: {hard} = {fv} in the fresh run (must be 0)"))
    return out


def render(violations: list[Violation]) -> str:
    if not violations:
        return "bench-check OK: fresh results within baseline bounds"
    lines = [f"bench-check FAILED: {len(violations)} gate(s) tripped"]
    for v in violations:
        lines.append(f"  [{v.kind}] {v.detail}")
    return "\n".join(lines)


def _load(path: str) -> dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.baseline",
        description="Compare fresh bench results against baseline "
                    "BENCH_serving.json / BENCH_obs.json shaped files.")
    p.add_argument("--serving", default=None,
                   help="fresh BENCH_serving.json to check")
    p.add_argument("--obs", default=None,
                   help="fresh BENCH_obs.json to check")
    p.add_argument("--baseline-serving", default=None,
                   help="baseline for --serving (required with it)")
    p.add_argument("--baseline-obs", default=None,
                   help="baseline for --obs (required with it)")
    p.add_argument("--min-ratio", type=float, default=DEFAULT_MIN_RATIO)
    p.add_argument("--max-ratio", type=float, default=DEFAULT_MAX_RATIO)
    p.add_argument("--overlap-slack", type=float,
                   default=DEFAULT_OVERLAP_SLACK)
    args = p.parse_args(argv)

    if not args.serving and not args.obs:
        p.error("give at least one of --serving/--obs")
    for fresh, base in (("serving", "baseline_serving"), ("obs", "baseline_obs")):
        if getattr(args, fresh) and not getattr(args, base):
            p.error(f"--{fresh} needs --{base.replace('_', '-')}")

    violations: list[Violation] = []
    if args.serving:
        violations += compare_serving(
            _load(args.serving), _load(args.baseline_serving),
            min_ratio=args.min_ratio, max_ratio=args.max_ratio)
    if args.obs:
        violations += compare_obs(
            _load(args.obs), _load(args.baseline_obs),
            min_ratio=args.min_ratio, max_ratio=args.max_ratio,
            overlap_slack=args.overlap_slack)
    print(render(violations))
    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
