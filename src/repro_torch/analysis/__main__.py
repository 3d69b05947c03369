"""CLI gate: ``python -m repro_torch.analysis`` (or ``make lint-streams-torch``).

Runs the static passes on the CPU — the sync / transfer audit over every
arch x serving mode, the CUDA kernel lint and the pool-invariant audit —
and, on a card, the live sync audit (every ``@tick_path`` method under
``torch.cuda.set_sync_debug_mode("error")``) and the quant contract
through the kernels; applies the port's waiver file, prints the findings,
and exits non-zero on any unwaived finding.  ``--device`` defaults to the
card (``repro_torch.device.resolve_device``): without one it raises
unless ``--device cpu`` is given.  ``--json`` writes the full report.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from repro_torch.analysis import RULES, WAIVERS, apply_waivers, load_waivers
from repro_torch.device import resolve_device


def run(archs=None, modes=None, *, device=None) -> dict:
    """Run every pass; returns the raw report dict (``live`` is empty on
    the CPU).  ``device`` is the card unless the caller asks for the CPU;
    the static passes run on the CPU either way."""
    from repro_torch.analysis import kernelcheck, poolcheck, synccheck

    dev = resolve_device(device)
    t0 = time.perf_counter()
    findings, reports = synccheck.audit_matrix(archs, modes)
    findings += kernelcheck.audit_kernels(dev)
    findings += poolcheck.audit_pools()
    t_static = time.perf_counter() - t0
    live = []
    if dev.type == "cuda":
        live_findings, live = synccheck.live_matrix(archs, modes, device=dev)
        findings += live_findings
    wall = time.perf_counter() - t0
    rules = collections.Counter(f.rule for f in findings)
    return {
        "schema": "repro.analysis/1",
        "device": dev.type,
        "wall_s": round(wall, 2),
        "static_s": round(t_static, 2),
        "paths_audited": len(reports),
        "rules": {rid: rules.get(rid, 0) for rid in sorted(RULES)},
        "paths": [r.to_dict() for r in reports],
        "live": live,
        "findings": findings,  # Finding objects; serialized by main()
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Stream-safety analyzer of the port: sync/transfer audit, CUDA "
        "kernel lint, pool-invariant audit, and on a card the live sync audit.")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the full JSON report here")
    ap.add_argument("--waivers", metavar="PATH", default=str(WAIVERS),
                    help="waiver file (default: the port's analysis/waivers.json)")
    ap.add_argument("--arch", action="append", default=None,
                    help="restrict the engine audits to this arch (repeatable)")
    ap.add_argument("--mode", action="append", default=None,
                    help="restrict the engine audits to this serving mode (repeatable)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: adds the live audit) or cpu (static only)")
    args = ap.parse_args(argv)

    report = run(args.arch, args.mode, device=args.device)
    findings = report.pop("findings")
    unwaived, waived = apply_waivers(findings, load_waivers(args.waivers))
    report["findings"] = [f.to_dict() for f in unwaived]
    report["waived"] = [f.to_dict() for f in waived]

    if args.json:
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")

    live = (f", live audit of {len(report['live'])} engines on the card"
            if report["live"] else "")
    print(f"repro_torch.analysis: {report['paths_audited']} paths audited{live} "
          f"in {report['wall_s']}s")
    for f in waived:
        print(f"  waived: {f}")
    for f in unwaived:
        print(f"  {f}")
    if unwaived:
        print(f"FAILED: {len(unwaived)} unwaived finding(s)")
        return 1
    print("clean: no unwaived findings")
    return 0


if __name__ == "__main__":
    sys.exit(main())
