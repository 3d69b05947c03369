"""Readings for a cell's limits, on the chip at the cell's own size: the
program's numbers over many seeds (the lower reading) and the control's
(the reference in float8 e4m3 put in the program's place: the upper
reading), judged by the cell's limits, in one process, one full run a
seed.

    python3 perfbench/calibrate.py --workload <cell> --seconds <s> --seeds 11 12 ... \\
        [--control-seeds 3]

Prints one JSON line a seed: the program's ``correct`` and numbers under
the cell's present limits and, for the first ``--control-seeds`` seeds,
the control's (``control_correct``, ``control``), which has to read
``false``.  The benchmark's runs do not use this; PERF.md keeps the
readings and the limits set from them.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness.bench import run_cell

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        result, compared = run_cell(ROOT, args.workload, seed=seed, seconds=args.seconds,
                                    trace=False, t_start=t0,
                                    control=i < args.control_seeds)
        line = {"seed": seed, "correct": result["correct"],
                **{k: v["value"] for k, v in compared.items()},
                "metrics": {k: v["value"] for k, v in result["metrics"].items()}}
        if "control" in result:
            line["control_correct"] = result["control"]["correct"]
            line["control"] = {k: v["value"] for k, v in result["control"]["check"].items()}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
