"""One run of one benchmark cell on one CUDA card:

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``, and last ``check``: each number compared with its
limit), and the numbers compared as the last lines of standard error.
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics.  Exits non-zero, printing no result, without a card,
without the program (``src/repro_torch``), or when JAX or the JAX
package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # whole top-level module names


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("perfbench: needs a CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from perfbench.harness.bench import run_cell

    result, compared = run_cell(ROOT, args.workload, seed=args.seed, seconds=args.seconds,
                                trace=bool(args.trace), t_start=T_START)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}; the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    result["check"] = compared
    print(json.dumps(result))
    for k, v in compared.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main(sys.argv[1:]))
