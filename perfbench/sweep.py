"""Find an open-loop cell's knee once, by a sweep on the chip: one set-up,
then one window at each offered rate, the engine drained between them.

    python3 perfbench/sweep.py --workload <cell> --seed <n> --seconds <s> --rates 2 2.5 3

Prints one JSON line a rate: ``tokens_per_s``, ``ttft_p50_ms``,
``ttft_p90_ms``, ``itl_mean_ms``, ``itl_p95_ms``, the requests still queued at the close
and the mean TTFT of the first and the last third of the arrivals (a
backlog that grows shows as a last third far above the first).  The
knee is the highest rate whose backlog does not grow; the cell's traffic
file then takes about 0.8 of it, as a number.  The benchmark's runs do
not use this.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np

    from perfbench.harness import endtoend, loop, traffic
    from perfbench.harness.bench import set_up

    c = set_up(ROOT, args.workload, seed=args.seed, t_start=T_START)
    for rate in args.rates:
        mix = dict(c.mix, rate_per_s=rate)
        reqs = traffic.build(mix, seed=args.seed, seconds=args.seconds,
                             vocab=c.config["model"]["vocab_size"])
        win = loop.run(c.engine, reqs, mix, args.seconds)
        pairs = endtoend.ttft_by_due(win)
        ttft = [t for _, t in pairs]
        third = max(1, len(ttft) // 3)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(ttft),
            "tokens_per_s": endtoend.tokens_per_s(win),
            "ttft_p50_ms": 1e3 * endtoend.percentile(ttft, 50),
            "ttft_p90_ms": 1e3 * endtoend.percentile(ttft, 90),
            "itl_mean_ms": endtoend.READERS["itl_mean_ms"](win),
            "itl_p95_ms": 1e3 * endtoend.percentile(endtoend.itls(win), 95),
            "waiting_at_close": sum(1 for d, t in pairs if d + t > args.seconds),
            "ttft_first_third_ms": 1e3 * float(np.mean(ttft[:third])),
            "ttft_last_third_ms": 1e3 * float(np.mean(ttft[-third:]))}), flush=True)
        c.engine.run()  # drain before the next rate
        c.engine.outputs.clear()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
