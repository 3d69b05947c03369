"""Before / after measurement of the chip smoke's full-width serves: for
each of the fused paged, contiguous and int8 qwen3-4b serves and the
contiguous mamba2-2.7b serve, one warm-up serve, ``--reps`` timed serves
(decode tick p50 and tokens/s, host clock, the tick ending in its one
device-to-host copy) and ``--reps`` serves under ``torch.profiler``, device
activity only (wall, device busy time and idle share, busy time by kernel
group).

It drives the serves through ``chip_smoke.serve`` of the tree it is run
from, so one command measures two trees alike:

    python3 src/repro_torch/launch/serve_profile.py --label this
    (cd build/parent && PYTHONPATH=src python3 \\
        ../../src/repro_torch/launch/serve_profile.py --label parent)

Needs one CUDA card.  Prints one ``[serve_profile]`` line a serve and a JSON
summary as its last line; ``--out`` also writes the summary there.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SERVES = (  # label, model, chip_smoke.serve options
    ("fused paged", "qwen3-4b", dict()),
    ("contiguous", "qwen3-4b", dict(paged=False)),
    ("int8", "qwen3-4b", dict(kv_dtype="int8")),
    ("mamba contiguous", "mamba2-2.7b", dict(paged=False)),
)


def _group(name: str) -> str:
    low = name.lower()
    if "paged_attention" in low or "combine_splits" in low:
        return "paged_attention"
    if "flash_attention" in low:
        return "flash_attention"
    if "ssd" in low:
        return "ssd"
    if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul"
    return "other"


def profiled(smoke, cfg, params, reqs, kw) -> dict:
    """One serve under torch.profiler: wall, device busy ms, idle share and
    busy ms by kernel group."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # Device activity only: the kernels' busy time is all the idle share
    # needs, and host-side tracing would inflate an eager serve's wall.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, ticks, wall = smoke.serve(cfg, params, "cuda", reqs, **kw)
    groups: dict[str, float] = {}
    launches = 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            g = _group(e.key)
            groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
            launches += e.count
    busy = sum(groups.values())
    return {"wall_ms": wall * 1e3, "busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
            "device_launches": launches, "tick_ms_p50": float(np.median(ticks) * 1e3),
            "groups_ms": groups}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", required=True, help="names the tree in the output")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON summary here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as smoke
    from repro_torch.configs import mamba2_2_7b, qwen3_4b
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    models = {"qwen3-4b": qwen3_4b.CONFIG, "mamba2-2.7b": mamba2_2_7b.CONFIG}
    summary = {"label": args.label, "card": smi, "serves": {}}
    params, loaded = None, None
    for label, model, kw in SERVES:
        cfg = models[model]
        if loaded != model:
            params = None
            torch.cuda.empty_cache()
            params = T.init_params(cfg, 0, device="cuda")
            loaded = model
        reqs = smoke.prompts(cfg.vocab_size)
        smoke.serve(cfg, params, "cuda", reqs, **kw)  # warm-up
        timed, prof = [], []
        for _ in range(args.reps):
            eng, toks, _, ticks, wall = smoke.serve(cfg, params, "cuda", reqs, **kw)
            n_tok = sum(len(t) for t in toks)
            timed.append({"tick_ms_p50": float(np.median(ticks) * 1e3),
                          "tokens_per_s": n_tok / wall, "wall_ms": wall * 1e3,
                          "ticks": eng.decode_steps, "chunks": eng.prefill_chunks})
            del eng
        for _ in range(args.reps):
            prof.append(profiled(smoke, cfg, params, reqs, kw))
        row = {"timed": timed, "profiled": prof}
        summary["serves"][label] = row
        print(f"[serve_profile] {args.label} {label}: tick p50 ms "
              f"{[round(t['tick_ms_p50'], 3) for t in timed]}, tok/s "
              f"{[round(t['tokens_per_s'], 2) for t in timed]}; profiled idle share "
              f"{[round(p['idle_share'], 4) for p in prof]}, busy ms "
              f"{[round(p['busy_ms'], 1) for p in prof]}, wall ms "
              f"{[round(p['wall_ms'], 1) for p in prof]}, device launches "
              f"{[p['device_launches'] for p in prof]}; by group (ms, first) "
              + json.dumps({k: round(v, 2) for k, v in sorted(prof[0]['groups_ms'].items())}),
              flush=True)
    params = None
    print(smi)
    text = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    t0 = time.perf_counter()
    rc = main()
    print(f"[serve_profile] {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    sys.exit(rc)
