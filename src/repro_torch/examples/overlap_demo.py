"""Host-side multiple streams, measured for real (the paper's Fig. 9 on this
machine): stage-by-stage vs pipelined execution of H2D/KEX/D2H tasks, plus
the training loop's prefetch overlap (reference ``examples/overlap_demo.py``).

The three streamable categories run through ``launch/streams`` (the
streamed matmul, FWT and NW kernels over CUDA streams, each output held
against its plain version and multi-stream against single-stream); the
prefetch case is the reference benchmark's loop, copied here: depth 0 vs 2
over ``SyntheticLM`` and ``PrefetchIterator`` with a tanh matmul step on the
device.

    PYTHONPATH=src python -m repro_torch.examples.overlap_demo [--device cpu] \\
        [--small] [--tasks 8]

``--small`` runs ``launch/streams``' small tasks (for the CPU).  Exit 1 if
an output disagrees with its plain version or with single-stream.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import streams


def prefetch_overlap(device: torch.device, *, steps: int = 12, work_ms: float = 15.0) -> dict:
    """Host->device prefetch (depth 2) vs synchronous fetch during a train-ish
    loop: the paper's H2D/KEX overlap measured for real (reference
    ``benchmarks/bench_overlap.prefetch_overlap``)."""

    def compute(tokens: torch.Tensor) -> float:
        x = tokens.float()
        return torch.tanh(x @ x.T).sum().item()  # the step, then a wait for it

    def loop(depth: int) -> float:
        src = SyntheticLM(1000, global_batch=96, seq_len=96, work_ms=work_ms)
        it = PrefetchIterator(iter(src), depth=depth, device=device)
        compute(next(it)["tokens"])  # warm-up
        t0 = time.perf_counter()
        for _ in range(steps):
            compute(next(it)["tokens"])
        dt = time.perf_counter() - t0
        it.close()
        return dt

    t_sync = loop(0)
    t_pre = loop(2)
    return {"t_single_s": t_sync, "t_multi_s": t_pre, "improvement": t_sync / t_pre - 1.0}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--small", action="store_true",
                    help="launch/streams' small tasks: matmul 256, FWT 2^16, NW 256")
    ap.add_argument("--tasks", type=int, default=8)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    print("[overlap] real task pipelines (single vs multi stream):")
    bad = []
    for r in streams.run(device=dev, n_tasks=args.tasks, small=args.small):
        # t_single / t_multi - 1, as the reference prints it (streams' lines
        # give the time saved, 1 - t_multi / t_single)
        model = r["model_improvement"] / (1.0 - r["model_improvement"])
        print(f"  {r['benchmark']:18s} single={r['single_ms']:7.1f}ms "
              f"multi={r['multi_ms']:7.1f}ms "
              f"improvement={(r['single_ms'] / r['multi_ms'] - 1) * 100:5.1f}% "
              f"(model {model * 100:5.1f}%)")
        if r["max_abs_err"] > r["tol"] or not r["multi_equals_single"]:
            bad.append(r["category"])

    p = prefetch_overlap(dev)
    print(f"  {'prefetch':18s} single={p['t_single_s'] * 1e3:7.1f}ms "
          f"multi={p['t_multi_s'] * 1e3:7.1f}ms "
          f"improvement={p['improvement'] * 100:5.1f}%")

    print("[overlap] paper Fig. 9 validation (pipeline model) and the lavaMD "
          "negative case:")
    for line in streams.paper_model_checks():
        print(f"  {line}")
    if bad:
        print(f"[overlap] FAILED: {bad} disagree with the plain version or single-stream")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
