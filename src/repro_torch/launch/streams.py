"""The paper's Fig. 9 experiment on the port: single stream vs multiple
streams over a real host-to-card link.

For each streamable category it builds host tasks from ``--seed`` with
numpy (pinned on a card), and on one ``HostStreamExecutor`` runs a warm-up,
``measure_r`` (stage by stage), then ``single_stream_run`` and
``multi_stream_run`` (median of 3 each):

  * Independent (paper: sgemm): the streamed matmul, f32 (2048, 2048) @
    (2048, 2048) per task.
  * False-dependent (paper: FastWalshTransform): the Walsh-Hadamard
    transform of a flat f32 vector of 2^22 (Kronecker passes (4096, 1024)
    and (1024, 4096)).
  * True-dependent (paper: nw, Rodinia's default 2048): the NW wavefront
    over the +-1 match scores of two random DNA sequences of 2048, gap 1,
    tiles of 32 (64 x 64 tiles, 127 diagonals; on the card one launch a
    task walks them all).

One line per category: R, the ``plan_streaming`` decision and stream count,
the stage times, the single and multi walls, the measured improvement
beside the pipeline model's (``rmetric.streaming_speedup`` of the measured
stage times), the H2D/KEX overlap the CUDA events show, and the error
against the plain version.  Then the paper-number checks of the model and
the lavaMD negative case.

    PYTHONPATH=src python -m repro_torch.launch.streams [--device cpu] \\
        [--tasks 8] [--streams 4] [--small]

``--small`` runs the same tasks at matmul 256, FWT 2^16 and NW 256 x 256
(for the CPU).  Without ``--device cpu`` it runs on the card, and raises
without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import dependency as dep
from repro_torch.core import halo, rmetric
from repro_torch.core.streams import HostStreamExecutor, plan_streaming
from repro_torch.device import resolve_device
from repro_torch.kernels import nw_tile as nw_k
from repro_torch.kernels import ops, ref

SIZES = {"full": {"matmul": 2048, "fwt": 1 << 22, "nw": 2048},
         "small": {"matmul": 256, "fwt": 1 << 16, "nw": 256}}
NW_BLOCK, NW_GAP = 32, 1.0
FWT_HALO = (254, 1048576)  # the paper's FWT halo / task elements (S5)
REPEATS = 3
WARMUP = 2  # rounds of (single, multi) before measure_r: one leaves the
# device allocator still growing (measure_r's KEX then includes cudaMalloc)
#: benchmark -> the paper's measured Fig. 9 improvement (t1 / tn - 1)
PAPER_FIG9 = {"nn": 0.85, "fwt": 0.39, "cFFT": 0.38, "nw": 0.52}


@dataclasses.dataclass(frozen=True)
class Case:
    """One streamable category: its paper benchmark, task builder, kernel
    function, plain version and the tolerance of the one against the other
    (max abs error, relative to the plain output's largest magnitude)."""

    category: str
    benchmark: str  # key of dependency.PAPER_TABLE2
    kernel: str
    make: Callable[[np.random.Generator, int], Any]
    fn: Callable[[Any], torch.Tensor]
    plain: Callable[[Any], torch.Tensor]
    rtol: float
    halo: tuple[int, int] = (0, 1)

    def shape(self, size: int) -> str:
        return {"matmul": f"f32 ({size}, {size}) @ ({size}, {size})",
                "fwt": f"f32 vector of {size}",
                "nw": f"f32 ({size}, {size}) +-1 scores, tiles of {NW_BLOCK}"}[self.kernel]


def _dna_scores(rng: np.random.Generator, n: int) -> np.ndarray:
    a, b = rng.integers(0, 4, n), rng.integers(0, 4, n)
    return np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32)


CASES = (
    # f32 sums of k products in another order than the plain matmul's: well
    # inside 1e-5 of the largest output at k = 2048.
    Case("independent", "sgemm", "matmul",
         lambda rng, n: tuple(torch.from_numpy(rng.standard_normal((n, n), np.float32))
                              for _ in range(2)),
         lambda t: ops.matmul(t[0], t[1]), lambda t: ref.matmul_ref(t[0], t[1]), 1e-5),
    # The same f32 butterflies in the same order as the plain version: exact.
    Case("false-dependent", "FastWalshTransform", "fwt",
         lambda rng, n: torch.from_numpy(rng.standard_normal(n, np.float32)),
         ops.fwt, ref.fwt_ref, 0.0, FWT_HALO),
    # Integer scores: every value is exact, so kernel == plain bit for bit.
    Case("true-dependent", "nw", "nw",
         lambda rng, n: torch.from_numpy(_dna_scores(rng, n)),
         lambda t: ops.nw_wavefront(t, block=NW_BLOCK, gap=NW_GAP),
         lambda t: nw_k.nw_wavefront_plain(t, block=NW_BLOCK, gap=NW_GAP), 0.0),
)


def make_tasks(case: Case, *, n_tasks: int, size: int, seed: int, pin: bool) -> list[Any]:
    rng = np.random.default_rng(seed)
    tasks = [case.make(rng, size) for _ in range(n_tasks)]
    if pin:
        tasks = [tuple(t.pin_memory() for t in task) if isinstance(task, tuple)
                 else task.pin_memory() for task in tasks]
    return tasks


def _to(task: Any, device: torch.device) -> Any:
    return (tuple(t.to(device) for t in task) if isinstance(task, tuple)
            else task.to(device))


def run_case(case: Case, *, device: torch.device, n_tasks: int, streams: int, size: int,
             seed: int) -> dict:
    """Warm-up, measure_r, then REPEATS x (single, multi); returns the
    measurements, the checks and the last multi-stream outputs."""
    tasks = make_tasks(case, n_tasks=n_tasks, size=size, seed=seed,
                       pin=device.type == "cuda")
    ex = HostStreamExecutor(case.fn, num_streams=streams, device=device)
    for _ in range(WARMUP):  # kernel build, the allocators' pools, D2H buffers
        ex.single_stream_run(tasks)
        ex.multi_stream_run(tasks)
    r, staged = ex.measure_r(tasks)
    walls1, stats_n = [], []
    for _ in range(REPEATS):  # keep the last outputs only: each set is pinned memory
        out1, s1 = ex.single_stream_run(tasks)
        outs, sn = ex.multi_stream_run(tasks)
        walls1.append(s1.wall)
        stats_n.append(sn)
    t1 = float(np.median(walls1))
    tn = float(np.median([s.wall for s in stats_n]))
    multi_med = sorted(stats_n, key=lambda st: st.wall)[REPEATS // 2]
    same = all(torch.equal(a, b) for a, b in zip(out1, outs))
    err = scale = 0.0
    for task, got in zip(tasks, outs):
        want = case.plain(_to(task, device)).cpu()
        err = max(err, (got.float() - want.float()).abs().max().item())
        scale = max(scale, want.float().abs().max().item())
    stages = staged.stage_times()
    plan = plan_streaming(dep.PAPER_TABLE2[case.benchmark][0], stages,
                          halo_elements=case.halo[0], task_elements=case.halo[1])
    return {
        "category": case.category, "benchmark": case.benchmark, "kernel": case.kernel,
        "shape": case.shape(size), "tasks": n_tasks, "streams": streams,
        "R": r, "transfer_ratio": stages.transfer_ratio(), "decision": plan.decision,
        "plan_streams": plan.num_streams, "plan_notes": plan.notes,
        "h2d_ms": staged.h2d * 1e3, "kex_ms": staged.kex * 1e3, "d2h_ms": staged.d2h * 1e3,
        "single_ms": t1 * 1e3, "multi_ms": tn * 1e3,
        "improvement": 1.0 - tn / t1,
        "model_improvement": rmetric.streaming_speedup(stages, streams),
        "overlap_ms": multi_med.h2d_kex_overlap() * 1e3,
        "multi_busy_ms": {"h2d": multi_med.h2d * 1e3, "kex": multi_med.kex * 1e3,
                          "d2h": multi_med.d2h * 1e3},
        "single_walls_ms": [w * 1e3 for w in walls1],
        "multi_walls_ms": [st.wall * 1e3 for st in stats_n],
        "task_runs": (2 * WARMUP + 1 + 2 * REPEATS) * n_tasks,
        "max_abs_err": err, "tol": case.rtol * max(1.0, scale),
        "multi_equals_single": same, "outputs": outs,
    }


def paper_model_checks() -> list[str]:
    """The pipeline model against the paper's Fig. 9 gains, and the lavaMD
    negative case (the reference's ``validate_paper_numbers`` and
    ``lavamd_case``)."""
    lines = []
    for name, gain in PAPER_FIG9.items():
        r = 1.0 - 1.0 / (1.0 + gain)  # R implied by the gain under the model
        t = rmetric.StageTimes(h2d=r, kex=1.0 - r)
        modeled = rmetric.single_stream_time(t) / rmetric.multi_stream_time(t, 32) - 1.0
        ok = abs(modeled - gain) < 0.05 and rmetric.streaming_decision(
            t) is rmetric.StreamDecision.STREAM
        lines.append(f"[streams] paper {name}: measured +{gain * 100:.0f}%, model "
                     f"+{modeled * 100:.0f}% (match {ok})")
    times, measured_multi = rmetric.lavamd_counterexample()
    model_multi = halo.streamed_time_with_halo(times.h2d, times.kex, num_streams=4,
                                               halo_ratio=222 / 250)
    lines.append(f"[streams] lavaMD: single {times.total:.4f}s, paper multi "
                 f"{measured_multi:.4f}s, model multi {model_multi:.4f}s (regresses: "
                 f"{model_multi > times.total}); halo rule blocks streaming: "
                 f"{not halo.halo_streaming_profitable(222, 250)}")
    return lines


def format_line(res: dict) -> str:
    return (
        f"[streams] {res['category']} ({res['benchmark']}, {res['kernel']}): {res['tasks']} "
        f"tasks of {res['shape']}; R {res['R']:.4f} (transfer {res['transfer_ratio']:.4f}), "
        f"plan {res['decision']} x{res['plan_streams']}; stage by stage H2D "
        f"{res['h2d_ms']:.3f} ms, KEX {res['kex_ms']:.3f} ms, D2H {res['d2h_ms']:.3f} ms; "
        f"single {res['single_ms']:.3f} ms, multi {res['multi_ms']:.3f} ms "
        f"({res['streams']} streams, median of {REPEATS}); improvement measured "
        f"{res['improvement'] * 100:.1f}%, model {res['model_improvement'] * 100:.1f}%; "
        f"H2D/KEX overlap {res['overlap_ms']:.3f} ms; max abs err {res['max_abs_err']:.3e} "
        f"(tol {res['tol']:.3e}); multi == single {res['multi_equals_single']}")


def run(*, device: str | torch.device | None = None, n_tasks: int = 8, streams: int = 4,
        small: bool = False, seed: int = 0) -> list[dict]:
    """Every category in turn; returns run_case's dicts."""
    dev = resolve_device(device)
    sizes = SIZES["small" if small else "full"]
    out = []
    for i, case in enumerate(CASES):
        t0 = time.perf_counter()
        res = run_case(case, device=dev, n_tasks=n_tasks, streams=streams,
                       size=sizes[case.kernel], seed=seed + i)
        res["seconds"] = time.perf_counter() - t0
        out.append(res)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--tasks", type=int, default=8)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--small", action="store_true", help="matmul 256, FWT 2^16, NW 256")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        print(f"[streams] {torch.cuda.get_device_name(dev)}")
    results = run(device=dev, n_tasks=args.tasks, streams=args.streams, small=args.small,
                  seed=args.seed)
    bad = []
    for res in results:
        print(format_line(res))
        if res["max_abs_err"] > res["tol"] or not res["multi_equals_single"]:
            bad.append(res["category"])
    for line in paper_model_checks():
        print(line)
    print("[streams] " + json.dumps([{k: v for k, v in r.items() if k != "outputs"}
                                     for r in results]))
    if bad:
        print(f"[streams] FAILED: {bad} disagree with the plain version or single-stream")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
