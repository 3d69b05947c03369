"""Where a training step's time goes on the card.

Trains ``--arch`` (its smoke config, or with ``--full`` the published one)
from random weights on synthetic batches of ``--batch`` x ``--seq``
through ``launch.steps.make_train_step`` (remat as the config says), and
after ``--warm`` steps measures, each synchronized on the host clock:

* a whole step, and the host's time to issue it (the call returns before
  the card finishes; an issue time close to the step's means the host
  bounds it), after counting the synchronizing CUDA calls one step makes
  (``torch.cuda.set_sync_debug_mode``): with none, the issue time holds
  no wait for the card;
* the loss and gradients alone, then the AdamW update alone;
* one more step under ``torch.profiler`` (device activity only): device
  busy time by kernel group (the prefill and SSD kernels, bf16 and f32
  matmuls, everything else) and the idle share of the step's wall.

    PYTHONPATH=src python3 src/repro_torch/launch/train_profile.py --arch qwen3-4b --full

With ``--mesh`` the state is DTensors on a 1 x 1 mesh (a world of 1:
NCCL on the card, gloo on the CPU) and the step is the sharded one, whose
only communication is then on axes of size 1: its synchronizing calls
should be 0 as the single-device step's are.

Needs one CUDA card (``--device cpu`` runs the same timings on the CPU,
without the profile).  Prints one ``[train_profile]`` line per measurement
and a JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import warnings

import torch

import repro_torch.configs as configs
from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as M
from repro_torch.launch import sharding, steps
from repro_torch.models import meshutil
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def _group(name: str) -> str:
    low = name.lower()
    if "flash_attention" in low:
        return "flash_attention"
    if "ssd" in low:
        return "ssd"
    if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma", "cutlass")):
        return "matmul_f32" if any(w in low for w in ("f32f32", "sgemm", "tf32")) else \
            "matmul_bf16"
    return "other"


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sync_sites(dev: torch.device, fn) -> list[str] | None:
    """Where ``fn()`` makes a synchronizing CUDA call: the Python line of
    each (a backward's calls are reported at the ``autograd.grad`` line);
    None on the CPU."""
    if dev.type != "cuda":
        fn()
        return None
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (setting the mode also warns, that the mode is a prototype)
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "called a synchronizing CUDA operation" in str(w.message)]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.list_archs())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--warm", type=int, default=2)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--mesh", action="store_true", help="the sharded step on a 1 x 1 mesh")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = configs.get_config(args.arch) if args.full else configs.get_smoke_config(args.arch)
    params = T.init_params(cfg, 0, device=dev)
    src = SyntheticLM(cfg.vocab_size, global_batch=args.batch, seq_len=args.seq)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in src.batch_at(i).items()}
               for i in range(2)]
    scope = contextlib.nullcontext()
    if args.mesh:
        dev = M.init_distributed(args.device)
        mesh = M.make_host_mesh(data=1, model=1)
        params = sharding.distribute(params, sharding.param_specs(params, mesh), mesh)
        local = batches
        batches = [sharding.distribute_batch(b, mesh) for b in batches]
        scope = meshutil.use_mesh(mesh, batch_axes=("data",))
    opt = adamw.init_state(params)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    step = steps.make_train_step(cfg, ocfg)
    for i in range(args.warm):
        step(params, opt, batches[i % 2])
    sites = _sync_sites(dev, lambda: step(params, opt, batches[1]))
    syncs = None if sites is None else len(sites)
    _sync(dev)

    t0 = time.perf_counter()
    step(params, opt, batches[0])
    issue = time.perf_counter() - t0
    _sync(dev)
    whole = time.perf_counter() - t0

    t0 = time.perf_counter()
    leaves = [p for _, p in tree_paths(params)]
    with scope:
        loss, _ = T.train_loss(cfg, params, local[1] if args.mesh else batches[1])
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    _sync(dev)
    fwd_bwd = time.perf_counter() - t0
    grad_tree = tree_from_paths((path, g) for (path, _), g in zip(tree_paths(params), grads))
    t0 = time.perf_counter()
    adamw.apply_updates(ocfg, params, grad_tree, opt)
    _sync(dev)
    update = time.perf_counter() - t0
    del grads, grad_tree, loss

    out = {"arch": args.arch, "full": args.full, "mesh": args.mesh, "batch": args.batch,
           "seq": args.seq, "remat": cfg.remat, "syncs": syncs, "sync_sites": sites, "step_s": whole,
           "issue_s": issue, "fwd_bwd_s": fwd_bwd, "adamw_s": update}
    print(f"[train_profile] {args.arch}{' full' if args.full else ''}"
          f"{' on a 1 x 1 mesh' if args.mesh else ''} {args.batch} x "
          f"{args.seq}, remat {cfg.remat}: {syncs} synchronizing calls a step {sites}; step "
          f"{whole * 1e3:.1f} ms (host issue {issue * 1e3:.1f} ms); loss + grads {fwd_bwd * 1e3:.1f} ms, AdamW "
          f"{update * 1e3:.1f} ms")
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, opt, batches[1])
            _sync(dev)
            wall = time.perf_counter() - t0
        kern = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        busy = sum(ms for _, ms, _ in kern)
        groups: dict[str, float] = {}
        for name, ms, _ in kern:
            groups[_group(name)] = groups.get(_group(name), 0.0) + ms
        out |= {"profiled_wall_s": wall, "busy_ms": busy, "idle_share": 1 - busy / (wall * 1e3),
                "groups_ms": groups, "top": [(n[:90], ms, c) for n, ms, c in
                                              sorted(kern, key=lambda r: -r[1])[:12]]}
        print(f"[train_profile] profiled step: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms, idle share {out['idle_share']:.3f}; by group (ms) "
              + json.dumps({k: round(v, 3) for k, v in sorted(groups.items())}))
        for name, ms, n in out["top"]:
            print(f"[train_profile]   {ms:9.3f} ms  {n:6d} x  {name}")
    if args.mesh:
        torch.distributed.destroy_process_group()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
