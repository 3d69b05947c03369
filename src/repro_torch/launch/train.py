"""Training launcher of the port: ``--arch <id>`` selects any of the ten
architectures (reference ``launch/train.py``).

Smoke-size run (the arch's reduced config, random weights from seed 0):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 50 \
        [--device cpu]

Published widths and depth (bf16 weights and f32 AdamW moments: qwen3-4b
needs ~55 GB of the card at --batch 4 --seq 512; ``--layers N`` cuts the
depth):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --full \
        --steps 6 --batch 4 --seq 512

Over a device mesh, one process per rank under ``torch.distributed.run``
(``--mesh-data D --mesh-model M``, D x M = the number of ranks): FSDP over
``data``, tensor-parallel attention and FFN over ``model``
(``launch/sharding.py``, ``models/meshutil.py``); NCCL on the cards, one a
rank, or gloo with ``--device cpu``:
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 8 \
        -m repro_torch.launch.train --mesh-data 4 --mesh-model 2 --device cpu

Every flag of the reference launcher, plus ``--device``.  It runs on CUDA
unless ``--device cpu``, and prints the reference's ``[train]`` summary
line (on rank 0 over a mesh).
"""

from __future__ import annotations

import argparse
import dataclasses

import torch.distributed as dist

import repro_torch.configs as configs
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.runtime.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (published widths and depth)")
    ap.add_argument("--layers", type=int, default=0,
                    help=">0: cut the depth to this many layers (a multiple of the unit)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mesh-data", type=int, default=0,
                    help=">0: a (data, model) mesh over the ranks of torch.distributed.run")
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def train_config(args: argparse.Namespace) -> TrainConfig:
    """The launcher's TrainConfig (the reference's settings)."""
    return TrainConfig(
        global_batch=args.batch, seq_len=args.seq, steps=args.steps,
        accum=args.accum, checkpoint_dir=args.ckpt,
        checkpoint_every=max(10, args.steps // 4), lr=args.lr,
        warmup=max(2, args.steps // 10))


def main(argv=None) -> dict:
    args = parse_args(argv)
    cfg = configs.get_config(args.arch) if args.full else \
        configs.get_smoke_config(args.arch)
    if args.layers:
        if args.layers % len(cfg.layer_unit):
            raise SystemExit(f"--layers {args.layers}: not a multiple of {cfg.name}'s "
                             f"{len(cfg.layer_unit)}-layer unit")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    mesh, device, rank = None, args.device, 0
    if args.mesh_data > 0:
        device = init_distributed(args.device)
        mesh = make_host_mesh(data=args.mesh_data, model=args.mesh_model)
        rank = dist.get_rank()
    try:
        out = Trainer(cfg, train_config(args), mesh=mesh, device=device).train()
    finally:
        if mesh is not None:
            dist.destroy_process_group()
    if rank == 0:
        print(f"[train] {args.arch}: loss {out['losses'][0]:.4f} -> "
              f"{out['final_loss']:.4f} in {out['wall_s']:.1f}s; "
              f"supervisor: {out['supervisor']}")
    return out


if __name__ == "__main__":
    main()
