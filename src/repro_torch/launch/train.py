"""Training launcher of the port: ``--arch <id>`` selects any of the ten
architectures (reference ``launch/train.py``).

Smoke-size run (the arch's reduced config, random weights from seed 0):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --steps 50 \
        [--device cpu]

Published widths and depth (bf16 weights and f32 AdamW moments: qwen3-4b
needs ~55 GB of the card at --batch 4 --seq 512):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b --full \
        --steps 6 --batch 4 --seq 512

Every flag of the reference launcher but ``--mesh-data`` / ``--mesh-model``
(training over a device mesh is ROADMAP A12b).  It runs on CUDA unless
``--device cpu``, and prints the reference's ``[train]`` summary line.
"""

from __future__ import annotations

import argparse

import repro_torch.configs as configs
from repro_torch.runtime.trainer import TrainConfig, Trainer


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (published widths and depth)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
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
    out = Trainer(cfg, train_config(args), device=args.device).train()
    print(f"[train] {args.arch}: loss {out['losses'][0]:.4f} -> "
          f"{out['final_loss']:.4f} in {out['wall_s']:.1f}s; "
          f"supervisor: {out['supervisor']}")
    return out


if __name__ == "__main__":
    main()
