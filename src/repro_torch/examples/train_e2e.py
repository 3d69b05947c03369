"""End-to-end training: a small LM for a few hundred steps with the
full production stack (prefetch streams, grad-accumulation streaming, async
checkpointing, auto-resume, straggler supervision; reference
``examples/train_e2e.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_e2e --size 100m --steps 300

CI-sized run:
    PYTHONPATH=src python -m repro_torch.examples.train_e2e --size 10m --steps 40 \\
        [--device cpu]

A checkpoint directory that already holds a run is resumed from.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.trainer import TrainConfig, Trainer

SIZES = {
    # name -> (layers, d_model, heads, kv, d_ff, vocab) ~ param count
    "3m": (4, 128, 4, 2, 384, 2048),
    "10m": (6, 256, 4, 2, 768, 4096),
    "30m": (8, 384, 6, 2, 1152, 8192),
    "100m": (12, 640, 10, 2, 1920, 16384),
}


def make_config(size: str) -> ModelConfig:
    l, d, h, kv, ff, v = SIZES[size]
    return ModelConfig(
        name=f"e2e-{size}",
        n_layers=l, d_model=d, n_heads=h, n_kv_heads=kv,
        head_dim=d // h, d_ff=ff, vocab_size=v,
        layer_unit=(LayerSpec(mixer="attn", ffn="dense"),),
        rope_theta=1e4, tie_embeddings=True,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        attn_chunk=128, loss_chunk=128, remat="none",
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--size", default="10m", choices=sorted(SIZES))
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--accum", type=int, default=2)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_e2e_ckpt"))
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = make_config(args.size)
    n_params = T.param_count(cfg)
    print(f"[e2e] {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps x {args.batch}x{args.seq} tokens, "
          f"accum={args.accum} (microbatch streams)")

    tcfg = TrainConfig(
        global_batch=args.batch, seq_len=args.seq, steps=args.steps,
        accum=args.accum, prefetch_depth=2, checkpoint_dir=args.ckpt,
        checkpoint_every=max(10, args.steps // 4), log_every=10,
        lr=1e-3, warmup=max(5, args.steps // 20))
    out = Trainer(cfg, tcfg, device=dev).train()

    print(f"[e2e] final loss {out['final_loss']:.4f} "
          f"(start {out['losses'][0]:.4f}) wall {out['wall_s']:.1f}s "
          f"({args.steps * args.batch * args.seq / out['wall_s']:.0f} tok/s)")
    rep = out["supervisor"]
    print(f"[e2e] supervisor: median step {rep['median_s']:.3f}s, "
          f"stragglers={rep['stragglers']}, failures={rep['failures']}")
    assert out["final_loss"] < out["losses"][0], "training must reduce loss"
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
