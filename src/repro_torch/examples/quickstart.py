"""Quickstart: train a tiny model for a few steps, then generate
(reference ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--arch qwen3-4b] \\
        [--steps 30] [--device cpu]

Every architecture id works (the reduced smoke config of the family).
"""

from __future__ import annotations

import argparse

import torch

import repro_torch.configs as C
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import ServeConfig, ServingEngine
from repro_torch.runtime.trainer import TrainConfig, Trainer


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=C.list_archs())
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.get_smoke_config(args.arch)
    print(f"[quickstart] arch={args.arch} (reduced: d={cfg.d_model}, "
          f"L={cfg.n_layers}, vocab={cfg.vocab_size})")

    tcfg = TrainConfig(global_batch=4, seq_len=64, steps=args.steps,
                       lr=3e-3, warmup=5, log_every=5)
    out = Trainer(cfg, tcfg, device=dev).train()
    print(f"[quickstart] loss {out['losses'][0]:.3f} -> {out['final_loss']:.3f} "
          f"in {out['wall_s']:.1f}s")

    params = out["params"]
    eng = ServingEngine(cfg, params, ServeConfig(max_seq=96, prefill_chunk=32,
                                                 max_new_tokens=8),
                        device=dev, unembed=T.unembed_f32(cfg, params))
    prompt = torch.randint(0, cfg.vocab_size, (1, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_inputs"] = 0.1 * torch.randn(
            (1, cfg.encoder_seq, cfg.d_model), generator=torch.Generator().manual_seed(2))
    if cfg.prefix_len:
        kw["prefix_embeds"] = 0.1 * torch.randn(
            (1, cfg.prefix_len, cfg.d_model), generator=torch.Generator().manual_seed(3))
    toks = eng.generate(prompt, **kw)
    print(f"[quickstart] generated tokens: {toks.tolist()[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
