"""The prefill kernel's two bf16 tensor-core bodies timed against each other.

``plan_flash`` sends a bf16 call at head_dim 64 / 128 / 256 to the wgmma
body (``"wg"``) when it has at least ``WG_MIN_KEYS`` keys or
``WG_MIN_WORK`` query rows (Sq * g) x keys a kv head, and to the
``mma.sync`` body (``"tc"``) otherwise.  This script measures that
crossover: at each shape below it launches both bodies on the same inputs
(the wgmma body with the split ``wg_plan`` gives it), holds both to the
plain version, and times them and SDPA beside them on the device clock
(calls queued behind a spin kernel).

Shapes: qwen3-4b's heads (H 32 / 8, hd 128) with chunks of 64 at growing
offsets and self-attention of growing Sq; whisper-medium's (16 / 16, hd 64)
non-causal queries over 1500 frames and its decoder's chunks; jamba's g 8
(64 / 8, hd 128) and paligemma's (8 / 1, hd 256) chunks.

    PYTHONPATH=src python -m repro_torch.launch.flash_bodies [--out FILE]
        [--variants]

One line a shape (rows, Sk, both times, the faster body, the planner's
pick), then the card's name and power limit, then a JSON list of the rows
(also written to ``--out``).  ``--variants`` first times the wgmma body's
tilings against each other at the shapes its plan was chosen on (1, 2 or 3
warpgroups a block; the key split's count), one line each, the planned
one marked.  Exit 1 if a body disagrees with the plain
version by more than the bf16 tolerance of the card tests (2e-2), or if
the planner picks the slower body at a shape where the two differ by more
than ``MARGIN``.  Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys

import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.launch.variants import device_ms

ATOL = 2e-2  # bf16, kernel vs plain (the card tests' tolerance)
MARGIN = 0.1  # a pick within 10% of the faster body's time is no miss
QUEUED = 100  # calls queued behind the spin kernel

# (label, H, Hkv, hd, Sq, q_offset, Sk, causal, prefix_len)
SHAPES = (
    [("qwen3 chunk", 32, 8, 128, 64, off, off + 64, True, 0)
     for off in (0, 64, 192, 256, 320, 448, 960, 1984)]
    + [("qwen3 self", 32, 8, 128, sq, 0, sq, True, 0) for sq in (128, 256, 512, 1024)]
    + [("whisper cross", 16, 16, 64, sq, 0, 1500, False, 0) for sq in (16, 64, 256, 1500)]
    + [("whisper chunk", 16, 16, 64, 64, off, off + 64, True, 0) for off in (0, 64, 448)]
    + [("jamba chunk", 64, 8, 128, 64, off, off + 64, True, 0) for off in (0, 64, 448)]
    + [("paligemma chunk", 8, 1, 256, 64, 320, 384, True, 256),
       ("paligemma prefix", 8, 1, 256, 320, 0, 320, True, 256)]
)


def _wg(grid_x, n_kv, b, consumers, splits, key_tile) -> "FA.FlashPlan":
    return FA.FlashPlan("wg", (grid_x, n_kv, b), 4 * consumers + 1, splits, key_tile)


# (label, (B, H, Hkv, hd, Sq, q_offset, Sk, causal, prefix_len), {name: plan}):
# whisper's encoder and cross-attention, paligemma's prefix chunk, the
# training forward and the long context.
VARIANTS = (
    ("4c encoder", (1, 16, 16, 64, 1500, 0, 1500, False, 0), {
        "1 warpgroup": _wg(24, 16, 1, 1, 1, 128),
        "2 warpgroups": _wg(12, 16, 1, 2, 1, 128),
        "2 warpgroups, 2 splits": _wg(24, 16, 1, 2, 2, 128),
        "3 warpgroups": _wg(8, 16, 1, 3, 1, 128),
        "3 warpgroups, 2 splits": _wg(16, 16, 1, 3, 2, 128)}),
    ("4c cross", (1, 16, 16, 64, 64, 0, 1500, False, 0), {
        "no split": _wg(1, 16, 1, 1, 1, 128),
        "4 splits of 3": _wg(4, 16, 1, 1, 4, 128),
        "6 splits of 2": _wg(6, 16, 1, 1, 6, 128),
        "12 splits of 1": _wg(12, 16, 1, 1, 12, 128)}),
    ("4b prefix", (1, 8, 1, 256, 320, 0, 320, True, 256), {
        "no split": _wg(40, 1, 1, 1, 1, 64),
        "2 splits of 3": _wg(80, 1, 1, 1, 2, 64),
        "5 splits of 1": _wg(200, 1, 1, 1, 5, 64)}),
    ("4d forward", (4, 32, 8, 128, 512, 0, 512, True, 0), {
        "1 warpgroup": _wg(32, 8, 4, 1, 1, 128),
        "2 warpgroups": _wg(16, 8, 4, 2, 1, 128)}),
    ("long context", (1, 32, 8, 128, 64, 1984, 2048, True, 0), {
        "4 splits of 4": _wg(8, 8, 1, 2, 4, 128),
        "8 splits of 2": _wg(16, 8, 1, 2, 8, 128),
        "16 splits of 1": _wg(32, 8, 1, 2, 16, 128)}),
)


def measure(label, h, hkv, hd, sq, q_offset, sk, causal, prefix_len) -> dict:
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn((1, sq, h, hd), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((1, sk, hkv, hd), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, window=0, softcap=0.0, scale=hd ** -0.5, q_offset=q_offset,
              prefix_len=prefix_len)
    want = FA.flash_attention_plain(q, k, v, **kw).float()
    plans = {"tc": FA.tc_plan(1, sq, h, hkv), "wg": FA.wg_plan(1, sq, h, hkv, hd, sk=sk)}
    row = {"label": label, "H": h, "Hkv": hkv, "hd": hd, "Sq": sq, "q_offset": q_offset,
           "Sk": sk, "rows": sq * (h // hkv), "causal": causal, "prefix_len": prefix_len}
    for body, plan in plans.items():
        run = functools.partial(FA._launch, q, k, v, None, plan=plan, **kw)
        err = (run().float() - want).abs().max().item()
        row[body] = {"ms": device_ms(run, QUEUED), "err": err, "blocks": plan.blocks,
                     "splits": plan.key_splits}
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = None
    if causal:
        mask = ((torch.arange(q_offset, q_offset + sq, device="cuda")[:, None]
                 >= torch.arange(sk, device="cuda")[None, :])
                | (torch.arange(sk, device="cuda")[None, :] < prefix_len))
    row["sdpa_ms"] = device_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, scale=kw["scale"], enable_gqa=True), QUEUED)
    row["faster"] = min(plans, key=lambda b: row[b]["ms"])
    row["picked"] = FA.plan_flash(1, sq, h, hkv, hd, torch.bfloat16, sk=sk).body
    return row


def variants(label, shape, plans) -> list[dict]:
    """Each wgmma tiling in ``plans`` on the same inputs: device time and
    error against the plain version; the planner's own marked."""
    b, h, hkv, hd, sq, q_offset, sk, causal, prefix_len = shape
    g = torch.Generator(device="cuda").manual_seed(sq + sk)
    q = torch.randn((b, sq, h, hd), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((b, sk, hkv, hd), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, window=0, softcap=0.0, scale=hd ** -0.5, q_offset=q_offset,
              prefix_len=prefix_len)
    want = FA.flash_attention_plain(q, k, v, **kw).float()
    planned = FA.plan_flash(b, sq, h, hkv, hd, torch.bfloat16, sk=sk)
    out = []
    for name, plan in plans.items():
        run = functools.partial(FA._launch, q, k, v, None, plan=plan, **kw)
        err = (run().float() - want).abs().max().item()
        r = {"label": label, "variant": name, "ms": device_ms(run, QUEUED), "err": err,
             "blocks": plan.blocks, "planned": plan == planned}
        out.append(r)
        print(f"[variants] {label}: {name}{' (planned)' if r['planned'] else ''}: "
              f"{r['ms']:.4f} ms, {plan.blocks} blocks, max abs err {err:.2e}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON rows here")
    ap.add_argument("--variants", action="store_true",
                    help="first time the wgmma body's tilings against each other")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bodies: needs a CUDA card", file=sys.stderr)
        return 1
    rows, bad = [], []
    if args.variants:
        for label, shape, plans in VARIANTS:
            for r in variants(label, shape, plans):
                rows.append(r)
                if r["err"] > ATOL:
                    bad.append(f"{label} {r['variant']}: error")
    for shape in SHAPES:
        r = measure(*shape)
        rows.append(r)
        tc, wg = r["tc"]["ms"], r["wg"]["ms"]
        print(f"[bodies] {r['label']}: Sq {r['Sq']} at {r['q_offset']}, Sk {r['Sk']}, "
              f"{r['rows']} rows a kv head: tc {tc:.4f} ms ({r['tc']['blocks']} blocks), wg "
              f"{wg:.4f} ms ({r['wg']['blocks']} blocks, {r['wg']['splits']} split(s)), SDPA "
              f"{r['sdpa_ms']:.4f} ms; faster {r['faster']}, planned {r['picked']}; "
              f"max abs err tc {r['tc']['err']:.2e}, wg {r['wg']['err']:.2e}", flush=True)
        if max(r["tc"]["err"], r["wg"]["err"]) > ATOL:
            bad.append(f"{r['label']} Sq {r['Sq']} Sk {r['Sk']}: error")
        if r[r["picked"]]["ms"] > (1 + MARGIN) * min(tc, wg):
            bad.append(f"{r['label']} Sq {r['Sq']} Sk {r['Sk']}: planned {r['picked']}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip())
    print(json.dumps(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    for line in bad:
        print(f"[bodies] MISS {line}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
