#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, holds the card against the CPU on
2-layer full-width qwen3-4b and mamba2-2.7b and on the paper's streaming
path at a small size, then serves requests through the full 36-layer bf16
qwen3-4b on the card (plain, with speculative decode, over int8 and fp8 KV
pages, over int8 pages with speculative decode, over the contiguous slot
cache, and in a page pool small enough to preempt) and through the full
64-layer bf16 mamba2-2.7b (contiguous slot cache, paged pool, state
snapshots), and runs the paper's Fig. 9 experiment (matmul, FWT and NW
tasks over CUDA streams and the PCIe link) at full size.

    python3 chip_smoke.py            # every phase, on one CUDA card
    python3 chip_smoke.py --profile  # the same, plus torch.profiler serves

Phases (any failed check raises, and the script exits non-zero):
  1. device: card name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and cuDNN so f32 means f32.
  2. build: every kernel from src/repro_torch/kernels/csrc, timed.
  3. kernels: each of the ten kernels (paged decode, its draft-block,
     fused-dequant and draft-block fused-dequant entries, prefill, SSD
     chunk scan) against its plain version in f32 (atol 1e-5) and bf16
     (atol 2e-2), over int8 and fp8 codes for the quantized entries, at the
     serving shapes; the SSD scan's y and final state over aligned and
     ragged lengths, Q = 256 and zero / random initial states, relative to
     the plain output's largest magnitude (at least 1): f32 1e-4 (see
     SSD_RTOL), bf16 2e-2;
     the paper kernels at the streaming path's shapes: the streamed matmul
     (f32 2048^3, bf16, mixed and ragged) within 1e-5 (f32) / 2e-2 (bf16)
     of the plain output's largest magnitude, the FWT row pass (rows of
     1 to 2^15, (4096, 1024) and (1024, 4096) among them) and column pass
     ((4096, 1024), ragged, narrow and tall, in place) and ops.fwt of a 2^22
     task bit-equal to their plain versions, NW tiles and 512 x 384 wavefronts
     bit-equal to nw_full_ref (integer scores) and to the plain version
     (normal scores, gap 0.5), and a 2048^2 task, one launch or one
     nw_diagonal launch a diagonal, bit-equal to the plain version; kernel,
     plain, library (SDPA; torch.matmul for the matmul; an f32 product with
     the Sylvester Hadamard matrix for each FWT pass; none for the SSD scan
     and NW) times and the memory/compute bound (NW: one launch a 2048^2
     task, with the 127-launch diagonal path's time beside; FWT: each pass
     of a 2^22 task and the whole ops.fwt, cold over a rotation of 8 tasks
     and warm, queued behind a spin kernel).  The
     attention and SSD kernels and their library calls are timed with the
     calls queued behind a spin kernel (device time; the host's issue rate
     is printed beside), the plain versions with CUDA events as issued.  The
     draft-block entries are held over row tiles (68 rows), g = 1 and 8,
     head_dim 64 and 256 and splits behind the window as well; the
     quantized entries over V codes that cancel (bf16 q, q_len 1 and 5)
     within 1e-4, which only P at f32 accuracy meets.  All four paged
     entries run the split body, print its split plan and grid beside their
     times, and are timed again at a long context (128 pages of 16) beside
     their bound and SDPA.  The prefill kernel prints its plan and is timed
     at the serve's chunk and at a long context (Sq 64 at q_offset 1984)
     beside SDPA and its bound, at the plan's tiling and the body's other
     two; the matmul prints its plan, and its bound counts the three TF32
     products of its f32 accuracy at the TF32 peak (the one-product f32 FMA
     bound beside it).
  4. card vs CPU: qwen3-4b at full width cut to 2 layers, f32, 6 requests
     served on cuda (kernels) and on cpu (plain versions): admission logits
     allclose (atol 2e-3, rtol 1e-3) and greedy tokens identical per uid;
     speculative decode (n-gram drafts on tiled prompts, and an oracle
     drafter) identical card vs CPU and equal to the plain serve; int8 and
     fp8 pages card vs CPU greedy agreement >= 0.5.  mamba2-2.7b at full
     width cut to 2 layers, f32, served contiguous, paged and with state
     snapshots (prompts sharing a 64-token head): admission logits allclose
     (atol 2e-3, rtol 1e-3), greedy tokens and snapshot hits identical.
     The streaming path (launch/streams --small, 2 tasks a category) on the
     card and on the CPU: matmul outputs within 1e-5 of the largest
     magnitude, FWT and NW identical.
  5. main path: full qwen3-4b (36 layers, bf16, random weights from a seed)
     serves the same 6 requests plain, with speculative decode (oracle
     drafter, then n-gram drafts on tiled prompts), over int8 and fp8 pages,
     and over int8 pages with speculative decode; tokens/s, decode-tick and
     prefill-chunk times, acceptance, page bytes, agreement with the plain
     serve; each serve's launch counts are 36 per tick of its kind and per
     prefill chunk.
  5b. cache paths: (a) qwen3-4b at full width cut to 2 layers, f32, card
     vs CPU: the contiguous slot cache and scatter-after-prefill (paged,
     not fused) give greedy tokens identical card vs CPU and to the fused
     paged serve, admission logits allclose; contiguous spec decode
     (n-gram and oracle drafts) equal to the plain contiguous serve; a
     pool of PRESSURE_BLOCKS blocks preempts (the same count on both
     devices) with the unpressured serve's tokens, and over int8 pages
     with card vs CPU agreement >= 0.5.  (b) the full qwen3-4b of phase 5:
     the contiguous serve (tokens/s, tick p50, prefill launches > 0)
     between phase 5's fused paged serve and another after it, and the
     paged serve in a pool of PRESSURE_BLOCKS blocks: >= 2 preemptions,
     phase 5's tokens per request, no page left in use, the pool's
     invariants, and each evict and readmit timed (host clock around a
     synchronize); each warmed once and measured with the launch counts
     at 0.
  6. main path, mamba: full mamba2-2.7b (64 layers, bf16, random weights
     from a seed) serves the same 6 requests over a contiguous slot cache
     and beside a paged pool, then prompts sharing a 64-token head with
     state snapshots (tokens equal to the same prompts served without
     them); tokens/s, tick and chunk times, snapshot hits and the
     snapshot's device-to-host copy time; the SSD kernel launches 64 times
     per prefill chunk and no other kernel launches.
  7. main path, streams: launch/streams at full size (8 tasks a category,
     4 CUDA streams): per category R, the plan, stage times, single and
     multi walls, measured and modeled improvement, the H2D/KEX overlap
     from CUDA events; outputs equal to the plain version, multi-stream
     outputs equal to single-stream outputs, overlap > 0, and exactly 1
     matmul, 2 FWT (1 row pass, 1 column pass) and 1 NW launch per task
     run; then the pinned
     H2D / D2H bandwidth of a 256 MB copy.  The improvement is reported,
     not asserted.
With --profile, phases 5, 5b and 6 add a torch.profiler breakdown (device
busy time by kernel and by group, the paged-attention group's split and
combine launches together; idle share) of the plain, oracle-spec, int8,
qwen3 contiguous and mamba contiguous serves.  The last three lines of
stdout are the card's name and power limit, the kernels JSON and the
result JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
# dense, no sparsity; "tf32": the tensor cores' TF32 rate (3xTF32 matmul)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, "tf32": 495e12}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
# The SSD scan, relative to the plain output's largest magnitude (at least
# 1): inside a chunk of up to 256 tokens the cumulative log-decay reaches
# hundreds, so one f32 ulp of it is a relative error of ~1e-5 in each decay
# factor, and kernel and plain sum it in different orders.  1e-4 is the
# reference's own tolerance for its SSD kernel (tests/test_kernels.py).
SSD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LOGIT_ATOL, LOGIT_RTOL = 2e-3, 1e-3  # card vs CPU, f32, 2 layers
PROMPT_LENS = (128, 100, 77, 128, 64, 33)
NEW_TOKENS, SLOTS, CHUNK, BLOCK = 16, 4, 64, 16
SPEC_K, SEGMENT = 4, 16  # draft tokens per verify step; tiled prompts' period
QUANT_FLOOR = 0.5  # greedy agreement of quantized pages (the reference's floor)
# The quantized paged entries on ref.cancelling_quant_case (bf16 q, V values
# that cancel: output ~1e-7, sum |p v| / l ~2.5): ten times what P at f32
# accuracy leaves (<= 8e-6 in the plain emulation), a thirtieth of what P
# rounded once to bf16 leaves (>= 2.7e-3).
P_CODES_TOL = 1e-4
KERNELS = {  # name -> (CUDA source, the TPU kernel it replaces)
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention.py:40"),
    "paged_attention_multi": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                              "src/repro/kernels/paged_attention.py:277"),
    "paged_attention_quant": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                              "src/repro/kernels/ops.py:122"),
    "paged_attention_multi_quant": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                    "src/repro/kernels/ops.py:150"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:32"),
    "ssd": ("src/repro_torch/kernels/csrc/ssd_chunk.cu",
            "src/repro/kernels/ssd_chunk.py:43"),
    "streamed_matmul": ("src/repro_torch/kernels/csrc/streamed_matmul.cu",
                        "src/repro/kernels/streamed_matmul.py:25"),
    "fwt": ("src/repro_torch/kernels/csrc/fwt.cu", "src/repro/kernels/fwt.py:32"),
    # ops.fwt's second pass: the same TPU kernel over the transposed layout
    "fwt_columns": ("src/repro_torch/kernels/csrc/fwt.cu", "src/repro/kernels/fwt.py:32"),
    "nw_tile": ("src/repro_torch/kernels/csrc/nw_tile.cu", "src/repro/kernels/nw_tile.py:42"),
}
# The streamed matmul, relative to the plain output's largest magnitude (at
# least 1): k-long f32 sums in another order, one bf16 ulp.  FWT and NW are
# exact (the same f32 operations in the same order).
PAPER_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SNAP_HEAD = 64  # tokens every snapshot-serve prompt longer than it starts with
LONG_Q_OFFSET = 1984  # the prefill kernel's long context: Sq 64 at Sk 2048


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 4, sleep_cycles: int = 400_000_000) -> float:
    """Mean device time per call of ``fn`` when the host issues faster than
    the card runs: the stream is held by a spin kernel (~0.2 s) while the
    ``iters`` calls are queued behind it, so the events see back-to-back
    launches, not the host's issue rate.  Keep ``iters`` x launches per
    call under the launch queue's ~1000 entries."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# Calls queued behind device_ms's spin kernel to time a phase-3 kernel and
# its library call: a draft-block call runs on the card in less time than
# the host takes to issue it, so time_ms would time the host (it is printed
# beside); 100 calls of at most a few launches each stay inside the queue.
QUEUED = 100


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_mem = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_mem, "bytes") if t_mem >= t_ops else (t_ops, "operations")


# -- phase 3: kernels ------------------------------------------------------------


def paged_case(dtype, cur, *, trash_row=None, seed=0, b=4, h=32, hkv=8, hd=128,
               bs=16, n_pages=9):
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = 1 + b * n_pages
    q = torch.randn((b, h, hd), generator=g, device="cuda").to(dtype)
    kp = torch.randn((nb, bs, hkv, hd), generator=g, device="cuda")
    vp = torch.randn((nb, bs, hkv, hd), generator=g, device="cuda")
    kp[0].mul_(100.0)  # garbage in the trash page must never contribute
    vp[0].mul_(100.0)
    perm = torch.randperm(nb - 1, generator=g, device="cuda")[: b * n_pages] + 1
    pt = perm.reshape(b, n_pages).to(torch.int32)
    cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
    for i in range(b):  # table entries past cur_len point at trash
        pt[i, int(cur[i]) // bs + 1:] = 0
    if trash_row is not None:  # a shielded / free slot
        pt[trash_row] = 0
        cl[trash_row] = 0
    return q, kp.to(dtype), vp.to(dtype), pt.contiguous(), cl


def draft_case(dtype, cur, t, *, trash_row=None, seed=0, b=4, h=32, hkv=8, hd=128,
               bs=16, n_pages=9):
    """A (B, T, H, hd) draft block per row at positions cur..cur+T-1, its
    pages in the table (a block may run past the table, into trash)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    nb = 1 + b * n_pages
    q = torch.randn((b, t, h, hd), generator=g, device="cuda").to(dtype)
    kp = torch.randn((nb, bs, hkv, hd), generator=g, device="cuda")
    vp = torch.randn((nb, bs, hkv, hd), generator=g, device="cuda")
    perm = torch.randperm(nb - 1, generator=g, device="cuda")[: b * n_pages] + 1
    pt = perm.reshape(b, n_pages).to(torch.int32)
    cl = torch.tensor(cur, dtype=torch.int32, device="cuda")
    for i in range(b):  # table entries past the block point at trash
        pt[i, (int(cur[i]) + t - 1) // bs + 1:] = 0
    if trash_row is not None:  # a shielded / free slot
        pt[trash_row] = 0
        cl[trash_row] = 0
    return q, kp.to(dtype), vp.to(dtype), pt.contiguous(), cl


def quantized(pool, kv_dtype):
    """(codes, (num_blocks, Hkv) f32 scales) of a full-precision pool."""
    from repro_torch.kernels import quant

    scale = quant.scales_of(pool.float(), kv_dtype)
    return quant.quantize(pool.float(), scale, kv_dtype), scale


def paged_bytes_flops(q, kp, pt, cl, window, *, scales=False):
    """Bytes and flops the function needs: q read and the output written
    once, the table and lengths, the K and V values (or codes) of positions
    lo..cur_len+T-1 only (clipped to the table), and for a quantized pool
    two f32 scales per page read per kv head.  T = 1 for a (B, H, hd) q."""
    t = q.shape[1] if q.dim() == 4 else 1
    bs, hkv, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    s_max = pt.shape[1] * bs
    rows = pages = keys = 0
    for c in cl.tolist():
        lo = max(0, c - window + 1) if window else 0
        hi = min(c + t - 1, s_max - 1)
        rows += hi - lo + 1
        pages += hi // bs - lo // bs + 1
        for i in range(t):  # query i sees positions lo_i..cur+i
            lo_i = max(0, c + i - window + 1) if window else 0
            keys += min(c + i, s_max - 1) - lo_i + 1
    nbytes = (2 * q.numel() * q.element_size() + pt.numel() * 4 + cl.numel() * 4
              + 2 * rows * hkv * hd * kp.element_size() + (2 * pages * hkv * 4 if scales else 0))
    return nbytes, 4.0 * keys * q.shape[-2] * hd


def flash_case(dtype, sq, q_offset, *, seed=0, h=32, hkv=8, hd=128):
    g = torch.Generator(device="cuda").manual_seed(seed)
    sk = q_offset + sq
    q = torch.randn((1, sq, h, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((1, sk, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((1, sk, hkv, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


def flash_bytes_flops(q, k, q_offset, window):
    sq, h, hd = q.shape[1], q.shape[2], q.shape[3]
    keys = 0
    for i in range(sq):
        qpos = q_offset + i
        keys += qpos + 1 - (max(0, qpos - window + 1) if window else 0)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4.0 * keys * h * hd


def held(res, name, dtype, label, got, want, tol: float | None = None) -> None:
    """Check one kernel output against its plain version (tolerance
    ``tol``, by default ``TOL[dtype]``); keep the worst error of ``name``."""
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype] if tol is None else tol
    check(bool(torch.isfinite(got).all()), f"{name} {dtype} {label}: non-finite")
    check(err <= tol, f"{name} {dtype} {label}: max abs err {err} > {tol}")
    res[name]["err"] = max(res[name]["err"], err)
    print(f"[kernels] {name} {str(dtype):14s} {label}: max abs err {err:.3e} "
          f"(tol {tol:.3e})")


def ssd_case(dtype, b, s, *, init, seed=0, h=80, p=64, n=128):
    """Mamba2 SSD inputs at the full config's widths: x (b, s, H, P), dt =
    softplus of a normal, a = -exp(linspace(-1, 1, H)), B/C scaled normals,
    and a random initial state or none."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device="cuda"))
    a = -torch.exp(torch.linspace(-1.0, 1.0, h, device="cuda"))
    bm = (0.3 * torch.randn((b, s, n), generator=g, device="cuda")).to(dtype)
    cm = (0.3 * torch.randn((b, s, n), generator=g, device="cuda")).to(dtype)
    st = torch.randn((b, h, p, n), generator=g, device="cuda") if init else None
    return x, dt, a, bm, cm, st


def ssd_bytes_flops(x, bm, chunk, init):
    """Bytes: x, dt, a, B, C and the initial state read once, y and the
    final state written once.  Operations (what the chunked algorithm
    needs on these inputs): per batch row, the causal half of each chunk's
    C B^T (shared by the heads); per head, the decayed scores times x, the
    carried state's term and the state update."""
    b, s, h, p = x.shape
    n = bm.shape[-1]
    e = x.element_size()
    state = b * h * p * n * 4
    nbytes = (2 * x.numel() * e + b * s * h * 4 + h * 4 + 2 * bm.numel() * e
              + (state if init else 0) + state)
    pairs = 0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        pairs += q * (q + 1) // 2
    flops = b * (2.0 * pairs * n + h * (2.0 * pairs * p + 4.0 * s * p * n))
    return nbytes, flops


DRAFT_CASES = [dict(t=5, cur=[139, 111, 88, 76]),  # the verify step's shapes
               dict(t=2, cur=[0, 15, 16, 100], trash_row=0),
               dict(t=5, cur=[14, 30, 60, 141]),  # page edges; row 3 runs past the table
               dict(t=5, cur=[139, 111, 88, 0], window=32, softcap=30.0, trash_row=3),
               dict(t=17, cur=[120, 100, 64, 3]),  # 68 rows: two row tiles
               dict(t=5, cur=[139, 111, 88, 76], h=8),  # g = 1
               dict(t=5, cur=[139, 111, 88, 76], h=64),  # g = 8
               dict(t=5, cur=[60, 33, 17, 0], hd=64),
               dict(t=5, cur=[139, 111, 88, 76], hd=256),
               # every split but the last behind the window
               dict(t=5, cur=[139, 130, 127, 100], window=16)]
LONG_CUR, LONG_PAGES = [2043, 2027, 2011, 1995], 128  # the long-context timing shape
SINGLE_QUANT_CASES = [dict(t=1, cur=[143, 100, 15, 16]),
                      dict(t=1, cur=[0, 15, 16, 100], trash_row=0, window=32),
                      dict(t=1, cur=[143, 100, 15, 0], softcap=30.0, trash_row=3)]


def sdpa_paged(q, kp, vp, pt, cl, scale, k_scale=None, v_scale=None):
    """The library yardstick of a paged entry: one SDPA call over the
    context gathered (and dequantized) beforehand, with the per-query
    position mask; returns the call to time.  The port never calls it."""
    import torch.nn.functional as F

    b, n_pages = pt.shape
    bs, hkv, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    pt_l = pt.long()

    def ctx(pool, sc):
        x = pool[pt_l].float() * sc[pt_l][:, :, None, :, None] if sc is not None else pool[pt_l]
        return x.to(q.dtype).reshape(b, n_pages * bs, hkv, hd).transpose(1, 2).contiguous()
    kc, vc = ctx(kp, k_scale), ctx(vp, v_scale)
    q4 = q[:, None] if q.dim() == 3 else q  # (B, T, H, hd)
    t = q4.shape[1]
    qpos = cl.long()[:, None] + torch.arange(t, device="cuda")[None, :]
    mask = (torch.arange(n_pages * bs, device="cuda")[None, None, :] <= qpos[:, :, None])
    qt = q4.transpose(1, 2).contiguous()
    return lambda: F.scaled_dot_product_attention(qt, kc, vc, attn_mask=mask[:, None],
                                                  scale=scale, enable_gqa=True)


def phase_kernels() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_chunk as SSD

    scale = 1.0 / math.sqrt(128)
    res = {name: {"err": 0.0} for name in KERNELS}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [dict(cur=[0, 15, 16, 100], trash_row=0),
                 dict(cur=[143, 100, 15, 16]),
                 dict(cur=[143, 100, 15, 16], window=32),
                 dict(cur=[143, 100, 15, 0], softcap=30.0, trash_row=3)]
        for i, c in enumerate(cases):
            kw = {k: c[k] for k in ("window", "softcap") if k in c}
            q, kp, vp, pt, cl = paged_case(dtype, c["cur"], trash_row=c.get("trash_row"),
                                           seed=i)
            held(res, "paged_attention", dtype, str(c),
                 ops.paged_attention(q, kp, vp, pt, cl, **kw),
                 PA.paged_attention_plain(q, kp, vp, pt, cl, scale=scale, **kw))
        for i, c in enumerate(DRAFT_CASES):
            kw = {k: c[k] for k in ("window", "softcap") if k in c}
            shape = {k: c[k] for k in ("h", "hd") if k in c}
            sc = 1.0 / math.sqrt(c.get("hd", 128))
            q, kp, vp, pt, cl = draft_case(dtype, c["cur"], c["t"],
                                           trash_row=c.get("trash_row"), seed=10 + i, **shape)
            held(res, "paged_attention_multi", dtype, str(c),
                 ops.paged_attention_multi(q, kp, vp, pt, cl, **kw),
                 PA.paged_attention_multi_plain(q, kp, vp, pt, cl, scale=sc, **kw))
            for kd in ("int8", "fp8"):
                (kc, ks), (vc, vs) = quantized(kp, kd), quantized(vp, kd)
                held(res, "paged_attention_multi_quant", dtype, f"{kd} {c}",
                     ops.paged_attention_multi_quant(q, kc, vc, ks, vs, pt, cl, **kw),
                     PA.paged_attention_multi_quant_plain(q, kc, vc, ks, vs, pt, cl,
                                                          scale=sc, **kw))
        for i, c in enumerate(SINGLE_QUANT_CASES):
            kw = {k: c[k] for k in ("window", "softcap") if k in c}
            q, kp, vp, pt, cl = paged_case(dtype, c["cur"], trash_row=c.get("trash_row"),
                                           seed=20 + i)
            for kd in ("int8", "fp8"):
                (kc, ks), (vc, vs) = quantized(kp, kd), quantized(vp, kd)
                held(res, "paged_attention_quant", dtype, f"{kd} {c}",
                     ops.paged_attention_quant(q, kc, vc, ks, vs, pt, cl, **kw),
                     PA.paged_attention_quant_plain(q, kc, vc, ks, vs, pt, cl, scale=scale,
                                                    **kw))
        if dtype == torch.bfloat16:  # P over code pools at f32 accuracy
            for kd in ("int8", "fp8"):
                for t in (1, 5):
                    qc, kc, vc, ks, vs, ptc, clc = (
                        x.cuda() for x in ref.cancelling_quant_case(3, t, kd))
                    qc = qc.to(dtype)
                    name, fn, plain = ("paged_attention_multi_quant",
                                       ops.paged_attention_multi_quant,
                                       PA.paged_attention_multi_quant_plain)
                    if t == 1:
                        qc = qc[:, 0].contiguous()
                        name, fn, plain = ("paged_attention_quant", ops.paged_attention_quant,
                                           PA.paged_attention_quant_plain)
                    held(res, name, dtype, f"{kd} cancelling V codes, q_len {t}",
                         fn(qc, kc, vc, ks, vs, ptc, clc),
                         plain(qc, kc, vc, ks, vs, ptc, clc, scale=scale), P_CODES_TOL)
        for i, (sq, off, kw) in enumerate([(64, 0, {}), (64, 64, {}), (36, 64, {}),
                                           (64, 64, dict(window=32, softcap=30.0)),
                                           (64, LONG_Q_OFFSET, {}),
                                           (37, LONG_Q_OFFSET, dict(window=700))]):
            q, k, v = flash_case(dtype, sq, off, seed=i)
            held(res, "flash_attention", dtype, f"Sq={sq} q_offset={off} {kw}",
                 ops.flash_attention(q, k, v, q_offset=off, **kw),
                 FA.flash_attention_plain(q, k, v, scale=scale, q_offset=off, **kw))
        # The SSD scan: the serve's 64-token chunk, its tails of 36 and 13,
        # two full Q = 256 chunks, and 256 + a 44-token tail.
        for i, (b, s_len, chunk, init) in enumerate(
                [(1, 64, 256, True), (1, 64, 256, False), (4, 64, 256, True),
                 (1, 36, 256, True), (4, 13, 256, False), (1, 512, 256, True),
                 (4, 512, 256, False), (1, 300, 256, False), (4, 300, 256, True)]):
            x, dt_, a, bm, cm, st = ssd_case(dtype, b, s_len, init=init, seed=30 + i)
            y, fs = SSD.ssd_chunked(x, dt_, a, bm, cm, chunk=chunk, init_state=st)
            y_p, fs_p = SSD.ssd_chunked_plain(x, dt_, a, bm, cm, chunk=chunk, init_state=st)
            label = f"b={b} S={s_len} chunk={chunk} init={'random' if init else 'zero'}"
            held(res, "ssd", dtype, label + " y", y, y_p,
                 SSD_RTOL[dtype] * max(1.0, y_p.float().abs().max().item()))
            held(res, "ssd", torch.float32, label + " final state", fs, fs_p,
                 SSD_RTOL[torch.float32] * max(1.0, fs_p.abs().max().item()))

    # Times at the main path's shapes, bf16, 4 slots, 9 pages of 16: a decode
    # tick (cur_len 143/115/92/80), a verify tick (5 tokens from cur_len
    # 139/111/88/76), each over bf16 pages and over int8 codes (fp8 printed
    # beside); a 64-token chunk at q_offset 64 (a 128-token prompt's second).
    dt = torch.bfloat16
    q, kp, vp, pt, cl = paged_case(dt, [143, 115, 92, 80], seed=9)
    qm, kpm, vpm, ptm, clm = draft_case(dt, [139, 111, 88, 76], 5, seed=9)
    timed = {
        "paged_attention": (lambda: ops.paged_attention(q, kp, vp, pt, cl),
                            lambda: PA.paged_attention_plain(q, kp, vp, pt, cl, scale=scale),
                            sdpa_paged(q, kp, vp, pt, cl, scale),
                            paged_bytes_flops(q, kp, pt, cl, 0)),
        "paged_attention_multi": (
            lambda: ops.paged_attention_multi(qm, kpm, vpm, ptm, clm),
            lambda: PA.paged_attention_multi_plain(qm, kpm, vpm, ptm, clm, scale=scale),
            sdpa_paged(qm, kpm, vpm, ptm, clm, scale),
            paged_bytes_flops(qm, kpm, ptm, clm, 0)),
    }
    fp8_ms = {}
    for kd in ("int8", "fp8"):
        (kc, ks), (vc, vs) = quantized(kp, kd), quantized(vp, kd)
        (kcm, ksm), (vcm, vsm) = quantized(kpm, kd), quantized(vpm, kd)
        entries = {
            "paged_attention_quant": (
                lambda kc=kc, vc=vc, ks=ks, vs=vs: ops.paged_attention_quant(
                    q, kc, vc, ks, vs, pt, cl),
                lambda kc=kc, vc=vc, ks=ks, vs=vs: PA.paged_attention_quant_plain(
                    q, kc, vc, ks, vs, pt, cl, scale=scale),
                sdpa_paged(q, kc, vc, pt, cl, scale, ks, vs),
                paged_bytes_flops(q, kc, pt, cl, 0, scales=True)),
            "paged_attention_multi_quant": (
                lambda kc=kcm, vc=vcm, ks=ksm, vs=vsm: ops.paged_attention_multi_quant(
                    qm, kc, vc, ks, vs, ptm, clm),
                lambda kc=kcm, vc=vcm, ks=ksm, vs=vsm: PA.paged_attention_multi_quant_plain(
                    qm, kc, vc, ks, vs, ptm, clm, scale=scale),
                sdpa_paged(qm, kcm, vcm, ptm, clm, scale, ksm, vsm),
                paged_bytes_flops(qm, kcm, ptm, clm, 0, scales=True)),
        }
        if kd == "int8":
            timed.update(entries)
        else:
            fp8_ms = {name: device_ms(fns[0], iters=QUEUED) for name, fns in entries.items()}

    qf, kf, vf = flash_case(dt, 64, 64, seed=9)
    timed["flash_attention"] = (
        lambda: ops.flash_attention(qf, kf, vf, q_offset=64),
        lambda: FA.flash_attention_plain(qf, kf, vf, scale=scale, q_offset=64),
        sdpa_prefill(qf, kf, vf, 64, scale), flash_bytes_flops(qf, kf, 64, 0))
    # The SSD scan as a prefill chunk of the serve runs it: b=1, a 64-token
    # chunk, the carried state in; no single PyTorch call computes it.
    xs, dts, as_, bs_, cs_, sts = ssd_case(dt, 1, 64, init=True, seed=9)
    timed["ssd"] = (
        lambda: SSD.ssd_chunked(xs, dts, as_, bs_, cs_, chunk=256, init_state=sts),
        lambda: SSD.ssd_chunked_plain(xs, dts, as_, bs_, cs_, chunk=256, init_state=sts),
        None, ssd_bytes_flops(xs, bs_, 64, True))
    for name, (kern, plain, lib, (nbytes, flops)) in timed.items():
        r = res[name]
        r["ms"], r["plain_ms"] = device_ms(kern, iters=QUEUED), time_ms(plain)
        r["library_ms"] = device_ms(lib, iters=QUEUED) if lib is not None else None
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, dt)
        lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        print(f"[kernels] {name}: kernel {r['ms']:.4f} ms ({time_ms(kern):.4f} ms as the host "
              f"issues it), plain {r['plain_ms']:.4f} ms, "
              f"library {lib_ms}, bound {r['bound_ms']:.6f} ms "
              f"({r['bound_by']}, {nbytes} bytes, {flops:.0f} flops)"
              + (f"; fp8 codes: kernel {fp8_ms[name]:.4f} ms" if name in fp8_ms else "")
              + (f"; {split_plan(qm if 'multi' in name else q, kp, pt)}"
                 if name.startswith("paged") else "")
              + (f"; {flash_plan(qf, kf)}" if name == "flash_attention" else ""))
    long_context(scale)
    prefill_long_context(scale)
    return res


def split_plan(q, kp, pt) -> str:
    """The split body's split count and grid for these inputs (q (B, H, hd)
    of a single-token call, or (B, T, H, hd))."""
    from repro_torch.kernels import paged_attention as PA

    t = q.shape[1] if q.dim() == 4 else 1
    p = PA.plan_split(q.shape[0], kp.shape[2], t, q.shape[-2] // kp.shape[2], pt.shape[1],
                      q.shape[-1])
    return (f"{p.n_splits} splits of {p.pages_per_split} pages, {p.tiles} row tile(s) of "
            f"{p.tile_rows}, grid {p.grid} = {p.blocks} blocks")


def sdpa_prefill(q, k, v, q_offset, scale):
    """SDPA over a prefill chunk (the yardstick of the prefill kernel): q
    at positions q_offset.., the causal mask as a boolean matrix, GQA by
    SDPA's own enable_gqa, heads-first copies made once outside the call."""
    import torch.nn.functional as F

    sq, sk = q.shape[1], k.shape[1]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    mask = (torch.arange(q_offset, q_offset + sq, device="cuda")[:, None]
            >= torch.arange(sk, device="cuda")[None, :])
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                                  enable_gqa=True)


def flash_plan(q, k) -> str:
    """The prefill kernel's plan for these inputs: body, tiling, grid."""
    from repro_torch.kernels import flash_attention as FA

    p = FA.plan_flash(q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], q.dtype)
    return (f"plan: {p.body} body, {p.key_splits} key split(s) a block of {p.warps} warps, "
            f"{p.key_tile}-key softmax steps, grid {p.grid} = {p.blocks} blocks")


def prefill_long_context(scale) -> None:
    """The prefill kernel, bf16, at the serve's chunk (Sq 64 at q_offset 64)
    and at a long context (Sq 64 at q_offset LONG_Q_OFFSET), beside SDPA and
    the bound, each first held against the plain version.  Printed only:
    the kernels JSON keeps the serve shape's numbers."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops

    dt = torch.bfloat16
    for off in (64, LONG_Q_OFFSET):
        q, k, v = flash_case(dt, 64, off, seed=7)
        want = FA.flash_attention_plain(q, k, v, scale=scale, q_offset=off)
        nbytes, flops = flash_bytes_flops(q, k, off, 0)
        b_ms, b_by = bound(nbytes, flops, dt)
        lib_ms = device_ms(sdpa_prefill(q, k, v, off, scale), iters=QUEUED)
        kern = functools.partial(ops.flash_attention, q, k, v, scale=scale, q_offset=off)
        got = kern()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        check(err <= TOL[dt], f"flash_attention q_offset {off}: {err}")
        ms = device_ms(kern, iters=QUEUED)
        print(f"[kernels] flash_attention Sq=64 q_offset={off} (Sk {off + 64}): "
              f"kernel {ms:.4f} ms, library {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
              f"bound {b_ms:.6f} ms ({b_by}, {nbytes} bytes, {flops:.0f} flops), "
              f"{ms / b_ms:.1f}x bound; max abs err {err:.3e}; {flash_plan(q, k)}")


def long_context(scale) -> None:
    """The four paged entries at a long context, bf16: B = 4, one token
    (single-token entries) or T = 5 (draft-block entries) from cur_len
    LONG_CUR over LONG_PAGES pages of 16 (bf16 pages, then int8 and fp8
    codes), each time beside its bound and the SDPA yardstick.  Printed
    only: the kernels JSON keeps the serving shapes' numbers."""
    from repro_torch.kernels import ops

    dt = torch.bfloat16
    runs = []
    for t, entry in ((1, "paged_attention"), (5, "paged_attention_multi")):
        q, kp, vp, pt, cl = draft_case(dt, LONG_CUR, t, seed=8, n_pages=LONG_PAGES)
        if t == 1:
            q = q[:, 0].contiguous()
            fn, qfn = ops.paged_attention, ops.paged_attention_quant
        else:
            fn, qfn = ops.paged_attention_multi, ops.paged_attention_multi_quant
        runs.append((entry, t, "bf16 pages", lambda q=q, kp=kp, vp=vp, pt=pt, cl=cl, fn=fn:
                     fn(q, kp, vp, pt, cl), sdpa_paged(q, kp, vp, pt, cl, scale),
                     paged_bytes_flops(q, kp, pt, cl, 0), split_plan(q, kp, pt)))
        for kd in ("int8", "fp8"):
            (kc, ks), (vc, vs) = quantized(kp, kd), quantized(vp, kd)
            runs.append((entry + "_quant", t, f"{kd} codes",
                         lambda q=q, kc=kc, vc=vc, ks=ks, vs=vs, pt=pt, cl=cl, qfn=qfn:
                         qfn(q, kc, vc, ks, vs, pt, cl),
                         sdpa_paged(q, kc, vc, pt, cl, scale, ks, vs),
                         paged_bytes_flops(q, kc, pt, cl, 0, scales=True),
                         split_plan(q, kp, pt)))
    for name, t, label, kern, lib, (nbytes, flops), plan in runs:
        ms, lib_ms = device_ms(kern, iters=QUEUED), device_ms(lib, iters=QUEUED)
        b_ms, b_by = bound(nbytes, flops, dt)
        print(f"[kernels] {name} long context ({label}, B=4 T={t} cur_len {LONG_CUR}, "
              f"{LONG_PAGES} pages of 16): kernel {ms:.4f} ms ({time_ms(kern):.4f} ms as "
              f"the host issues it), library {lib_ms:.4f} ms, "
              f"bound {b_ms:.6f} ms ({b_by}, {nbytes} bytes), {ms / b_ms:.2f}x bound; "
              f"{plan}")


# -- phases 4 and 5: serving -------------------------------------------------------


def prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in PROMPT_LENS]


def tiled_prompts(vocab: int) -> list[np.ndarray]:
    """The same lengths, each prompt a random SEGMENT-token segment tiled,
    so that prompt lookup (the n-gram drafter) finds earlier matches."""
    rng = np.random.default_rng(2)
    return [np.resize(rng.integers(0, vocab, SEGMENT, dtype=np.int32), n)
            for n in PROMPT_LENS]


class OracleDrafter:
    """Replays known outputs (a drafter the port's engine takes through
    ``drafter=``): for a context that starts with one of ``reqs``, propose
    the next tokens of its known output."""

    def __init__(self, reqs, outs):
        self.known = [(np.asarray(p), np.asarray(o)) for p, o in zip(reqs, outs)]

    def propose(self, context, k):
        for p, out in self.known:
            if len(context) >= len(p) and np.array_equal(context[: len(p)], p):
                done = len(context) - len(p)
                return out[done: done + k].astype(np.int32)
        return np.zeros(0, np.int32)


def agreement(got, want) -> float:
    """Mean over requests of the share of equal greedy tokens."""
    return float(np.mean([np.mean(np.asarray(a) == np.asarray(b)) for a, b in zip(got, want)]))


def snapshot_prompts(vocab: int) -> list[np.ndarray]:
    """PROMPT_LENS again, every prompt longer than SNAP_HEAD starting with
    one shared SNAP_HEAD-token head (the shorter ones random)."""
    rng = np.random.default_rng(3)
    head = rng.integers(0, vocab, SNAP_HEAD, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n - SNAP_HEAD, dtype=np.int32)])
            if n > SNAP_HEAD else rng.integers(0, vocab, n, dtype=np.int32)
            for n in PROMPT_LENS]


def serve(cfg, params, device, reqs, *, drafter=None, paged=True, **extra):
    """Serve ``reqs`` on ``device`` over a paged pool (or, with
    ``paged=False``, the contiguous slot cache) with ServeConfig options
    ``extra``; returns (engine, tokens per request, admission logits per
    request, per-tick seconds, wall seconds).  The engine also keeps the
    seconds of each state snapshot it stored (its device-to-host copy) and
    of each evict and readmit (host clock around a synchronize)."""
    from repro_torch.runtime.serving import ServeConfig, StreamedBatchEngine

    class Engine(StreamedBatchEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.logits, self.ticks, self.snapshot_s = {}, [], []
            self.evict_s, self.readmit_s = [], []
            offer = self.servable.maybe_snapshot

            def timed_offer(tokens, caches, pos):
                n0 = len(self.servable.snapshots or ())
                t0 = time.perf_counter()
                offer(tokens, caches, pos)
                if len(self.servable.snapshots or ()) > n0:
                    self.snapshot_s.append(time.perf_counter() - t0)
            self.servable.maybe_snapshot = timed_offer

        def _on_admit_logits(self, uid, logits):
            self.logits[uid] = logits.float().cpu()

        def _decode_tick(self):
            t0 = time.perf_counter()
            super()._decode_tick()  # ends in the tick's device-to-host copy
            self.ticks.append(time.perf_counter() - t0)

        def _synced(self, fn, times, arg):
            if device == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(arg)
            if device == "cuda":
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            return out

        def evict(self, uid):
            return self._synced(super().evict, self.evict_s, uid)

        def readmit(self, ev):
            return self._synced(super().readmit, self.readmit_s, ev)

    max_seq = -(-(max(PROMPT_LENS) + NEW_TOKENS) // BLOCK) * BLOCK
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS,
                       max_batch=SLOTS, block_size=BLOCK, paged=paged, **extra)
    eng = Engine(cfg, params, scfg, device=device, drafter=drafter)
    t0 = time.perf_counter()
    uids = [eng.submit(p) for p in reqs]
    out = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.paged:
        check(eng.kv.pages_in_use == 0, f"{extra}: {eng.kv.pages_in_use} pages left in use")
        eng.kv.check_invariants()
    # The timing hook closes over the engine: drop it so the engine and its
    # device caches are freed as soon as the caller lets go of them (else
    # they wait for the garbage collector and inflate the next serve's peak).
    del eng.servable.maybe_snapshot
    return (eng, [out[u] for u in uids], [eng.logits[u] for u in uids], eng.ticks, wall)


def phase_card_vs_cpu() -> None:
    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(qwen3_4b.CONFIG, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    cpu_params = T.init_params(cfg, 0, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")

    reqs = prompts(cfg.vocab_size)
    _, tok_gpu, log_gpu, _, wall_gpu = serve(cfg, gpu_params, "cuda", reqs)
    _, tok_cpu, log_cpu, _, wall_cpu = serve(cfg, cpu_params, "cpu", reqs)
    worst = 0.0
    for i, (a, b) in enumerate(zip(log_gpu, log_cpu)):
        worst = max(worst, (a - b).abs().max().item())
        check(torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
              f"request {i}: card vs CPU admission logits differ by "
              f"{(a - b).abs().max().item():.3e}")
    for i, (a, b) in enumerate(zip(tok_gpu, tok_cpu)):
        check(np.array_equal(a, b), f"request {i}: card tokens {a} != CPU tokens {b}")
    print(f"[card_vs_cpu] 2-layer full-width f32: admission logits max abs diff "
          f"{worst:.3e} (atol {LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens identical "
          f"for {len(reqs)} requests x {NEW_TOKENS}; card {wall_gpu:.2f}s, cpu "
          f"{wall_cpu:.2f}s")

    # Speculative decode: n-gram drafts on tiled prompts, then an oracle
    # drafter replaying the plain serve; card == CPU == the plain serve.
    tiled = tiled_prompts(cfg.vocab_size)
    _, plain_t, _, _, _ = serve(cfg, gpu_params, "cuda", tiled)
    for label, drafter in (("n-gram", None), ("oracle", OracleDrafter(tiled, plain_t))):
        outs = {}
        for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng, outs[dev], _, _, _ = serve(cfg, p, dev, tiled, drafter=drafter,
                                            spec_decode=True, spec_k=SPEC_K)
            stats = (eng.spec_ticks, eng.decode_steps, eng.spec_accepted, eng.spec_proposed)
        for i, (a, b, c) in enumerate(zip(outs["cuda"], outs["cpu"], plain_t)):
            check(np.array_equal(a, b), f"spec {label} request {i}: card {a} != CPU {b}")
            check(np.array_equal(a, c), f"spec {label} request {i}: spec {a} != plain {c}")
        check(label != "oracle" or stats[0] > 0, "the oracle serve ran no verify tick")
        print(f"[card_vs_cpu] spec decode ({label} drafts, k={SPEC_K}, tiled prompts): "
              f"greedy tokens identical card vs CPU and equal to the plain serve; "
              f"{stats[0]} verify of {stats[1]} ticks, accepted {stats[2]}/{stats[3]}")
    for kd in ("int8", "fp8"):
        _, tg, _, _, _ = serve(cfg, gpu_params, "cuda", reqs, kv_dtype=kd)
        _, tc, _, _, _ = serve(cfg, cpu_params, "cpu", reqs, kv_dtype=kd)
        agree, vs_plain = agreement(tg, tc), agreement(tg, tok_gpu)
        check(agree >= QUANT_FLOOR, f"{kd}: card vs CPU greedy agreement {agree}")
        print(f"[card_vs_cpu] {kd} pages: card vs CPU greedy agreement {agree:.3f} "
              f"(floor {QUANT_FLOOR}); vs the f32-pool serve {vs_plain:.3f}")


def phase_card_vs_cpu_mamba() -> None:
    """mamba2-2.7b at full width cut to 2 layers, f32: contiguous, paged and
    snapshot serves on the card (SSD kernel) and on the CPU (its plain
    version)."""
    from repro_torch.configs import mamba2_2_7b
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(mamba2_2_7b.CONFIG, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    cpu_params = T.init_params(cfg, 0, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    for label, reqs, kw in (("contiguous", prompts(cfg.vocab_size), dict(paged=False)),
                            ("paged", prompts(cfg.vocab_size), dict(paged=True)),
                            ("snapshots", snapshot_prompts(cfg.vocab_size),
                             dict(paged=False, state_snapshots=True))):
        eng_g, tok_g, log_g, _, wall_g = serve(cfg, gpu_params, "cuda", reqs, **kw)
        eng_c, tok_c, log_c, _, wall_c = serve(cfg, cpu_params, "cpu", reqs, **kw)
        worst = max((a - b).abs().max().item() for a, b in zip(log_g, log_c))
        for i, (a, b) in enumerate(zip(log_g, log_c)):
            check(torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
                  f"mamba {label} request {i}: card vs CPU admission logits differ by "
                  f"{(a - b).abs().max().item():.3e}")
        for i, (a, b) in enumerate(zip(tok_g, tok_c)):
            check(np.array_equal(a, b), f"mamba {label} request {i}: card {a} != CPU {b}")
        check((eng_g.snapshot_hits, eng_g.snapshot_tokens_reused)
              == (eng_c.snapshot_hits, eng_c.snapshot_tokens_reused),
              f"mamba {label}: snapshot counters differ card vs CPU")
        check(label != "snapshots" or eng_g.snapshot_hits > 0, "no snapshot hit")
        print(f"[card_vs_cpu] mamba2 2-layer full-width f32 {label}: admission logits max "
              f"abs diff {worst:.3e} (atol {LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens "
              f"identical for {len(reqs)} requests x {NEW_TOKENS}; snapshot hits "
              f"{eng_g.snapshot_hits} ({eng_g.snapshot_tokens_reused} tokens); card "
              f"{wall_g:.2f}s, cpu {wall_c:.2f}s")


def to_device(tree, device):
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def phase_profile(cfg, params, reqs, label="plain", **kw) -> None:
    """torch.profiler over one more serve of the requests (ServeConfig
    options and drafter in ``kw``): device busy time by kernel, and the
    device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, _, wall = serve(cfg, params, "cuda", reqs, **kw)
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kern)
    groups: dict[str, float] = {}
    for name, ms, _ in kern:
        low = name.lower()
        group = ("paged_attention" if "paged_attention" in low or "combine_splits" in low else
                 "flash_attention" if "flash_attention" in low else
                 "ssd" if "ssd_chunk" in low else
                 "matmul" if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                                     "cutlass"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"[profile] {label} serve of {len(reqs)} requests: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}; paged attention "
          f"(split + combine launches) {groups.get('paged_attention', 0.0):.3f} ms; by group "
          "(ms) " + json.dumps({k: round(v, 3) for k, v in sorted(groups.items())}))
    for name, ms, n in sorted(kern, key=lambda r: -r[1])[:10]:
        print(f"[profile]   {ms:9.3f} ms  {n:6d} x  {name[:100]}")


def kernel_counters() -> dict:
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fwt as FWT
    from repro_torch.kernels import nw_tile as NW
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.kernels import streamed_matmul as MM

    return {"paged_attention": PA.KERNEL, "paged_attention_multi": PA.MULTI_KERNEL,
            "paged_attention_quant": PA.QUANT_KERNEL,
            "paged_attention_multi_quant": PA.MULTI_QUANT_KERNEL,
            "flash_attention": FA.KERNEL, "ssd": SSD.KERNEL,
            "streamed_matmul": MM.KERNEL, "fwt": FWT.KERNEL,
            "fwt_columns": FWT.COLUMNS_KERNEL, "nw_tile": NW.KERNEL}


def counted_serve(cfg, params, reqs, **kw):
    """One serve on the card with every launch count set to 0 just before
    it; returns serve()'s tuple and the counts read just after.  Checks
    that each tick and chunk launched its kernel once per layer: the
    single-token entry per plain tick, the draft-block entry per verify
    tick (the fused-dequant pair over quantized pages; none over the
    contiguous cache, whose decode is torch ops), the prefill kernel per
    chunk, and nothing else; for mamba, the SSD kernel once per layer per
    prefill chunk and nothing else."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    out = serve(cfg, params, "cuda", reqs, **kw)
    launches = {name: c.launches for name, c in counters.items()}
    eng = out[0]
    want = {name: 0 for name in counters}
    if eng.scfg.arch_kind == "mamba":
        want["ssd"] = cfg.n_layers * eng.prefill_chunks
    else:
        q = "_quant" if eng.scfg.kv_dtype != "fp32" else ""
        if eng.paged:  # contiguous decode is torch ops (decode_attention)
            want[f"paged_attention{q}"] = cfg.n_layers * (eng.decode_steps - eng.spec_ticks)
            want[f"paged_attention_multi{q}"] = cfg.n_layers * eng.spec_ticks
        want["flash_attention"] = cfg.n_layers * eng.prefill_chunks
    check(launches == want, f"{kw}: launches {launches} != {want} ({cfg.n_layers} layers "
          f"x {eng.decode_steps} ticks ({eng.spec_ticks} verify), {eng.prefill_chunks} chunks)")
    return out, launches


def phase_main_path(res: dict, *, profile: bool = False) -> tuple[dict, list, dict]:
    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T

    cfg = qwen3_4b.CONFIG
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[main] qwen3-4b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size} (padded "
          f"{cfg.padded_vocab}), bf16, {n_params / 1e9:.3f}B params, init "
          f"{time.perf_counter() - t0:.1f}s")
    reqs = prompts(cfg.vocab_size)
    serve(cfg, params, "cuda", reqs)  # warm-up: cuBLAS handles, allocator, libraries

    (eng, toks, logits, ticks, wall), launches = counted_serve(cfg, params, reqs)
    for i, (t, lg) in enumerate(zip(toks, logits)):
        check(len(t) == NEW_TOKENS, f"request {i}: {len(t)} tokens")
        check(bool(((t >= 0) & (t < cfg.padded_vocab)).all()), f"request {i}: {t}")
        check(bool(torch.isfinite(lg).all()), f"request {i}: non-finite logits")
    for name in ("paged_attention", "flash_attention"):
        check(launches[name] > 0, f"{name}: no launch on the main path")
        res[name]["launches"] = launches[name]

    # One 64-token chunk at q_offset 64 on its own, its writes routed to the
    # trash page (an all-zero table row), timed with a synchronize.
    chunk = eng.servable.chunk_fn()
    piece = torch.from_numpy(reqs[0][None, 64:128].copy()).to("cuda")
    pt = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    t_chunk = []
    for _ in range(5):
        t1 = time.perf_counter()
        chunk(eng.kv.pools, pt, piece, 64)
        torch.cuda.synchronize()
        t_chunk.append(time.perf_counter() - t1)
    n_tok = sum(len(t) for t in toks)
    e2e = {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "decode_ticks": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
           "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
           "prefill_chunk_ms": float(np.median(t_chunk[1:]) * 1e3),
           "launches": launches, "page_bytes": eng.kv.page_bytes,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[main] {len(reqs)} requests x {NEW_TOKENS} new tokens: {n_tok} tokens in "
          f"{wall:.3f}s = {e2e['tokens_per_s']:.1f} tok/s; decode tick p50 "
          f"{e2e['decode_tick_ms_p50']:.2f} ms over {eng.decode_steps} ticks; prefill "
          f"chunk (64 tokens at q_offset 64) {e2e['prefill_chunk_ms']:.2f} ms; "
          f"launches {launches} = {cfg.n_layers} x ({eng.decode_steps} ticks, "
          f"{eng.prefill_chunks} chunks)")
    print("[main] e2e " + json.dumps(e2e))
    if profile:
        phase_profile(cfg, params, reqs)

    # The same requests with speculative decode and over quantized pages.
    # Each option is served once to warm it, then measured with the launch
    # counts set to 0; its kernels' JSON launches come from its own serve.
    tiled = tiled_prompts(cfg.vocab_size)
    _, plain_tiled, _, _, _ = serve(cfg, params, "cuda", tiled)
    int8_out = []

    def int8_oracle():
        return OracleDrafter(reqs, int8_out)
    variants = [
        ("spec, oracle drafts", reqs, toks, lambda: OracleDrafter(reqs, toks),
         dict(spec_decode=True, spec_k=SPEC_K), "paged_attention_multi"),
        ("spec, n-gram drafts (tiled prompts)", tiled, plain_tiled, lambda: None,
         dict(spec_decode=True, spec_k=SPEC_K), None),
        ("int8 pages", reqs, toks, lambda: None, dict(kv_dtype="int8"),
         "paged_attention_quant"),
        ("fp8 pages", reqs, toks, lambda: None, dict(kv_dtype="fp8"), None),
        ("int8 pages + spec, oracle drafts", reqs, toks, int8_oracle,
         dict(kv_dtype="int8", spec_decode=True, spec_k=SPEC_K),
         "paged_attention_multi_quant"),
    ]
    serves = {"plain": {k: e2e[k] for k in ("tokens_per_s", "decode_tick_ms_p50",
                                            "decode_ticks", "page_bytes")}}
    for label, rq, ref_toks, drafter, kw, path in variants:
        serve(cfg, params, "cuda", rq, drafter=drafter(), **kw)  # warm-up
        (ev, tv, lv, tk, wv), lv_launch = counted_serve(cfg, params, rq, drafter=drafter(),
                                                         **kw)
        for i, (t, lg) in enumerate(zip(tv, lv)):
            check(len(t) == NEW_TOKENS and bool(((t >= 0) & (t < cfg.padded_vocab)).all()),
                  f"{label} request {i}: {t}")
            check(bool(torch.isfinite(lg).all()), f"{label} request {i}: non-finite logits")
        if kw.get("kv_dtype") == "int8" and not kw.get("spec_decode"):
            int8_out.extend(tv)
        if path is not None:
            check(lv_launch[path] > 0, f"{path}: no launch in the {label} serve")
            res[path]["launches"] = lv_launch[path]
        n = sum(len(t) for t in tv)
        rate = ev.spec_accepted / ev.spec_proposed if ev.spec_proposed else None
        serves[label] = {"tokens_per_s": n / wv, "decode_tick_ms_p50": float(np.median(tk) * 1e3),
                         "decode_ticks": ev.decode_steps, "verify_ticks": ev.spec_ticks,
                         "accepted": ev.spec_accepted, "proposed": ev.spec_proposed,
                         "acceptance": rate, "page_bytes": ev.kv.page_bytes,
                         "agreement_with_plain": agreement(tv, ref_toks),
                         "launches": lv_launch}
        print(f"[main] {label}: {n} tokens in {wv:.3f}s = {n / wv:.1f} tok/s; tick p50 "
              f"{serves[label]['decode_tick_ms_p50']:.2f} ms over {ev.decode_steps} ticks "
              f"({ev.spec_ticks} verify); acceptance "
              f"{'-' if rate is None else f'{rate:.3f}'} ({ev.spec_accepted}/"
              f"{ev.spec_proposed}); page_bytes {ev.kv.page_bytes} (bf16 "
              f"{e2e['page_bytes']}); agreement with the plain bf16 serve "
              f"{serves[label]['agreement_with_plain']:.3f}; launches {lv_launch}")
        if profile and path in ("paged_attention_multi", "paged_attention_quant"):
            phase_profile(cfg, params, rq, label, drafter=drafter(), **kw)
    print("[main] serves " + json.dumps(serves))
    return e2e, toks, params


# Pool size (blocks, trash included) that makes the serve of the 6 requests
# preempt twice: admissions and growth of PROMPT_LENS at 4 slots, pages of
# BLOCK, NEW_TOKENS each (the count depends on the lengths alone).
PRESSURE_BLOCKS = 22


def phase_cache_paths(res: dict, main: tuple, *, profile: bool = False) -> dict:
    """Phase 5b: the contiguous attention cache, scatter-after-prefill and
    page-pressure preemption.  (a) qwen3-4b at full width cut to 2 layers,
    f32, card against CPU: the contiguous and the non-fused paged serves
    (greedy tokens identical card vs CPU and to the fused paged serve,
    admission logits allclose), contiguous spec decode (n-gram and oracle
    drafts) equal to the plain contiguous serve, and a pool of
    PRESSURE_BLOCKS that preempts (same count card vs CPU, tokens of the
    unpressured serve; over int8 pages greedy agreement >= QUANT_FLOOR).
    (b) the full 36-layer bf16 qwen3-4b of phase 5 (``main``: its e2e, its
    plain paged serve's tokens and its params): the contiguous serve (flash
    launches > 0) beside the fused paged serve, and the pressured paged
    serve: >= 2 preemptions, phase 5's tokens per uid, evict / readmit
    times."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(qwen3_4b.CONFIG, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    cpu_params = T.init_params(cfg, 0, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    reqs = prompts(cfg.vocab_size)
    _, fused, _, _, _ = serve(cfg, gpu_params, "cuda", reqs)
    for label, kw in (("contiguous", dict(paged=False)),
                      ("non-fused paged", dict(fused_prefill=False))):
        _, tok_g, log_g, _, wall_g = serve(cfg, gpu_params, "cuda", reqs, **kw)
        _, tok_c, log_c, _, wall_c = serve(cfg, cpu_params, "cpu", reqs, **kw)
        worst = max((a - b).abs().max().item() for a, b in zip(log_g, log_c))
        for i, (a, b) in enumerate(zip(log_g, log_c)):
            check(torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
                  f"{label} request {i}: card vs CPU admission logits differ by "
                  f"{(a - b).abs().max().item():.3e}")
        for i, (a, b, c) in enumerate(zip(tok_g, tok_c, fused)):
            check(np.array_equal(a, b), f"{label} request {i}: card {a} != CPU {b}")
            check(np.array_equal(a, c), f"{label} request {i}: {a} != fused paged {c}")
        print(f"[cache] 2-layer full-width f32 {label}: admission logits max abs diff "
              f"{worst:.3e} (atol {LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens identical "
              f"card vs CPU and to the fused paged serve for {len(reqs)} requests x "
              f"{NEW_TOKENS}; card {wall_g:.2f}s, cpu {wall_c:.2f}s")
    tiled = tiled_prompts(cfg.vocab_size)
    _, plain_t, _, _, _ = serve(cfg, gpu_params, "cuda", tiled, paged=False)
    for label, drafter in (("n-gram", None), ("oracle", OracleDrafter(tiled, plain_t))):
        outs = {}
        for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
            eng, outs[dev], _, _, _ = serve(cfg, p, dev, tiled, drafter=drafter, paged=False,
                                            spec_decode=True, spec_k=SPEC_K)
        for i, (a, b, c) in enumerate(zip(outs["cuda"], outs["cpu"], plain_t)):
            check(np.array_equal(a, b), f"contiguous spec {label} request {i}: card {a} != "
                  f"CPU {b}")
            check(np.array_equal(a, c), f"contiguous spec {label} request {i}: {a} != {c}")
        check(label != "oracle" or eng.spec_ticks > 0, "the oracle serve ran no verify tick")
        print(f"[cache] contiguous spec decode ({label} drafts, k={SPEC_K}, tiled prompts): "
              f"greedy tokens identical card vs CPU and equal to the plain contiguous serve; "
              f"{eng.spec_ticks} verify of {eng.decode_steps} ticks, accepted "
              f"{eng.spec_accepted}/{eng.spec_proposed}")
    for kd in ("fp32", "int8"):
        eg, tg, _, _, wg = serve(cfg, gpu_params, "cuda", reqs, kv_dtype=kd,
                                 num_blocks=PRESSURE_BLOCKS)
        ec, tc, _, _, wc = serve(cfg, cpu_params, "cpu", reqs, kv_dtype=kd,
                                 num_blocks=PRESSURE_BLOCKS)
        check(eg.preemptions >= 1 and eg.preemptions == ec.preemptions,
              f"{kd} pool of {PRESSURE_BLOCKS} blocks: preemptions card {eg.preemptions}, "
              f"CPU {ec.preemptions}")
        agree = agreement(tg, tc)
        if kd == "fp32":
            for i, (a, b, c) in enumerate(zip(tg, tc, fused)):
                check(np.array_equal(a, b), f"pressured request {i}: card {a} != CPU {b}")
                check(np.array_equal(a, c), f"pressured request {i}: {a} != unpressured {c}")
        else:
            check(agree >= QUANT_FLOOR, f"pressured {kd}: card vs CPU agreement {agree}")
        print(f"[cache] {kd} pool of {PRESSURE_BLOCKS} blocks: {eg.preemptions} preemptions "
              f"on the card and on the CPU; card vs CPU greedy agreement {agree:.3f}"
              + ("; tokens equal to the unpressured serve" if kd == "fp32" else
                 f" (floor {QUANT_FLOOR}); vs the unpressured f32 serve "
                 f"{agreement(tg, fused):.3f}") + f"; card {wg:.2f}s, cpu {wc:.2f}s")
    del gpu_params

    # (b) full width, bf16.
    e2e, paged_toks, params = main
    cfg = qwen3_4b.CONFIG
    reqs = prompts(cfg.vocab_size)
    out = {"fused paged (phase 5)": {k: e2e[k] for k in ("tokens_per_s", "decode_tick_ms_p50",
                                                          "decode_ticks")}}
    for label, kw in (("contiguous", dict(paged=False)),
                      (f"paged, {PRESSURE_BLOCKS} blocks", dict(num_blocks=PRESSURE_BLOCKS))):
        serve(cfg, params, "cuda", reqs, **kw)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        (eng, toks, logits, ticks, wall), launches = counted_serve(cfg, params, reqs, **kw)
        for i, (t, lg) in enumerate(zip(toks, logits)):
            check(len(t) == NEW_TOKENS and bool(((t >= 0) & (t < cfg.padded_vocab)).all()),
                  f"{label} request {i}: {t}")
            check(bool(torch.isfinite(lg).all()), f"{label} request {i}: non-finite logits")
        check(launches["flash_attention"] > 0, f"{label}: no flash_attention launch")
        for name, n in launches.items():
            if n:  # this path's launches join phase 5's in the kernels line
                res[name]["launches"] += n
        n = sum(len(t) for t in toks)
        row = {"tokens_per_s": n / wall, "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
               "decode_ticks": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
               "agreement_with_fused_paged": agreement(toks, paged_toks),
               "launches": launches, "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        if eng.paged:
            check(eng.preemptions >= 2, f"{label}: {eng.preemptions} preemptions, want >= 2")
            for i, (a, b) in enumerate(zip(toks, paged_toks)):
                check(np.array_equal(a, b), f"{label} request {i}: {a} != unpressured {b}")
            check(eng.kv.pages_in_use == 0, f"{label}: pages left in use")
            eng.kv.check_invariants()
            row.update(num_blocks=PRESSURE_BLOCKS, preemptions=eng.preemptions,
                       evict_ms=[x * 1e3 for x in eng.evict_s],
                       readmit_ms=[x * 1e3 for x in eng.readmit_s],
                       peak_pages=eng.kv.peak_pages_in_use)
        out[label] = row
        print(f"[cache] {label}: {n} tokens in {wall:.3f}s = {n / wall:.1f} tok/s (fused paged, "
              f"phase 5: {e2e['tokens_per_s']:.1f}); tick p50 {row['decode_tick_ms_p50']:.2f} "
              f"ms over {eng.decode_steps} ticks (phase 5: {e2e['decode_tick_ms_p50']:.2f} ms "
              f"over {e2e['decode_ticks']}); {eng.prefill_chunks} chunks; agreement with the "
              f"fused paged serve {row['agreement_with_fused_paged']:.3f}; launches "
              f"{launches}; peak {row['peak_mem_gb']:.2f} GB"
              + (f"; num_blocks {PRESSURE_BLOCKS}: {eng.preemptions} preemptions, tokens "
                 f"equal to the unpressured serve, evict ms "
                 f"{[round(x, 3) for x in row['evict_ms']]}, readmit ms "
                 f"{[round(x, 3) for x in row['readmit_ms']]}" if eng.paged else ""))
        if not eng.paged:
            # The fused paged serve again, right after the contiguous one:
            # host-bound serves move between calls, so the two are compared
            # in turns (phase 5's paged serve, contiguous, this one).
            _, tp, _, kp, wp = serve(cfg, params, "cuda", reqs)
            out["fused paged (after contiguous)"] = {
                "tokens_per_s": sum(len(t) for t in tp) / wp,
                "decode_tick_ms_p50": float(np.median(kp) * 1e3), "decode_ticks": len(kp)}
            print(f"[cache] fused paged again: {out['fused paged (after contiguous)']}")
            if profile:
                phase_profile(cfg, params, reqs, "contiguous", **kw)
    print("[cache] serves " + json.dumps(out))
    return out


def phase_main_mamba(res: dict, *, profile: bool = False) -> dict:
    """The full 64-layer bf16 mamba2-2.7b: the 6 requests over a contiguous
    slot cache and beside a paged pool, then head-sharing prompts without
    and with state snapshots, each warmed once and measured with the launch
    counts at 0."""
    from repro_torch.configs import mamba2_2_7b
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import ServingEngine

    cfg = mamba2_2_7b.CONFIG
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[mamba] mamba2-2.7b: {cfg.n_layers} layers, d_model {cfg.d_model}, ssm_state "
          f"{cfg.ssm_state}, headdim {cfg.mamba_headdim}, ssd_chunk {cfg.ssd_chunk}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab}), bf16, {n_params / 1e9:.3f}B params, "
          f"init {time.perf_counter() - t0:.1f}s")
    reqs, shared = prompts(cfg.vocab_size), snapshot_prompts(cfg.vocab_size)
    out = {}
    runs = [("contiguous", reqs, dict(paged=False)), ("paged", reqs, dict(paged=True)),
            ("shared heads, no snapshots", shared, dict(paged=False)),
            ("shared heads, snapshots", shared, dict(paged=False, state_snapshots=True))]
    for label, rq, kw in runs:
        serve(cfg, params, "cuda", rq, **kw)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        (eng, toks, logits, ticks, wall), launches = counted_serve(cfg, params, rq, **kw)
        for i, (t, lg) in enumerate(zip(toks, logits)):
            check(len(t) == NEW_TOKENS and bool(((t >= 0) & (t < cfg.padded_vocab)).all()),
                  f"mamba {label} request {i}: {t}")
            check(bool(torch.isfinite(lg).all()), f"mamba {label} request {i}: non-finite")
        check(launches["ssd"] == cfg.n_layers * eng.prefill_chunks > 0,
              f"mamba {label}: ssd launches {launches['ssd']}")
        n = sum(len(t) for t in toks)
        out[label] = {"toks": toks, "tokens_per_s": n / wall, "wall_s": wall,
                      "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
                      "decode_ticks": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
                      "snapshot_hits": eng.snapshot_hits,
                      "snapshot_tokens_reused": eng.snapshot_tokens_reused,
                      "snapshot_copy_ms": [x * 1e3 for x in eng.snapshot_s],
                      "launches": launches,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"[mamba] {label}: {n} tokens in {wall:.3f}s = {n / wall:.1f} tok/s; tick p50 "
              f"{out[label]['decode_tick_ms_p50']:.2f} ms over {eng.decode_steps} ticks; "
              f"{eng.prefill_chunks} prefill chunks; snapshot hits {eng.snapshot_hits} "
              f"({eng.snapshot_tokens_reused} tokens reused), snapshot copies (ms) "
              f"{[round(x, 2) for x in out[label]['snapshot_copy_ms']]}; launches {launches}; "
              f"peak {out[label]['peak_mem_gb']:.2f} GB")
        if label == "contiguous":
            res["ssd"]["launches"] = launches["ssd"]
            if profile:
                phase_profile(cfg, params, rq, "mamba contiguous", **kw)
    check(all(np.array_equal(a, b) for a, b in zip(out["contiguous"]["toks"],
                                                   out["paged"]["toks"])),
          "mamba: the paged serve's tokens differ from the contiguous serve's")
    snap = out["shared heads, snapshots"]
    check(snap["snapshot_hits"] == 3, f"mamba: snapshot hits {snap['snapshot_hits']} != 3")
    check(all(np.array_equal(a, b) for a, b in zip(snap["toks"],
                                                   out["shared heads, no snapshots"]["toks"])),
          "mamba: snapshot serve tokens differ from the same prompts served without")

    # One 64-token prefill chunk at position 64 over a b=1 cache, synchronized.
    single = ServingEngine(cfg, params, eng.scfg, device="cuda",
                           unembed=T.unembed_f32(cfg, params))
    piece = torch.from_numpy(reqs[0][None].copy()).to("cuda")
    t_chunk = []
    for _ in range(6):
        chunks = single.iter_prefill_chunks(piece)
        next(chunks)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        next(chunks)
        torch.cuda.synchronize()
        t_chunk.append(time.perf_counter() - t1)
    summary = {k: {f: v for f, v in r.items() if f != "toks"} for k, r in out.items()}
    summary["prefill_chunk_ms"] = float(np.median(t_chunk[1:]) * 1e3)
    print(f"[mamba] prefill chunk (64 tokens at position 64, b=1) "
          f"{summary['prefill_chunk_ms']:.2f} ms")
    print("[mamba] serves " + json.dumps(summary))
    return summary


# -- phases 3, 4 and 7: the paper's streaming path ------------------------------------

NW_N, NW_BLOCK = 2048, 32  # the path's NW task: 64 x 64 tiles of 32, one launch


def dna_scores(n: int, m: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 4, n), rng.integers(0, 4, m)
    return np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32)


def paper_held(res, name, dtype, label, got, want, rtol) -> None:
    held(res, name, dtype, label, got, want, rtol * max(1.0, want.float().abs().max().item()))


def phase_paper_kernels(res: dict) -> None:
    """The streamed matmul, the FWT passes and the NW tile kernel against
    their plain versions at the streaming path's shapes, and their times."""
    from repro_torch.core import wavefront
    from repro_torch.kernels import fwt as FWT
    from repro_torch.kernels import nw_tile as NW
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import streamed_matmul as MM

    g = torch.Generator(device="cuda").manual_seed(40)
    f32, bf16 = torch.float32, torch.bfloat16
    for dx, dy in ((f32, f32), (bf16, bf16), (f32, bf16)):
        for m, k, n in ((2048, 2048, 2048), (129, 257, 130), (1, 1000, 3),
                        (2047, 33, 2049)):
            x = torch.randn((m, k), generator=g, device="cuda").to(dx)
            y = torch.randn((k, n), generator=g, device="cuda").to(dy)
            got = ops.matmul(x, y)
            check(got.dtype == torch.result_type(x, y), f"matmul out dtype {got.dtype}")
            paper_held(res, "streamed_matmul", got.dtype, f"{dx}@{dy} ({m},{k})@({k},{n})",
                       got, MM.matmul_plain(x, y), PAPER_RTOL[got.dtype])
    # FWT: every body runs the plain version's f32 operations in its order,
    # so each launch is held bit-equal (tolerance 0).
    for dt in (f32, bf16):
        for shape in ((4096, 1024), (1024, 4096), (3, 8), (5, 1), (33, 32), (2, 1 << 15)):
            x = torch.randn(shape, generator=g, device="cuda").to(dt)
            held(res, "fwt", dt, f"rows x block {shape}", FWT.fwt_block(x), FWT.fwt_plain(x),
                 0.0)
        for shape in ((4096, 1024), (4096, 1020), (64, 3), (1 << 15, 2)):
            y = torch.randn(shape, generator=g, device="cuda").to(dt)
            held(res, "fwt_columns", dt, f"columns of {shape}", FWT.fwt_columns(y),
                 FWT.fwt_columns_plain(y), 0.0)
        y = torch.randn((4096, 1024), generator=g, device="cuda").to(dt)
        want = FWT.fwt_columns_plain(y)
        held(res, "fwt_columns", dt, "columns of (4096, 1024) in place",
             FWT.fwt_columns(y, out=y), want, 0.0)
    xf = torch.randn(1 << 22, generator=g, device="cuda")
    for name in ("fwt", "fwt_columns"):
        held(res, name, f32, "ops.fwt 2^22 (two passes) vs the whole-vector plain version",
             ops.fwt(xf), ref.fwt_ref(xf), 0.0)
    xb = xf.bfloat16()
    held(res, "fwt_columns", bf16, "ops.fwt 2^22 vs the plain passes (bf16 between)",
         ops.fwt(xb), FWT.fwt_columns_plain(FWT.fwt_plain(xb.view(4096, 1024))).view(-1), 0.0)
    rng = np.random.default_rng(41)
    for b in (8, 16, 32, 64, 1024):
        nw_in = [rng.integers(-b, b, b).astype(np.float32) for _ in range(2)]
        sub = rng.choice([-1.0, 1.0], size=(b, b)).astype(np.float32)
        got = ops.nw_tile(*(torch.from_numpy(a).cuda() for a in nw_in), -2.0,
                          torch.from_numpy(sub).cuda())
        want = ref.nw_ref(*nw_in, -2.0, sub) if b <= 64 else ops.nw_tile(
            *(torch.from_numpy(a) for a in nw_in), -2.0, torch.from_numpy(sub)).numpy()
        held(res, "nw_tile", f32, f"one tile B={b}", got, torch.from_numpy(want).cuda(), 0.0)
    sc = dna_scores(512, 384, 42)
    got = ops.nw_wavefront(torch.from_numpy(sc).cuda(), block=32)
    held(res, "nw_tile", f32, "wavefront 512 x 384 vs nw_full_ref", got,
         torch.from_numpy(ref.nw_full_ref(sc)).cuda(), 0.0)
    sc = np.random.default_rng(44).normal(size=(512, 384)).astype(np.float32)
    got = ops.nw_wavefront(torch.from_numpy(sc).cuda(), block=32, gap=0.5)
    held(res, "nw_tile", f32, "wavefront 512 x 384, normal scores, gap 0.5, vs plain", got,
         NW.nw_wavefront_plain(torch.from_numpy(sc), block=32, gap=0.5).cuda(), 0.0)
    scores = torch.from_numpy(dna_scores(NW_N, NW_N, 43)).cuda()
    full = ops.nw_wavefront(scores, block=NW_BLOCK)
    plain_full = NW.nw_wavefront_plain(scores, block=NW_BLOCK)
    held(res, "nw_tile", f32, f"wavefront {NW_N} x {NW_N} vs plain", full, plain_full, 0.0)
    # The same task one nw_diagonal launch a diagonal (the comparison path).
    state, sc_d, out_d = NW.initial_state(scores, NW_BLOCK)
    diags = wavefront.diagonal_tiles(NW_N // NW_BLOCK, NW_N // NW_BLOCK)
    for d in diags:
        NW.nw_diagonal(state, sc_d, d)
    held(res, "nw_tile", f32, f"{len(diags)} nw_diagonal launches {NW_N} x {NW_N} vs plain",
         out_d, plain_full, 0.0)

    # Times at the path's shapes.  Matmul: one f32 2048^3 task, library one
    # torch.matmul (TF32 off).  FWT: time_fwt.  NW: one 2048^2 task, the
    # kernel's one launch over the whole grid (nw_run on a prepared boundary
    # state; its zeroed link buffer included), queued.
    time_fwt(res, g)
    x, y = (torch.randn((2048, 2048), generator=g, device="cuda") for _ in range(2))
    n_diag = len(diags)
    cells = NW_N * NW_N

    def per_diagonal():
        for d in diags:
            NW.nw_diagonal(state, sc_d, d)
    timed = {
        "streamed_matmul": (lambda: ops.matmul(x, y), lambda: MM.matmul_plain(x, y),
                            lambda: torch.matmul(x, y), (3 * x.numel() * 4, 2.0 * 2048 ** 3)),
        # per cell: the diagonal and upper terms (2 ops), their max, the west
        # fold on column 0 (ignored), and log2(B) = 5 ladder steps of 2 ops
        "nw_tile": (lambda: NW.nw_run(state, sc_d, 0, n_diag),
                    lambda: NW.nw_wavefront_plain(scores, block=NW_BLOCK), None,
                    (2 * cells * 4, cells * (3 + 2 * 5))),
    }
    for name, (kern, plain, lib, (nbytes, flops)) in timed.items():
        r = res[name]
        slow = name == "nw_tile"  # the plain wavefront takes over a second a run
        # NW: device time with the task's launches queued ahead (device_ms);
        # the host's rate for ops.nw_wavefront is printed beside it.
        r["ms"] = device_ms(kern, iters=20) if slow else time_ms(kern)
        r["plain_ms"] = time_ms(plain, iters=2 if slow else 20, warmup=1)
        r["library_ms"] = time_ms(lib) if lib is not None else None
        # The matmul's f32-accurate work on the tensor cores is three TF32
        # products (3xTF32): its bound counts them at the TF32 peak.
        r["bound_ms"], r["bound_by"] = (
            bound(nbytes, 3 * flops, "tf32") if name == "streamed_matmul"
            else bound(nbytes, flops, torch.float32))
        lib_ms = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        extra = ""
        if name == "streamed_matmul":
            extra = (f"; 3xTF32 bound (3 x {flops:.0f} flops at 495 TFLOP/s, the JSON's), "
                     f"f32 FMA bound {bound(nbytes, flops, torch.float32)[0]:.6f} ms (one "
                     f"product at 67 TFLOP/s); kernel {r['library_ms'] / r['ms']:.2f}x the "
                     f"library's speed; {matmul_plan(x, y)}")
        elif slow:
            # The comparison path: the host issues a diagonal slower than the
            # card runs it, so its device time is taken queued (device_ms).
            issued = time_ms(lambda: ops.nw_wavefront(scores, block=NW_BLOCK), iters=20)
            extra = (f" a task, one launch; ops.nw_wavefront as the host issues it "
                     f"{issued:.4f} ms; the same task as {n_diag} nw_diagonal launches: "
                     f"{device_ms(per_diagonal):.4f} ms queued ahead, "
                     f"{time_ms(per_diagonal, iters=5, warmup=1):.4f} ms as the host "
                     f"issues them")
        print(f"[kernels] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"library {lib_ms}, bound {r['bound_ms']:.6f} ms ({r['bound_by']}, "
              f"{nbytes:.0f} bytes, {flops:.0f} flops){extra}")


FWT_TASKS = 8  # 2^22 f32 tasks in time_fwt's cold rotation: 128 MB, past the 50 MB L2


def hadamard(n: int) -> torch.Tensor:
    """The n x n Sylvester Hadamard matrix on the card, f32: ``x @ H`` is the
    unnormalized WHT of each row of ``x``."""
    h = torch.ones((1, 1), device="cuda")
    while h.shape[0] < n:
        h = torch.cat([torch.cat([h, h], 1), torch.cat([h, -h], 1)], 0)
    return h


def time_fwt(res: dict, g: torch.Generator) -> None:
    """The two FWT passes of the streaming path's 2^22 f32 task, (4096,
    1024), and the whole ``ops.fwt``: device time queued behind a spin
    kernel, cold (a rotation of FWT_TASKS tasks, past the L2, so that the
    device-memory bound is a fair yardstick) and warm (one task again and
    again); the plain versions as the host issues them; the library
    yardstick, one f32 product a pass with the Sylvester Hadamard matrix
    (TF32 off; sums in another order; the port never calls it)."""
    from repro_torch.kernels import fwt as FWT
    from repro_torch.kernels import ops

    xs = [torch.randn((4096, 1024), generator=g, device="cuda") for _ in range(FWT_TASKS)]
    ys = [FWT.fwt_block(x) for x in xs]
    h1, h2 = hadamard(1024), hadamard(4096)
    turn = itertools.count()

    def cold(fn):
        return device_ms(lambda: fn(next(turn) % FWT_TASKS), iters=64)

    # name -> (kernel on task i, plain version, library call, stages)
    passes = {"fwt": (lambda i: FWT.fwt_block(xs[i]), FWT.fwt_plain, lambda: xs[0] @ h1, 10),
              "fwt_columns": (lambda i: FWT.fwt_columns(ys[i]), FWT.fwt_columns_plain,
                              lambda: h2 @ ys[0], 12)}
    nbytes = 2 * xs[0].numel() * 4  # 16 MB in, 16 MB out
    for name, (kern, plain, lib, stages) in passes.items():
        r = res[name]
        r["ms"] = cold(kern)
        r["plain_ms"] = time_ms(lambda: plain(xs[0]), iters=20, warmup=1)
        r["library_ms"] = device_ms(lib, iters=20)
        flops = xs[0].numel() * stages
        r["bound_ms"], r["bound_by"] = bound(nbytes, flops, torch.float32)
        print(f"[kernels] {name} pass of (4096, 1024) f32: kernel {r['ms']:.4f} ms cold, "
              f"{device_ms(lambda: kern(0), iters=64):.4f} ms warm, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}, {nbytes} bytes, {flops} flops)")
    flat = [x.view(-1) for x in xs]
    both = [res[n] for n in passes]
    print(f"[kernels] ops.fwt of a 2^22 f32 task (row pass, then column pass in place; 2 "
          f"launches): {cold(lambda i: ops.fwt(flat[i])):.4f} ms cold, "
          f"{device_ms(lambda: ops.fwt(flat[0]), iters=64):.4f} ms warm; bounds "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms (its own 16 MB in and out) and "
          f"{2 * nbytes / HBM_BYTES_PER_S * 1e3:.6f} ms (both passes through device memory); "
          f"plain {sum(r['plain_ms'] for r in both):.4f} ms, library "
          f"{sum(r['library_ms'] for r in both):.4f} ms")


def matmul_plan(x, y) -> str:
    from repro_torch.kernels import streamed_matmul as MM

    p = MM.plan_matmul(x.shape[0], y.shape[1], x.shape[1], x.dtype, y.dtype)
    return (f"plan: {p.body} body, {p.products} product(s) a k-step, grid {p.grid} of "
            f"{MM.BLOCK} tiles")


def phase_card_vs_cpu_streams() -> None:
    """launch/streams --small (2 tasks a category) on the card and on the
    CPU: the same tasks from the same seed give the same outputs."""
    from repro_torch.launch import streams as S

    card = S.run(device="cuda", n_tasks=2, streams=2, small=True)
    cpu = S.run(device="cpu", n_tasks=2, streams=2, small=True)
    for a, b in zip(card, cpu):
        worst = 0.0
        for got, want in zip(a["outputs"], b["outputs"]):
            err = (got.float() - want.float()).abs().max().item()
            tol = (0.0 if a["kernel"] in ("nw", "fwt")
                   else 1e-5 * max(1.0, want.float().abs().max().item()))
            check(err <= tol, f"streams {a['category']}: card vs CPU err {err} > {tol}")
            worst = max(worst, err)
        check(a["multi_equals_single"] and a["max_abs_err"] <= a["tol"],
              f"streams {a['category']} --small on the card: {a['max_abs_err']}")
        print(f"[card_vs_cpu] streams {a['category']} ({a['shape']}, 2 tasks): card vs CPU "
              f"max abs diff {worst:.3e}; card R {a['R']:.4f}, cpu R {b['R']:.4f}")


def pinned_bandwidth(nbytes: int = 256 << 20, reps: int = 5) -> dict:
    """GB/s of one pinned host -> card and card -> host copy of ``nbytes``
    (CUDA events, median of ``reps``)."""
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    out = {}
    for label, dst, src in (("h2d", dev, host), ("d2h", host, dev)):
        ms = []
        for _ in range(reps + 1):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
        out[label] = nbytes / (float(np.median(ms[1:])) * 1e-3) / 1e9
    return out


def phase_streams(res: dict) -> list[dict]:
    """The paper's Fig. 9 experiment at full size through launch/streams,
    with every launch count set to 0 just before it and read just after."""
    from repro_torch.launch import streams as S

    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    results = S.run(device="cuda", n_tasks=8, streams=4)
    launches = {name: c.launches for name, c in counters.items()}
    # FWT: 2 launches a task run, one of the row pass and one of the column pass
    per_task = {"matmul": {"streamed_matmul": 1}, "fwt": {"fwt": 1, "fwt_columns": 1},
                "nw": {"nw_tile": 1}}
    want = {name: 0 for name in counters}
    for r in results:
        print(S.format_line(r))
        for name, n in per_task[r["kernel"]].items():
            want[name] = n * r["task_runs"]
        check(r["max_abs_err"] <= r["tol"],
              f"streams {r['category']}: max abs err {r['max_abs_err']} > {r['tol']}")
        check(r["multi_equals_single"], f"streams {r['category']}: multi != single outputs")
        check(r["overlap_ms"] > 0.0, f"streams {r['category']}: no H2D/KEX overlap in events")
    check(launches == want, f"streams: launches {launches} != {want}")
    fwt_runs = next(r["task_runs"] for r in results if r["kernel"] == "fwt")
    check(launches["fwt"] + launches["fwt_columns"] == 2 * fwt_runs,
          f"streams: FWT launches {launches['fwt']} + {launches['fwt_columns']} != "
          f"2 x {fwt_runs} task runs")
    for name in ("streamed_matmul", "fwt", "fwt_columns", "nw_tile"):
        res[name]["launches"] = launches[name]
    for line in S.paper_model_checks():
        print(line)
    bw = pinned_bandwidth()
    print(f"[streams] pinned 256 MB copy: H2D {bw['h2d']:.2f} GB/s, D2H {bw['d2h']:.2f} GB/s; "
          f"launches {launches}")
    summary = [{k: v for k, v in r.items() if k != "outputs"} for r in results]
    print("[streams] results " + json.dumps({"categories": summary, "pinned_gb_s": bw}))
    return summary


def _leaves(t):
    for v in t.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add a torch.profiler breakdown of the main path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs one CUDA card",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    secs = _build.build(ptxas_info=True)
    print(f"[build] {json.dumps(secs)} ({time.perf_counter() - t0:.1f}s wall, "
          f"{len(_build.SOURCES)} sources, nvcc {' '.join(_build.NVCC_FLAGS)})")

    res = phase_kernels()
    t0 = time.perf_counter()
    phase_paper_kernels(res)
    print(f"[kernels] paper kernels {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_card_vs_cpu()
    phase_card_vs_cpu_mamba()
    phase_card_vs_cpu_streams()
    print(f"[card_vs_cpu] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    main_path = phase_main_path(res, profile=args.profile)
    print(f"[main] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_cache_paths(res, main_path, profile=args.profile)
    del main_path  # the full model's weights
    print(f"[cache] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_main_mamba(res, profile=args.profile)
    print(f"[mamba] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_streams(res)
    print(f"[streams] {time.perf_counter() - t0:.1f}s")
    kernels = [{"name": n, "route": "cuda", "source": KERNELS[n][0],
                "replaces": KERNELS[n][1], "launches": r["launches"],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}
               for n, r in res.items()]
    print(f"[done] {time.perf_counter() - t_start:.1f}s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
