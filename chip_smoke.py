#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version (and, for training, their autograd
Functions against autograd through the plain versions), holds the card
against the CPU on 2-layer full-width qwen3-4b and mamba2-2.7b and on the paper's streaming
path at a small size, then serves requests through the full 36-layer bf16
qwen3-4b on the card (plain, with speculative decode, over int8 and fp8 KV
pages, over int8 pages with speculative decode, over the contiguous slot
cache, in a page pool small enough to preempt, with and without prefix
sharing, and at temperature) and through the full 64-layer bf16
mamba2-2.7b (contiguous slot cache, paged pool, state snapshots), runs
the paper's Fig. 9 experiment (matmul, FWT and NW tasks over CUDA streams
and the PCIe link) at full size, serves the decoder-only zoo:
gemma2-27b, qwen2-moe-a2.7b, internlm2-20b and phi4-mini-3.8b at full
width and depth, mixtral-8x7b at full width cut to 16 of its 32 layers,
and the rest of the zoo: jamba-1.5-large (a mamba + attention + MoE
hybrid) at full width cut to its unit's first 4 layers, whisper-medium (24
+ 24 layers, 1500 encoder frames a request) and paligemma-3b (18 layers, a
256-row image prefix through ServingEngine.generate), and trains the full
qwen3-4b and mamba2-2.7b for a few steps through the training launcher.

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
     the zoo's g = 2, 3 and 6 (all four paged entries at q_len 1, 5 and
     blocks of 68-72 rows, and the prefill, with gemma2's query scale
     144^-0.5 and softcap 50, with and without a window that bites),
     head_dim 64 and 256 and splits behind the window as well; phase 9's
     shapes: the prefill with paligemma's prefix_len 256 (hd 256, g = 8:
     the 320-row first chunk, later chunks at q_offset 320, a ragged
     prefix, a prefix past a chunk's causal limit), non-causal at whisper's
     hd 64, g = 1 (Sq = Sk = 1500, Sq 64 and 37 against Sk 1500), paged
     decode at hd 64, g = 1, the SSD scan at jamba's H 128, P 128
     (zero and random initial states), jamba's attention (H 64, Hkv 8,
     hd 128: the single-token paged entry over the main path's four
     cases, and chunks of 64 rows at q_offset 0 and 64 and a 36-row tail)
     and whisper's causal decoder prefill (hd 64, g = 1) at the same
     chunks, each of the first four then timed beside its plain
     version, the library call (SDPA with the prefix-LM boolean mask, SDPA
     without a mask; none for SSD) and its bound (a "[kernels] rows" line); the
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
  5c. sharing and sampling: (a) the full qwen3-4b of phase 5 serves the
     head-sharing prompts (snapshot_prompts) without and with prefix
     sharing: 3 hits and 12 pages shared, strictly fewer peak pages, tick
     p50, tok/s, chunks, COW forks and the per-uid agreement with the
     unshared serve (>= 0.8); (b) the same over int8 pages (agreement >=
     0.5), and a COW fork of a registered int8 page with codes and scale
     rows bit-equal; (c) 2-layer f32 card vs CPU: shared serves (fused and
     not) equal to the unshared serve with equal counters on both devices,
     a prefix store saved by one engine and restored by another (the cold
     serve's tokens), and a shared pool of SHARE_PRESSURE_BLOCKS blocks
     that preempts and re-maps the head on readmission (counters equal
     card vs CPU, the unpressured tokens); (d) the sampler's keys and
     uniforms bit-equal card vs CPU, SAMPLER_DRAWS draws and
     verify_sampled's first token within TV 0.05 of softmax(l / T), its
     acceptance within 0.02 of p(d); 2-layer f32 temperature tokens equal
     paged vs contiguous (card vs CPU agreement printed); the full model at
     T = 0.8 plain, with n-gram drafts and with the greedy tokens as
     drafts (verify ticks > 0), beside the greedy n-gram spec serve.  Each
     full-width serve warmed once and measured with the launch counts at 0.
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
  8. the decoder-only zoo: (a) gemma2-27b (one local and one global layer;
     as published and with sliding_window 64, which bites on the 128-token
     prompts) and qwen2-moe-a2.7b (2 layers; as published and with
     capacity_factor 0.5, whose decode ticks drop choices) at full width,
     f32, paged and contiguous, card vs CPU: admission logits allclose,
     greedy tokens identical; the graphed MoE serve equals the eager card
     serve.  (b) gemma2-27b, 46 layers, bf16 (54.4 GB of weights): fused
     paged bf16 pages, int8 pages (agreement with the plain serve >= 0.5),
     the contiguous cache, n-gram spec on tiled prompts; (c) qwen2-moe-
     a2.7b, 24 layers: fused paged, n-gram spec; (d) internlm2-20b (48
     layers) and phi4-mini-3.8b (32) fused paged, mixtral-8x7b at 16 of its
     32 layers (the full bf16 weights, 93 GB, do not fit in 80 GB).  Each
     model first checks that under 2 GiB is allocated, serves each option
     once warm and once measured (launches 1 a layer a tick of its kind
     and a chunk), prints tokens/s, tick p50, the graphed chunk, acceptance,
     page bytes and a tick's weight-read floor, and is dropped with its
     engines (memory_reserved printed).
  9. the rest of the zoo: (a) card vs CPU, f32 at published widths cut in
     depth: jamba (unit positions 0 and 3: mamba + dense FFN, attention +
     MoE; 4 of its 16 experts) and whisper-medium (2 decoder and 2 encoder
     layers, 1500 frames, one evict / readmit mid decode) serve the 6
     requests paged and contiguous (admission logits allclose, greedy
     tokens identical, the graphed card serve equal to the eager one);
     paligemma-3b (2 layers) generates for 4 rows of 256 image rows + 64
     tokens (first-chunk logits allclose, tokens identical).  (b) bf16,
     random weights from seed 0, each model dropped before the next:
     jamba-1.5-large at full width cut to its unit's first 4 layers (one
     8-layer unit, ~86 GB, does not fit in 80 GB) and whisper-medium (each
     request with its own 1500 frames; encode time per admission) serve
     paged and contiguous, warm then counted (jamba: 3 SSD and 1 prefill
     launches a chunk, 1 paged a paged tick; whisper: 24 paged a tick, 48
     prefill a chunk, 24 an encode); paligemma-3b generates (the 320-row
     first chunk timed alone; 18 prefill launches, nothing else: decode is
     torch ops over the contiguous cache, eager).  Each prints tokens/s,
     the tick beside its weight-read floor (block weights + the f32 table,
     + the slots' cross K/V for whisper), launches, peak GB and
     memory_reserved.
  10. observability and the serving policy (after 5c, on its qwen3-4b):
     traced serves with a metrics registry and an SLO (targets 25 and 3 x
     phase 5's tick p50) on a fresh engine and on the same engine warm:
     tokens bit-equal to phase 5's, no span dropped, no live STR002, the
     launches of the serve; per request queue wait, TTFT, worst ITL; ITL
     p50 / p99 / max, SLO attainment and goodput; the trace written to
     build/obs_trace.json and read back; the doctor's findings.  Tracing's
     cost (3 untraced and 3 traced fresh serves in turns).  The stage probe
     with the slots active mid serve (the pool and page table unchanged,
     phase 5's tokens): chunk and tick ms, R, the decision, the plan, the
     trace's overlap against the R gate's prediction; autotune(128) on the
     idle engine and a serve on it (tok/s, tick p50, agreement with the
     untuned tokens, graphs captured; at a new page size the old pool's
     graphs neither run again nor stay held).  A warm traced serve in 22
     blocks: each request's TTFT and worst ITL beside its evictions and
     stall, the evict / readmit spans.  2-layer f32 card vs CPU: the same
     stage times make the same plan, then the same tokens and span
     sequence.
  11. the measured tuner (after 10, on phase 5's qwen3-4b and requests):
     profile_engine on an idle warm engine, untraced (the synchronized
     probe) and traced after a served workload (the trace's estimate), each
     reading's plan; search_tuned_plan (4 trials, 1 sweep, 2 timed runs)
     with its log, trials, wall and memory_allocated before and after (back
     at its level); the tuned plan's tok/s against its analytic baseline; a
     warm serve with the plan (launches counted; tokens bit-equal to phase
     5's, or agreement >= 0.5 for a quantized plan) beside a warm untuned
     serve; a TuningDB round trip keyed by the card's name; the launcher's
     --autotune twice (searched, then cached).
  12. the stream-safety analyzer (after 11, on phase 5's qwen3-4b): (a)
     ``repro_torch.analysis`` on the card: the static passes on the CPU (31
     paths, the kernel lint, the pool audit), the quant contract through
     the quantized kernels and the live sync audit (every ``@tick_path``
     method under ``torch.cuda.set_sync_debug_mode("error")``) of 9 (arch,
     mode) smoke engines; clean, with no waiver.  (b) phase 5's requests in
     phase 5b's 22-block pool, which preempts, with REPRO_SANITIZE=1 and
     the live audit: tokens bit-equal to phase 5b's, every call within its
     allowed_fetches, sanitize_checks, tok/s beside phase 5b's; (a)'s and
     (b)'s launches join the kernels line.
  13. training: (a) the prefill kernel's autograd.Function (the kernel's
     out and lse, the torch-ops backward's dq, dk, dv) against autograd
     through the plain version at qwen3-4b's B 4, S 512, H 32/8, hd 128,
     gemma2's window (256, biting at 512) and softcap 50, whisper's
     non-causal 1500-frame encoder and paligemma's 256-row prefix, and the
     SSD Function (y, state, six grads) at mamba2's shapes, in f32 (1e-4)
     and bf16 (2e-2) of the plain tensor's largest magnitude; the bf16
     qwen3 forward with lse timed beside SDPA and its bound (PERF.md row
     4d), the torch-ops backward beside SDPA's; (b) one make_train_step
     step of 2-layer full-width qwen3-4b and mamba2-2.7b, f32, accum 1 and
     2, card vs CPU: loss and grad norm (1e-4), every leaf's grad (1e-3 of
     its largest magnitude), no card grad missing; (c) the launcher's
     settings (4 x 512, accum 1, lr 1e-3, warmup 2) on the full 36-layer
     bf16 qwen3-4b (6 steps, remat dots) and the full 64-layer mamba2-2.7b
     (3 steps): finite, falling losses, step p50, tokens/s, 6 N tokens/s
     as a share of 989 TFLOP/s, peak allocated; the launches join the
     kernels line; (d) 2-layer full-width bf16 qwen3-4b: a checkpointed
     run whose last checkpoint is removed resumes to the uninterrupted
     run's losses bit for bit (deterministic kernels where torch has
     them), and PrefetchIterator at depth 0 and 2 with host work of half a
     step a batch gives equal losses, both walls printed.
  14. training over a device mesh: (a) the full qwen3-4b (bf16, 4 x 512,
     remat dots, phase 13c's settings, 3 steps) through Trainer(mesh=) in a
     world of 1 over NCCL (mesh 1 x 1: params and moments DTensors, every
     rule of the policy on axes of size 1), against the single-device
     Trainer from the same seed, both with deterministic kernels: losses
     and every param bit-equal (else the largest difference is printed and
     the check fails); step p50, tokens/s, peak allocated, and the prefill
     kernel's launches (they join the kernels line); (b) the launcher under
     ``torch.distributed.run --nproc-per-node 1 --mesh-data 1 --mesh-model
     1`` on the 2-layer full-width qwen3-4b for 4 steps: exit 0, falling
     loss; (c) ``repro_torch.launch.dryrun --arch qwen3-4b --shape
     train_4k --mesh single`` (a fake 256-rank world on the CPU, run beside
     (a) and (b)): per-rank memory, flops, collective bytes by op and the
     bottleneck beside the analytic 6 N D.
  15. the last modules: (a) on phase 5's full qwen3-4b (before its weights
     are dropped), ServingEngine.prefill_streamed of a B 2 x 512 prompt in 8
     chunks of 64 against transformer.prefill of the same prompt in one shot
     (the check): max |dlogit| of the last logits within LAST_RTOL (5e-2,
     bf16) of the one-shot's largest magnitude, exactly 36 x 8 and 36
     prefill launches and nothing else, the wall and the peak allocated of
     each (reset between; O(chunk) vs O(prompt) activations), then generate
     of 16 tokens through prefill_streamed (its first token the argmax of the
     streamed logits); (b) after phase 14, each repro_torch.examples module's
     main in process at the reference's default arguments (train_e2e at
     --size 10m --steps 40): exit 0, its path's kernels launched, its printed
     lines kept.  Every launch joins the kernels line.
On the card every serve's ticks, chunks and page moves replay CUDA graphs
(runtime/graphs.py): phase 4 also serves each 2-layer case with the card's
eager step functions and holds the graphed serve to it (tokens identical,
admission logits within the card-vs-CPU tolerance, bit-equality printed);
each full-width serve prints its graphs captured, replays, capture ms and
memory_reserved before and after; phases 5 and 6 serve 3 more times,
dropping each engine, and check that memory_reserved does not grow; the
launch counts include the graphs' replays.
With --profile, phases 5, 5b, 6, 8 and 9 add a torch.profiler breakdown (device
busy time by kernel and by group, the paged-attention group's split and
combine launches together; idle share) of the plain, oracle-spec, int8,
qwen3 contiguous and mamba contiguous serves and each zoo model's first
(paged) serve.  The last three lines of
stdout are the card's name and power limit, the kernels JSON and the
result JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import io
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


def flash_bytes_flops(q, k, q_offset, window, *, causal=True, prefix_len=0, lse=False):
    """Bytes (q, k, v read once, out and the lse written once) and the flops
    of the scores and P V over the keys each query may see: the kernel
    wrapper's own count (``flash_attention.cost``)."""
    from repro_torch.kernels import flash_attention as FA

    flops, nbytes = FA.cost(q, k, causal=causal, window=window, q_offset=q_offset,
                            prefix_len=prefix_len, lse=lse)
    return nbytes, flops


def attn_case(dtype, sq, sk, *, h, hkv, hd, seed):
    """q (1, Sq, H, hd), k/v (1, Sk, Hkv, hd) normal draws on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((1, sq, h, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((1, sk, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((1, sk, hkv, hd), generator=g, device="cuda").to(dtype)
    return q, k, v


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
    """Bytes and operations of one scan: the kernel wrapper's own count
    (``ssd_chunk.cost``: inputs read and outputs written once, the chunked
    algorithm's products on these inputs)."""
    from repro_torch.kernels import ssd_chunk as SSD

    flops, nbytes = SSD.cost(x, bm, chunk=chunk, init=init)
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
# The zoo's grouped-query ratios (gemma2 g = 2, phi4-mini 3, internlm2 6) at
# head_dim 128, gemma2's query scale and softcap 50, with and without a
# window that bites: q_len 1, a verify block of 5, and blocks of 68-72 rows
# (two row tiles of the split body).
ZOO_SCALE = 144 ** -0.5
ZOO_CASES = [dict(g=g, t=t, cur=[139, 111, 88, 40], **w)
             for g, t_long in ((2, 34), (3, 23), (6, 12)) for t in (1, 5, t_long)
             for w in ({}, dict(window=24))]
ZOO_FLASH_CASES = [dict(g=g, sq=sq, q_offset=off, **w) for g in (2, 3, 6)
                   for sq, off in ((64, 0), (64, 64), (36, 64)) for w in ({}, dict(window=48))]
# Phase 9's attention shapes.  paligemma (hd 256, g = 8): its first chunk
# (256 image rows + 64 tokens, prefix_len 256), a later chunk at q_offset
# 320 (with and without the prefix, which it cannot change there), a
# ragged prefix, and a prefix past a later chunk's causal limit (rows see
# keys beyond their own position).  whisper (hd 64, g = 1), non-causal:
# the encoder (1500 x 1500), the cross-attention of a chunk (64 and 37
# rows against 1500 frames).
PALI_ATTN = dict(h=8, hkv=1, hd=256)
PREFIX_CASES = [dict(sq=320, sk=320, q_offset=0, prefix_len=256),
                dict(sq=64, sk=384, q_offset=320, prefix_len=256),
                dict(sq=64, sk=384, q_offset=320, prefix_len=0),
                dict(sq=90, sk=90, q_offset=0, prefix_len=70),
                dict(sq=48, sk=300, q_offset=200, prefix_len=280)]
WHISPER_ATTN = dict(h=16, hkv=16, hd=64)
NONCAUSAL_CASES = [dict(sq=1500, sk=1500), dict(sq=64, sk=1500), dict(sq=37, sk=1500)]
# whisper's paged decode (hd 64, g = 1) and jamba's SSD (H 128, P 128, N 128)
PAGED_HD64_CASES = [dict(cur=[143, 100, 15, 16]), dict(cur=[0, 15, 16, 100], trash_row=0)]
JAMBA_SSD = dict(h=128, p=128, n=128)
SSD_P128_CASES = [(1, 64, 256, True), (1, 64, 256, False), (2, 300, 256, True),
                  (1, 512, 256, False)]
# jamba's attention layer (H 64, Hkv 8, hd 128: g = 8, no rope) and
# whisper's causal decoder self-attention (H = Hkv = 16, hd 64: g = 1) at
# phase 9's bf16 serve: the single-token paged entry of every paged tick
# (PAGED_CASES) and the prefill of every chunk (64 rows at q_offset 0 and
# 64, a 36-row tail).
JAMBA_ATTN = dict(h=64, hkv=8, hd=128)
CHUNK_CASES = [(64, 0), (64, 64), (36, 64)]
PAGED_CASES = [dict(cur=[0, 15, 16, 100], trash_row=0),
               dict(cur=[143, 100, 15, 16]),
               dict(cur=[143, 100, 15, 16], window=32),
               dict(cur=[143, 100, 15, 0], softcap=30.0, trash_row=3)]
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
        for shape, label in ((dict(h=32, hkv=8, hd=128), ""), (JAMBA_ATTN, "jamba g=8 ")):
            for i, c in enumerate(PAGED_CASES):
                kw = {k: c[k] for k in ("window", "softcap") if k in c}
                q, kp, vp, pt, cl = paged_case(dtype, c["cur"], trash_row=c.get("trash_row"),
                                               seed=i + (100 if label else 0), **shape)
                held(res, "paged_attention", dtype, label + str(c),
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
        for i, c in enumerate(ZOO_CASES):
            kw = dict(window=c.get("window", 0), softcap=50.0, scale=ZOO_SCALE)
            q, kp, vp, pt, cl = draft_case(dtype, c["cur"], c["t"], seed=40 + i, h=8 * c["g"],
                                           n_pages=12)
            single = c["t"] == 1
            if single:
                q = q[:, 0].contiguous()
            label = f"zoo g={c['g']} q_len {c['t']} ({c['t'] * c['g']} rows) {kw}"
            name = "paged_attention" if single else "paged_attention_multi"
            plain = PA.paged_attention_plain if single else PA.paged_attention_multi_plain
            held(res, name, dtype, label, getattr(ops, name)(q, kp, vp, pt, cl, **kw),
                 plain(q, kp, vp, pt, cl, **kw))
            for kd in ("int8", "fp8"):
                (kc, ks), (vc, vs) = quantized(kp, kd), quantized(vp, kd)
                qname = name + "_quant"
                qplain = (PA.paged_attention_quant_plain if single
                          else PA.paged_attention_multi_quant_plain)
                held(res, qname, dtype, f"{kd} {label}",
                     getattr(ops, qname)(q, kc, vc, ks, vs, pt, cl, **kw),
                     qplain(q, kc, vc, ks, vs, pt, cl, **kw))
        for i, c in enumerate(ZOO_FLASH_CASES):
            kw = dict(window=c.get("window", 0), softcap=50.0, scale=ZOO_SCALE)
            q, k, v = flash_case(dtype, c["sq"], c["q_offset"], seed=50 + i, h=8 * c["g"])
            held(res, "flash_attention", dtype, f"zoo g={c['g']} Sq={c['sq']} "
                 f"q_offset={c['q_offset']} {kw}",
                 ops.flash_attention(q, k, v, q_offset=c["q_offset"], **kw),
                 FA.flash_attention_plain(q, k, v, q_offset=c["q_offset"], **kw))
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
        for shape, label in ((JAMBA_ATTN, "jamba g=8 hd 128"),
                             (WHISPER_ATTN, "whisper causal hd 64 g=1")):
            for i, (sq, off) in enumerate(CHUNK_CASES):
                q, k, v = flash_case(dtype, sq, off, seed=110 + i, **shape)
                sc = shape["hd"] ** -0.5
                held(res, "flash_attention", dtype, f"{label} Sq={sq} q_offset={off}",
                     ops.flash_attention(q, k, v, q_offset=off),
                     FA.flash_attention_plain(q, k, v, scale=sc, q_offset=off))
        for i, c in enumerate(PREFIX_CASES):
            q, k, v = attn_case(dtype, c["sq"], c["sk"], seed=60 + i, **PALI_ATTN)
            kw = dict(q_offset=c["q_offset"], prefix_len=c["prefix_len"], scale=256 ** -0.5)
            held(res, "flash_attention", dtype, f"paligemma prefix {c}",
                 ops.flash_attention(q, k, v, **kw), FA.flash_attention_plain(q, k, v, **kw))
        for i, c in enumerate(NONCAUSAL_CASES):
            q, k, v = attn_case(dtype, c["sq"], c["sk"], seed=70 + i, **WHISPER_ATTN)
            held(res, "flash_attention", dtype, f"whisper non-causal {c}",
                 ops.flash_attention(q, k, v, causal=False),
                 FA.flash_attention_plain(q, k, v, causal=False, scale=64 ** -0.5))
        for i, c in enumerate(PAGED_HD64_CASES):
            q, kp, vp, pt, cl = paged_case(dtype, c["cur"], trash_row=c.get("trash_row"),
                                           seed=80 + i, **WHISPER_ATTN)
            held(res, "paged_attention", dtype, f"whisper hd 64 g=1 {c}",
                 ops.paged_attention(q, kp, vp, pt, cl),
                 PA.paged_attention_plain(q, kp, vp, pt, cl, scale=64 ** -0.5))
        for i, (b, s_len, chunk, init) in enumerate(SSD_P128_CASES):
            x, dt_, a, bm, cm, st = ssd_case(dtype, b, s_len, init=init, seed=90 + i,
                                             **JAMBA_SSD)
            y, fs = SSD.ssd_chunked(x, dt_, a, bm, cm, chunk=chunk, init_state=st)
            y_p, fs_p = SSD.ssd_chunked_plain(x, dt_, a, bm, cm, chunk=chunk, init_state=st)
            label = (f"jamba H=128 P=128 b={b} S={s_len} chunk={chunk} "
                     f"init={'random' if init else 'zero'}")
            held(res, "ssd", dtype, label + " y", y, y_p,
                 SSD_RTOL[dtype] * max(1.0, y_p.float().abs().max().item()))
            held(res, "ssd", torch.float32, label + " final state", fs, fs_p,
                 SSD_RTOL[torch.float32] * max(1.0, fs_p.abs().max().item()))
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
    row4_other = other_body_ms(qf, kf, vf, scale=scale, q_offset=64)
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
              + (f"; {flash_plan(qf, kf)}; the {row4_other[0]} body {row4_other[1]:.4f} ms"
                 if name == "flash_attention" else ""))
    long_context(scale)
    prefill_long_context(scale)
    slice_rows()
    return res


def sdpa_masked(q, k, v, scale, mask=None, *, is_causal=False):
    """SDPA over (B, S, H, hd) inputs, heads-first copies made once outside
    the call, with an optional boolean (Sq, Sk) mask or ``is_causal`` (the
    plain causal mask at q_offset 0, which lets SDPA take its FlashAttention
    backend); returns the call."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=scale,
                                                  is_causal=is_causal, enable_gqa=True)


def yardstick(libs: dict) -> tuple[float, str]:
    """The fastest of several PyTorch calls computing the same function
    (device time, queued) and its name."""
    times = {name: device_ms(fn, iters=QUEUED) for name, fn in libs.items()}
    name = min(times, key=times.get)
    return times[name], name


def slice_rows() -> dict:
    """Rows 4b, 4c, 4e and 5b of PERF.md's kernel table, and whisper's paged
    decode, bf16: each kernel at its path's shapes beside its plain
    version, the library call (SDPA with the prefix-LM boolean mask for 4b,
    without a mask for 4c, with the causal mask both as a boolean matrix
    and as ``is_causal=True`` for 4e, the faster named; none for the SSD
    scan) and its bound; a prefill row also gives its plan and the other
    tensor-core body's time on the same inputs.  Printed as one ``[kernels]
    rows`` JSON line; the kernels JSON keeps the serve shapes' numbers."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ssd_chunk as SSD

    dt = torch.bfloat16
    entries = {}
    sc = 256 ** -0.5
    q, k, v = attn_case(dt, 320, 320, seed=7, **PALI_ATTN)
    pos = torch.arange(320, device="cuda")
    mask = (pos[:, None] >= pos[None, :]) | (pos[None, :] < 256)
    entries["4b prefill, prefix_len 256 (paligemma's first chunk: Sq 320, hd 256, g 8)"] = (
        lambda: ops.flash_attention(q, k, v, prefix_len=256, scale=sc),
        lambda: FA.flash_attention_plain(q, k, v, prefix_len=256, scale=sc),
        {"sdpa, boolean mask": sdpa_masked(q, k, v, sc, mask)},
        flash_bytes_flops(q, k, 0, 0, prefix_len=256), (q, k, v, dict(prefix_len=256, scale=sc)))
    sw = 64 ** -0.5
    for sq in (1500, 64):
        qe, ke, ve = attn_case(dt, sq, 1500, seed=8, **WHISPER_ATTN)
        name = ("4c prefill, non-causal (whisper's encoder: Sq = Sk 1500, hd 64, g 1)"
                if sq == 1500 else "4c prefill, non-causal (whisper's cross-attention: "
                "Sq 64, Sk 1500)")
        entries[name] = (
            lambda qe=qe, ke=ke, ve=ve: ops.flash_attention(qe, ke, ve, causal=False),
            lambda qe=qe, ke=ke, ve=ve: FA.flash_attention_plain(qe, ke, ve, causal=False,
                                                                 scale=sw),
            {"sdpa, no mask": sdpa_masked(qe, ke, ve, sw)},
            flash_bytes_flops(qe, ke, 0, 0, causal=False),
            (qe, ke, ve, dict(causal=False, scale=sw)))
    # 4e: phase 15's one-shot prefill (qwen3-4b, B 2 x 512, causal at q_offset 0)
    g10 = torch.Generator(device="cuda").manual_seed(10)
    qo = torch.randn((LAST_B, LAST_S, 32, 128), generator=g10, device="cuda").to(dt)
    ko, vo = (torch.randn((LAST_B, LAST_S, 8, 128), generator=g10, device="cuda").to(dt)
              for _ in range(2))
    so = 128 ** -0.5
    causal = torch.ones((LAST_S, LAST_S), dtype=torch.bool, device="cuda").tril()
    entries[f"4e prefill, causal (qwen3-4b's one-shot prefill: B {LAST_B} x Sq {LAST_S}, "
            "hd 128, g 4)"] = (
        lambda: ops.flash_attention(qo, ko, vo, scale=so),
        lambda: FA.flash_attention_plain(qo, ko, vo, scale=so),
        {"sdpa, boolean mask": sdpa_masked(qo, ko, vo, so, causal),
         "sdpa, is_causal": sdpa_masked(qo, ko, vo, so, is_causal=True)},
        flash_bytes_flops(qo, ko, 0, 0), (qo, ko, vo, dict(scale=so)))
    qp, kp, vp, pt, cl = paged_case(dt, [143, 115, 92, 80], seed=9, **WHISPER_ATTN)
    entries["1 paged decode (whisper: hd 64, g 1, B 4, 9 pages)"] = (
        lambda: ops.paged_attention(qp, kp, vp, pt, cl),
        lambda: PA.paged_attention_plain(qp, kp, vp, pt, cl, scale=sw),
        {"sdpa, boolean mask": sdpa_paged(qp, kp, vp, pt, cl, sw)},
        paged_bytes_flops(qp, kp, pt, cl, 0), None)
    xs, dts, as_, bs_, cs_, sts = ssd_case(dt, 1, 64, init=True, seed=9, **JAMBA_SSD)
    entries["5b SSD scan (jamba: b 1, a 64-token chunk, H 128, P 128, N 128)"] = (
        lambda: SSD.ssd_chunked(xs, dts, as_, bs_, cs_, chunk=256, init_state=sts),
        lambda: SSD.ssd_chunked_plain(xs, dts, as_, bs_, cs_, chunk=256, init_state=sts),
        None, ssd_bytes_flops(xs, bs_, 64, True), None)
    rows = {}
    for name, (kern, plain, libs, (nbytes, flops), flash) in entries.items():
        b_ms, b_by = bound(nbytes, flops, dt)
        lib_ms, lib_name = yardstick(libs) if libs else (None, None)
        row = {"ms": device_ms(kern, iters=QUEUED), "plain_ms": time_ms(plain, iters=10),
               "library_ms": lib_ms, "library": lib_name, "bound_ms": b_ms, "bound_by": b_by,
               "bytes": nbytes, "flops": flops}
        extra = ""
        if flash is not None:  # the prefill rows: held to the plain version here too
            fq, fk, fv, fkw = flash
            err = held_prefill(f"row {name}", kern(), plain(), fq, fk, fv, **fkw)
            other, other_ms = other_body_ms(fq, fk, fv, **fkw)
            row |= {"max_abs_err": err, "plan": flash_plan(fq, fk), f"{other}_body_ms": other_ms}
            extra = f"; max abs err {err:.3e}; the {other} body {other_ms:.4f} ms; {row['plan']}"
        rows[name] = row
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms ({lib_name})"
        print(f"[kernels] row {name}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
              f"ms, library {lib}, bound {b_ms:.6f} ms ({b_by}, {nbytes} bytes, "
              f"{flops:.0f} flops), {row['ms'] / b_ms:.1f}x bound" + extra)
    print("[kernels] rows " + json.dumps(rows))
    return rows


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
    """The prefill kernel's plan for these inputs: body, tiling, grid,
    key splits."""
    from repro_torch.kernels import flash_attention as FA

    p = FA.plan_flash(q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], q.dtype,
                      sk=k.shape[1])
    if p.body == "wg":
        return (f"plan: wg body, blocks of {p.block_rows} rows ({p.warps} warps), key tiles "
                f"of {p.key_tile}, {p.key_splits} key split(s) of "
                f"{FA.tiles_per_split(p, k.shape[1])} tiles, "
                f"grid {p.grid} = {p.blocks} blocks")
    return (f"plan: {p.body} body, {p.key_splits} key split(s) a block of {p.warps} warps, "
            f"{p.key_tile}-key softmax steps, grid {p.grid} = {p.blocks} blocks")


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x``."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def held_prefill(label: str, got, want, q, k, v, **kw) -> float:
    """A bf16 prefill row's output held to the plain version ``want``
    within 2 bf16 ulps of max|want| (each rounds once to bf16; P's rounding
    per key tile moves less) and, on a tensor-core body, to that body's
    emulation (``ref.flash_attention_tc_plain`` at the plan's key tile and
    splits: the same roundings, f32 sums in another order) within 2 ulps of
    its max, the card tests' rule: a key left unmasked past Sk, or splits
    combined wrongly, move the output by more.  Returns the max abs error
    against the plain version."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    lim = 2 * bf16_ulp(want.abs().max().item())
    check(err <= lim, f"{label}: max abs err {err} against the plain version > {lim}")
    plan = FA.plan_flash(q.shape[0], q.shape[1], q.shape[2], k.shape[2], q.shape[3], q.dtype,
                         sk=k.shape[1])
    if plan.body in ("tc", "wg"):
        emul = ref.flash_attention_tc_plain(q, k, v, key_tile=plan.key_tile,
                                            key_splits=plan.key_splits,
                                            contiguous=plan.body == "wg", **kw).float()
        e_err = (got - emul).abs().max().item()
        e_lim = 2 * bf16_ulp(emul.abs().max().item())
        check(e_err <= e_lim, f"{label}: max abs err {e_err} against the {plan.body} body's "
                              f"emulation > {e_lim}")
    return err


def other_body_ms(q, k, v, **kw) -> tuple[str, float]:
    """The device time of the bf16 tensor-core body that ``plan_flash`` does
    not pick for these inputs (``tc`` or ``wg``, with its own tiling), on
    the same inputs: the crossover's evidence in the same call."""
    from repro_torch.kernels import flash_attention as FA

    b, sq, h, hd = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    body = FA.plan_flash(b, sq, h, hkv, hd, q.dtype, sk=sk).body
    other = (FA.tc_plan(b, sq, h, hkv) if body == "wg"
             else FA.wg_plan(b, sq, h, hkv, hd, sk=sk))
    kw = dict(causal=True, window=0, softcap=0.0, q_offset=0, prefix_len=0) | kw
    return other.body, device_ms(functools.partial(FA._launch, q, k, v, None, plan=other, **kw),
                                 iters=QUEUED)


def prefill_long_context(scale) -> None:
    """The prefill kernel, bf16, at the serve's chunk (Sq 64 at q_offset 64)
    and at a long context (Sq 64 at q_offset LONG_Q_OFFSET), beside SDPA and
    the bound, each first held against the plain version and its body's
    emulation (``held_prefill``); the long context's split plan also with
    the lse the combine writes, against the plain logsumexp (1e-3 of its
    largest magnitude, as the card tests).  Printed only: the kernels JSON
    keeps the serve shape's numbers."""
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
        err = held_prefill(f"flash_attention q_offset {off}", kern(), want, q, k, v,
                           scale=scale, q_offset=off)
        if off == LONG_Q_OFFSET:
            _, lse = FA.flash_attention_lse(q, k, v, scale=scale, q_offset=off)
            _, want_lse = FA.flash_attention_lse_plain(q, k, v, scale=scale, q_offset=off)
            lse_err = (lse - want_lse).abs().max().item()
            check(lse_err <= 1e-3 * want_lse.abs().max().item(),
                  f"flash_attention q_offset {off}: lse max abs err {lse_err}")
        ms = device_ms(kern, iters=QUEUED)
        other, other_ms = other_body_ms(q, k, v, scale=scale, q_offset=off)
        print(f"[kernels] flash_attention Sq=64 q_offset={off} (Sk {off + 64}): "
              f"kernel {ms:.4f} ms, library {lib_ms:.4f} ms ({ms / lib_ms:.2f}x), "
              f"bound {b_ms:.6f} ms ({b_by}, {nbytes} bytes, {flops:.0f} flops), "
              f"{ms / b_ms:.1f}x bound; the {other} body {other_ms:.4f} ms; max abs err "
              f"{err:.3e}; {flash_plan(q, k)}")


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


def snapshot_prompts(vocab: int, lens=PROMPT_LENS) -> list[np.ndarray]:
    """PROMPT_LENS (or ``lens``) again, every prompt longer than SNAP_HEAD
    starting with one shared SNAP_HEAD-token head (the shorter ones
    random)."""
    rng = np.random.default_rng(3)
    head = rng.integers(0, vocab, SNAP_HEAD, dtype=np.int32)
    return [np.concatenate([head, rng.integers(0, vocab, n - SNAP_HEAD, dtype=np.int32)])
            if n > SNAP_HEAD else rng.integers(0, vocab, n, dtype=np.int32)
            for n in lens]


def reserved_gib() -> float:
    """``torch.cuda.memory_reserved()`` after a collection and an
    ``empty_cache``, in GiB: what live tensors and graph pools hold."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


RESERVED_SLACK_GIB = 0.0625


def check_engines_freed(cfg, params, reqs, label: str, n: int = 3) -> None:
    """An engine's graphs, graph pool and caches go with it: ``n`` more
    serves of ``reqs``, each engine dropped as it returns, must leave
    ``memory_reserved`` (after a collection and an ``empty_cache``) where it
    was before them, within RESERVED_SLACK_GIB."""
    before = reserved_gib()
    after = []
    for _ in range(n):
        serve(cfg, params, "cuda", reqs)
        after.append(reserved_gib())
    print(f"[graphs] {label}: memory_reserved {before:.3f} GiB before {n} more serves, "
          f"{[round(a, 3) for a in after]} GiB after each (each engine dropped)")
    check(max(after) <= before + RESERVED_SLACK_GIB,
          f"{label}: memory_reserved grew from {before:.3f} to {max(after):.3f} GiB over "
          f"{n} serves whose engines were dropped")


def evict_readmit_oldest(eng) -> None:
    """Evict the oldest active request and readmit it at once."""
    check(bool(eng.active_slots), "no active request to evict")
    eng.readmit(eng.evict(eng.active_slots[0].uid))


def serve(cfg, params, device, reqs, *, drafter=None, paged=True, eager=False, encs=None,
          tracer=None, slo=None, prepare=None, mid=None, plan=None, **extra):
    """Serve ``reqs`` on ``device`` over a paged pool (or, with
    ``paged=False``, the contiguous slot cache) with ServeConfig options
    ``extra``; returns (engine, tokens per request, admission logits per
    request, per-tick seconds, wall seconds).  After the run the prefix
    registry (with sharing) is saved to its store, if one is set, and
    dropped, so the pool check sees every page back.  The engine also keeps the
    seconds of each state snapshot it stored (its device-to-host copy) and
    of each evict and readmit (host clock around a synchronize).  On the
    card every step replays its CUDA graph; ``eager`` takes the engine's
    capture backend away, so the card runs the step functions eagerly (the
    yardstick the graphs are held to).  A full-width card serve prints its
    graphs captured, replays, capture ms and ``memory_reserved`` before and
    after it.  ``encs``: each request's encoder input (whisper), whose
    encode the engine times (host clock around a synchronize); ``tracer``
    and ``slo``: the engine's (``repro_torch.obs``); ``plan``: a tuned plan
    the engine applies to the ServeConfig (``repro_torch.tuning``);
    ``prepare(engine)``
    runs before the requests are submitted, ``mid(engine)`` after 3
    scheduling steps (``evict_readmit_oldest``, a stage probe)."""
    from repro_torch.runtime.serving import ServeConfig, StreamedBatchEngine

    class Engine(StreamedBatchEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            if eager:
                self.graphs.capture = None
            self.logits, self.ticks, self.snapshot_s = {}, [], []
            self.evict_s, self.readmit_s, self.encode_s = [], [], []
            single = self.servable.single
            if cfg.is_encoder_decoder:
                encode = single.encode
                single.encode = lambda x: self._synced(encode, self.encode_s, x)
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

    full = device == "cuda" and cfg.n_layers > 2
    before = reserved_gib() if full else 0.0
    max_seq = -(-(max(PROMPT_LENS) + NEW_TOKENS) // BLOCK) * BLOCK
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS,
                       max_batch=SLOTS, block_size=BLOCK, paged=paged, **extra)
    eng = Engine(cfg, params, scfg, device=device, drafter=drafter, tracer=tracer, slo=slo,
                 plan=plan)
    if prepare is not None:
        prepare(eng)
    t0 = time.perf_counter()
    uids = [eng.submit(p) if encs is None else eng.submit(p, enc_inputs=e)
            for p, e in zip(reqs, encs if encs is not None else [None] * len(reqs))]
    if mid is not None:
        for _ in range(3):
            eng.step()
        mid(eng)
    out = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if full:
        after = reserved_gib()
        g = eng.graphs
        print(f"[graphs] {cfg.name} {'paged' if paged else 'contiguous'} "
              f"{json.dumps(extra, default=str)}: {g.captured} graphs captured, {g.replays} "
              f"replays, capture {g.capture_s * 1e3:.1f} ms; memory_reserved {before:.3f} GiB "
              f"before, {after:.3f} GiB after")
    if eng.paged:
        eng.save_prefixes()  # with a prefix store; a no-op without one
        eng.kv.clear_prefixes()  # the registry's retained pages, with sharing
        check(eng.kv.pages_in_use == 0, f"{extra}: {eng.kv.pages_in_use} pages left in use")
        eng.kv.check_invariants()
    # The timing hook closes over the engine: drop it so the engine and its
    # device caches are freed as soon as the caller lets go of them (else
    # they wait for the garbage collector and inflate the next serve's peak).
    del eng.servable.maybe_snapshot
    if cfg.is_encoder_decoder:
        del eng.servable.single.encode
    return (eng, [out[u] for u in uids], [eng.logits[u] for u in uids], eng.ticks, wall)


def graph_vs_eager(label, graphed, eager) -> None:
    """Hold a graphed card serve against the same serve with the card's
    eager step functions: greedy tokens identical, admission logits within
    the card-vs-CPU tolerance; prints whether they are bit-equal."""
    (_, tok_g, log_g, _, _), (_, tok_e, log_e, _, _) = graphed, eager
    for i, (a, b) in enumerate(zip(tok_g, tok_e)):
        check(np.array_equal(a, b), f"{label} request {i}: graphed {a} != eager {b}")
    for i, (a, b) in enumerate(zip(log_g, log_e)):
        check(torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
              f"{label} request {i}: graphed vs eager logits differ by "
              f"{(a - b).abs().max().item():.3e}")
    worst = max((a - b).abs().max().item() for a, b in zip(log_g, log_e))
    bit = all(torch.equal(a, b) for a, b in zip(log_g, log_e))
    print(f"[graphs] {label}: graphed card serve vs eager card serve: greedy tokens "
          f"identical, admission logits {'bit-equal' if bit else f'max abs diff {worst:.3e}'}"
          f" ({graphed[0].graphs.replays} replays, {eager[0].graphs.replays} eager)")


def phase_card_vs_cpu() -> None:
    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(qwen3_4b.CONFIG, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    cpu_params = T.init_params(cfg, 0, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")

    reqs = prompts(cfg.vocab_size)
    graphed = serve(cfg, gpu_params, "cuda", reqs)
    _, tok_gpu, log_gpu, _, wall_gpu = graphed
    _, tok_cpu, log_cpu, _, wall_cpu = serve(cfg, cpu_params, "cpu", reqs)
    graph_vs_eager("qwen3 2-layer f32 paged", graphed,
                   serve(cfg, gpu_params, "cuda", reqs, eager=True))
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
        graphed = serve(cfg, gpu_params, "cuda", reqs, **kw)
        eng_g, tok_g, log_g, _, wall_g = graphed
        eng_c, tok_c, log_c, _, wall_c = serve(cfg, cpu_params, "cpu", reqs, **kw)
        graph_vs_eager(f"mamba2 2-layer f32 {label}", graphed,
                       serve(cfg, gpu_params, "cuda", reqs, eager=True, **kw))
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


class Launches(dict):
    """Each kernel's launches (name -> count) read from ``counters``, and in
    ``by_body`` the prefill kernel's by body (its ``parts``)."""

    def __init__(self, counters: dict):
        from repro_torch.kernels import flash_attention as FA

        super().__init__({name: c.launches for name, c in counters.items()})
        parts = counters["flash_attention"].parts
        self.by_body = {b: parts.get(b, 0) for b in FA.BODIES}


def zero_counters() -> dict:
    """Every kernel's launch count set to 0; returns the counters."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
        c.parts.clear()
    return counters


def fold_launches(res: dict, launches: Launches) -> None:
    """A measured run's launches join the earlier phases' in the kernels line
    (a kernel that no phase has launched yet starts from 0); the prefill
    kernel's are also counted by body."""
    for name, n in launches.items():
        if n:
            res[name]["launches"] = res[name].get("launches", 0) + n
    by_body = res["flash_attention"].setdefault("launches_by_body", {})
    for body, n in launches.by_body.items():
        by_body[body] = by_body.get(body, 0) + n


def expected_launches(cfg, eng) -> dict:
    """The launches a serve on ``eng`` makes, from its counters: each tick
    and chunk launches its kernel once per layer: the single-token entry
    per plain tick, the draft-block entry per verify tick (the
    fused-dequant pair over quantized pages; none over the contiguous
    cache, whose decode is torch ops), the prefill kernel per chunk, and
    nothing else; the SSD kernel once per mamba layer per prefill chunk; a
    whisper chunk's cross-attention launches the prefill kernel once more a
    layer, and its encode once per encoder layer an admission
    (cross-attention decode is torch ops)."""
    want = {name: 0 for name in KERNELS}
    r = cfg.n_repeats
    n_attn = r * sum(s.mixer in ("attn", "attn_local") for s in cfg.layer_unit)
    n_cross = r * sum(s.cross_attn for s in cfg.layer_unit)
    want["ssd"] = r * sum(s.mixer == "mamba" for s in cfg.layer_unit) * eng.prefill_chunks
    q = "_quant" if eng.scfg.kv_dtype != "fp32" else ""
    if eng.paged and n_attn:  # contiguous decode is torch ops (decode_attention)
        want[f"paged_attention{q}"] = n_attn * (eng.decode_steps - eng.spec_ticks)
        want[f"paged_attention_multi{q}"] = n_attn * eng.spec_ticks
    want["flash_attention"] = ((n_attn + n_cross) * eng.prefill_chunks
                               + cfg.n_encoder_layers * eng.admissions)
    return want


def count_launches(label: str, run, want):
    """``run()`` with every launch count set to 0 just before it; checks the
    counts read just after against ``want(result)``.  Returns (result,
    counts)."""
    counters = zero_counters()
    out = run()
    launches = Launches(counters)
    expect = want(out)
    check(launches == expect, f"{label}: launches {launches} != {expect}")
    check(sum(launches.by_body.values()) == launches["flash_attention"],
          f"{label}: prefill launches by body {launches.by_body} do not sum to "
          f"{launches['flash_attention']}")
    return out, launches


def counted_run(res: dict, label: str, run, want):
    """``count_launches`` with the peak memory reset just before the run;
    the counts join the kernels line.  Returns (result, counts, peak GB)."""
    torch.cuda.reset_peak_memory_stats()
    out, launches = count_launches(label, run, want)
    fold_launches(res, launches)
    return out, launches, torch.cuda.max_memory_allocated() / 1e9


def check_graphed(eng, label: str) -> None:
    """The serve's launch counts include the graphs' replays
    (runtime/graphs.py adds a graph's captured launches at each replay):
    every tick after a key's first replays a graph."""
    check(eng.graphs.replays > 0 and eng.graphs.captured > 0,
          f"{label}: {eng.graphs.captured} graphs captured, {eng.graphs.replays} replays")


def counted_serve(cfg, params, reqs, **kw):
    """One serve on the card with every launch count set to 0 just before
    it; returns serve()'s tuple and the counts read just after, which must
    be ``expected_launches``."""
    label = json.dumps({k: v for k, v in kw.items() if k != "encs"}, default=str)
    out, launches = count_launches(label, lambda: serve(cfg, params, "cuda", reqs, **kw),
                                   lambda out: expected_launches(cfg, out[0]))
    check_graphed(out[0], label)
    return out, launches


def time_chunk(eng, reqs) -> tuple[float, float]:
    """One 64-token chunk at q_offset 64 on its own, timed with a
    synchronize: the engine's graph of that key (captured in the serve),
    replayed, and the same step run eagerly.  A fused chunk's writes go to
    the trash page (an all-zero table row); a b=1 chunk (not fused) writes
    the request cache, which the next admission zeroes.  Returns the medians
    (ms) of 4 runs after one."""
    piece = reqs[0][None, 64:128]
    if eng.paged and eng.scfg.fused_prefill:
        graph = eng.servable.single._fused_chunk_fn(64, 64, eng.kv.pools)
        inputs = dict(tokens=piece, page_table=np.zeros((1, 8), np.int32))
    else:
        graph = eng.servable.single._prefill_chunk_fn(64, False, 64)
        inputs = dict(tokens=piece)
    t_chunk, t_eager = [], []
    for _ in range(5):
        for times, run in ((t_chunk, lambda: graph(**inputs)),
                           (t_eager, lambda: graph.fn(**graph.inputs))):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    return float(np.median(t_chunk[1:]) * 1e3), float(np.median(t_eager[1:]) * 1e3)


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
    check_engines_freed(cfg, params, reqs, "qwen3-4b fused paged")

    chunk_ms, chunk_eager_ms = time_chunk(eng, reqs)
    n_tok = sum(len(t) for t in toks)
    e2e = {"tokens": n_tok, "wall_s": wall, "tokens_per_s": n_tok / wall,
           "decode_ticks": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
           "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
           "prefill_chunk_ms": chunk_ms, "prefill_chunk_eager_ms": chunk_eager_ms,
           "graphs_captured": eng.graphs.captured, "graph_replays": eng.graphs.replays,
           "launches": launches, "page_bytes": eng.kv.page_bytes,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"[main] {len(reqs)} requests x {NEW_TOKENS} new tokens: {n_tok} tokens in "
          f"{wall:.3f}s = {e2e['tokens_per_s']:.1f} tok/s; decode tick p50 "
          f"{e2e['decode_tick_ms_p50']:.2f} ms over {eng.decode_steps} ticks; prefill "
          f"chunk (64 tokens at q_offset 64) {e2e['prefill_chunk_ms']:.2f} ms graphed, "
          f"{e2e['prefill_chunk_eager_ms']:.2f} ms eager; "
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
        fold_launches(res, launches)
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
            pressured = (toks, row["tokens_per_s"])
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
    # Phase 12 serves the same requests in the same pool, sanitized.
    out["pressured_tokens"], out["pressured_tokens_per_s"] = pressured
    return out


# Phase 5c's pressured shared pool: prompts that all start with the
# SNAP_HEAD head, in a pool of SHARE_PRESSURE_BLOCKS blocks (trash
# included).  The pressure drops the registry and preempts once, a later
# sharer registers the head again, and the victim's readmission re-maps it
# (a CPU run of the engine at these lengths, chunk, slots and pages: 1
# preemption, 1 readmission re-mapping 4 pages; the count follows from the
# lengths alone).
SHARE_PRESSURE_LENS = (128, 100, 77, 128, 80, 72)
SHARE_PRESSURE_BLOCKS = 19
TEMPERATURE = 0.8
SAMPLER_DRAWS = 20_000
TV_MAX = 0.05  # the reference's bound on a sampler's total variation distance


def _tv(draws: torch.Tensor, p: torch.Tensor) -> float:
    got = torch.bincount(draws.reshape(-1).long(), minlength=p.numel()).double()
    return 0.5 * (got / draws.numel() - p.double().cpu()).abs().sum().item()


def sampler_checks() -> dict:
    """The sampler on the card: its stream keys and uniforms bit-equal to
    the CPU's; SAMPLER_DRAWS draws over one 64-way logits row and the first
    token of verify_sampled against softmax(l / T) (TV < TV_MAX); the
    verify step's acceptance rate within 0.02 of p(d)."""
    from repro_torch.models import transformer as T
    from repro_torch.runtime import sampling
    from repro_torch.runtime.spec import verify_sampled

    n = SAMPLER_DRAWS
    uids = torch.arange(n, dtype=torch.int64) % 97
    steps = torch.arange(n, dtype=torch.int64) // 97
    for tag in (0, 1, 2):
        kc = sampling.stream_keys(uids, steps, tag=tag)
        kg = sampling.stream_keys(uids.cuda(), steps.cuda(), tag=tag)
        check(torch.equal(kg.cpu(), kc), f"stream keys (tag {tag}) differ card vs CPU")
        check(torch.equal(sampling.uniforms(kg[:512], 4096).cpu(),
                          sampling.uniforms(kc[:512], 4096)), "uniforms differ card vs CPU")
    g = torch.Generator().manual_seed(5)
    raw = torch.randn(64, generator=g) * 1.5
    want = torch.softmax(raw.double() / TEMPERATURE, 0)
    picks = T.sample_tokens(raw.cuda().expand(n, 64), temperature=TEMPERATURE,
                            uids=uids.cuda(), steps=steps.cuda())
    tv_sample = _tv(picks.cpu(), want)
    check(tv_sample < TV_MAX, f"sampler TV {tv_sample}")
    raw4 = torch.tensor([0.3, -0.2, 1.1, 0.0])
    logits = raw4.expand(n, 3, 4).contiguous().cuda()
    draft = torch.zeros((n, 2), dtype=torch.int32, device="cuda")
    d_len = torch.full((n,), 2, dtype=torch.int32, device="cuda")
    emit, n_acc = verify_sampled(logits, draft, d_len, uids.cuda(), steps.cuda(), TEMPERATURE)
    p = torch.softmax(raw4.double() / TEMPERATURE, 0)
    tv_verify = _tv(emit[:, 0].cpu(), p)
    accept = (n_acc >= 1).double().mean().item()
    check(tv_verify < TV_MAX, f"verify_sampled first-token TV {tv_verify}")
    check(abs(accept - p[0].item()) < 0.02, f"acceptance {accept} vs p(d) {p[0].item()}")
    out = {"sampler_tv": tv_sample, "verify_first_token_tv": tv_verify,
           "verify_acceptance": accept, "p_draft": p[0].item(), "draws": n}
    print(f"[share] sampler on the card: keys and uniforms bit-equal to the CPU's; {n} draws "
          f"over a 64-way row at T={TEMPERATURE}: TV {tv_sample:.4f}; verify_sampled first "
          f"token TV {tv_verify:.4f}, acceptance {accept:.4f} vs p(d) {p[0].item():.4f} "
          f"(TV < {TV_MAX}, |acc - p(d)| < 0.02)")
    return out


def phase_sharing_sampling(res: dict, main: tuple) -> dict:
    """Phase 5c: prefix sharing with copy-on-write and temperature sampling.
    (a) the full 36-layer bf16 qwen3-4b of phase 5 (``main``): the
    head-sharing prompts with and without sharing (hits, pages shared,
    chunks, peak pages, COW forks, tick p50, tok/s, token agreement);
    (b) the same over int8 pages, and a COW fork of a registered int8 page
    (codes and scale rows bit-equal); (c) 2-layer f32 card against CPU:
    shared serves (fused and not) equal to the unshared one with equal
    counters on both devices, a prefix store saved by one engine and
    restored by another, and a pressured shared pool that re-maps on
    readmission; (d) temperature: plain and n-gram spec serves at full
    width, the sampler's statistics, and 2-layer f32 paged against
    contiguous on the card and the card against the CPU."""
    import tempfile

    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T

    out: dict = {}
    _, _, params = main
    cfg = qwen3_4b.CONFIG
    shared_reqs = snapshot_prompts(cfg.vocab_size)

    def measured(label, rq, **kw):
        serve(cfg, params, "cuda", rq, **kw)  # warm-up
        (eng, toks, logits, ticks, wall), launches = counted_serve(cfg, params, rq, **kw)
        for i, (t, lg) in enumerate(zip(toks, logits)):
            check(len(t) == NEW_TOKENS and bool(((t >= 0) & (t < cfg.padded_vocab)).all()),
                  f"{label} request {i}: {t}")
            check(bool(torch.isfinite(lg).all()), f"{label} request {i}: non-finite logits")
        fold_launches(res, launches)
        n = sum(len(t) for t in toks)
        rate = eng.spec_accepted / eng.spec_proposed if eng.spec_proposed else None
        row = {"tokens_per_s": n / wall, "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
               "decode_ticks": eng.decode_steps, "prefill_chunks": eng.prefill_chunks,
               "peak_pages": eng.kv.peak_pages_in_use if eng.paged else None,
               "prefix_hits": eng.prefix_hits, "prefix_pages_shared": eng.prefix_pages_shared,
               "cow_forks": eng.kv.cow_forks if eng.paged else None,
               "verify_ticks": eng.spec_ticks, "acceptance": rate, "launches": launches}
        print(f"[share] {label}: {n} tokens in {wall:.3f}s = {n / wall:.1f} tok/s; tick p50 "
              f"{row['decode_tick_ms_p50']:.2f} ms over {eng.decode_steps} ticks "
              f"({eng.spec_ticks} verify, acceptance {'-' if rate is None else f'{rate:.3f}'})"
              f"; {eng.prefill_chunks} chunks; peak pages {row['peak_pages']}; prefix hits "
              f"{eng.prefix_hits}, pages shared {eng.prefix_pages_shared}, cow_forks "
              f"{row['cow_forks']}; launches {launches}")
        return eng, toks, row

    # (a), (b): full width, bf16 and int8 pools, unshared then shared.
    for kd in ("fp32", "int8"):
        _, base, out[f"{kd} unshared"] = measured(f"{kd} pool, unshared", shared_reqs,
                                                  kv_dtype=kd)
        eng, toks, row = measured(f"{kd} pool, shared", shared_reqs, kv_dtype=kd,
                                  prefix_sharing=True)
        agree = agreement(toks, base)
        row["agreement_with_unshared"] = agree
        out[f"{kd} shared"] = row
        unshared = out[f"{kd} unshared"]
        check(row["peak_pages"] < unshared["peak_pages"],
              f"{kd}: shared peak {row['peak_pages']} !< unshared {unshared['peak_pages']}")
        check((row["prefix_hits"], row["prefix_pages_shared"]) == (3, 12),
              f"{kd}: prefix hits / pages {row['prefix_hits']} / {row['prefix_pages_shared']}, "
              "want 3 / 12")
        check(agree >= 0.8 if kd == "fp32" else agree >= QUANT_FLOOR,
              f"{kd}: shared vs unshared agreement {agree}")
        print(f"[share] {kd} pool: shared vs unshared per-uid token agreement {agree:.4f}; "
              f"chunks {unshared['prefill_chunks']} -> {row['prefill_chunks']}, peak pages "
              f"{unshared['peak_pages']} -> {row['peak_pages']}")
    # (b) a COW fork of a registered int8 page on the card: refill the
    # shared engine's registry (serve() dropped it) with one admission.
    kv = eng.kv
    eng.submit(shared_reqs[0])
    eng.run()
    blk = kv.registry.entries()[0][1][0]
    kv.map_shared(0, [blk])  # refcount 2: the registry and slot 0
    check(kv.ensure_write(0, 3), "int8 COW fork: no free page")
    fork = kv.slot_pages(0)[0]
    for c in kv.pools["blocks"].values():
        for key in ("k", "v", "k_scale", "v_scale"):
            check(torch.equal(c[key][:, fork], c[key][:, blk]),
                  f"int8 COW fork: {key} of page {fork} != page {blk}")
    kv.release(0)
    kv.clear_prefixes()
    kv.check_invariants()
    print(f"[share] int8 COW fork on the card: page {blk} -> {fork}, codes and scale rows "
          f"bit-equal over {cfg.n_layers} layers")

    # (c) 2-layer f32, card against CPU.
    small = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    cpu_params = T.init_params(small, 0, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    reqs = snapshot_prompts(small.vocab_size)
    _, plain, _, _, _ = serve(small, gpu_params, "cuda", reqs)

    def counters(e):
        return (e.prefix_hits, e.prefix_pages_shared, e.kv.cow_forks, e.kv.peak_pages_in_use,
                e.kv.registry.hits, e.kv.registry.misses, e.prefill_chunks,
                e.readmit_prefix_hits, e.readmit_prefix_pages, e.preemptions)
    for label, kw in (("fused", {}), ("non-fused", dict(fused_prefill=False))):
        eg, tg, _, _, _ = serve(small, gpu_params, "cuda", reqs, prefix_sharing=True, **kw)
        ec, tc, _, _, _ = serve(small, cpu_params, "cpu", reqs, prefix_sharing=True, **kw)
        for i, (a, b, c) in enumerate(zip(tg, tc, plain)):
            check(np.array_equal(a, b), f"shared {label} request {i}: card {a} != CPU {b}")
            check(np.array_equal(a, c), f"shared {label} request {i}: {a} != unshared {c}")
        check(counters(eg) == counters(ec), f"shared {label}: counters card {counters(eg)} "
              f"!= CPU {counters(ec)}")
        print(f"[share] 2-layer f32 shared ({label}): tokens equal card vs CPU and to the "
              f"unshared serve; counters (hits, pages, forks, peak, registry hits/misses, "
              f"chunks, ...) {counters(eg)} on both devices")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "prefixes.npz")
        cold, tcold, _, _, _ = serve(small, gpu_params, "cuda", reqs, prefix_sharing=True,
                                     prefix_store=store)
        warm, twarm, _, _, _ = serve(small, gpu_params, "cuda", reqs, prefix_sharing=True,
                                     prefix_store=store)
    check(cold.prefixes_restored == 0 < warm.prefixes_restored,
          f"prefix store: restored {cold.prefixes_restored}, then {warm.prefixes_restored}")
    check(all(np.array_equal(a, b) for a, b in zip(twarm, tcold)),
          "the restored serve's tokens differ from the cold serve's")
    print(f"[share] prefix store: {warm.prefixes_restored} entries restored by a second "
          f"engine, prefix hits {cold.prefix_hits} -> {warm.prefix_hits}, tokens equal to "
          f"the cold serve")
    pressed = snapshot_prompts(small.vocab_size, SHARE_PRESSURE_LENS)
    _, free, _, _, _ = serve(small, gpu_params, "cuda", pressed, prefix_sharing=True)
    eg, tg, _, _, _ = serve(small, gpu_params, "cuda", pressed, prefix_sharing=True,
                            num_blocks=SHARE_PRESSURE_BLOCKS)
    ec, tc, _, _, _ = serve(small, cpu_params, "cpu", pressed, prefix_sharing=True,
                            num_blocks=SHARE_PRESSURE_BLOCKS)
    check(eg.preemptions >= 1 and eg.readmit_prefix_hits > 0,
          f"pressured shared pool: {eg.preemptions} preemptions, "
          f"{eg.readmit_prefix_hits} readmission re-maps")
    check(counters(eg) == counters(ec), f"pressured shared pool: counters card "
          f"{counters(eg)} != CPU {counters(ec)}")
    for i, (a, b, c) in enumerate(zip(tg, tc, free)):
        check(np.array_equal(a, b), f"pressured shared request {i}: card {a} != CPU {b}")
        check(np.array_equal(a, c), f"pressured shared request {i}: {a} != unpressured {c}")
    out["pressured"] = {"num_blocks": SHARE_PRESSURE_BLOCKS, "preemptions": eg.preemptions,
                        "readmit_prefix_hits": eg.readmit_prefix_hits,
                        "readmit_prefix_pages": eg.readmit_prefix_pages}
    print(f"[share] 2-layer f32 pool of {SHARE_PRESSURE_BLOCKS} blocks with sharing: "
          f"{eg.preemptions} preemptions, {eg.readmit_prefix_hits} readmissions re-mapped "
          f"{eg.readmit_prefix_pages} pages, on the card and the CPU; tokens equal card vs "
          f"CPU and to the unpressured serve")

    # (d) temperature.
    out["sampler"] = sampler_checks()
    toks_t = {}
    for label, kw in (("contiguous", dict(paged=False)), ("paged", {})):
        _, toks_t[label], _, _, _ = serve(small, gpu_params, "cuda", reqs,
                                          temperature=TEMPERATURE, **kw)
    _, t_cpu, _, _, _ = serve(small, cpu_params, "cpu", reqs, temperature=TEMPERATURE)
    for i, (a, b) in enumerate(zip(toks_t["paged"], toks_t["contiguous"])):
        check(np.array_equal(a, b), f"temperature request {i}: paged {a} != contiguous {b}")
    vs_cpu = agreement(toks_t["paged"], t_cpu)
    out["temperature_card_vs_cpu_agreement"] = vs_cpu
    print(f"[share] 2-layer f32 at T={TEMPERATURE}: tokens equal paged vs contiguous on the "
          f"card; card vs CPU agreement {vs_cpu:.4f}")
    del gpu_params
    # Full width at temperature: a plain serve, and spec serves with n-gram
    # drafts and with the greedy serve's tokens as drafts (the random
    # weights' next-token distribution is nearly flat at T, so sampled
    # tokens rarely repeat an n-gram: the oracle drafts make the verify
    # step rejection-sample on the card whatever the n-gram drafter finds).
    tiled = tiled_prompts(cfg.vocab_size)
    spec = dict(spec_decode=True, spec_k=SPEC_K)
    _, greedy, out["greedy, n-gram spec"] = measured("greedy, n-gram spec (tiled prompts)",
                                                     tiled, **spec)
    for label, kw in ((f"T={TEMPERATURE}, plain", {}), (f"T={TEMPERATURE}, n-gram spec", spec),
                      (f"T={TEMPERATURE}, spec, greedy tokens as drafts",
                       dict(spec, drafter=OracleDrafter(tiled, greedy)))):
        eng, _, out[label] = measured(f"{label} (tiled prompts)", tiled,
                                      temperature=TEMPERATURE, **kw)
    check(eng.spec_ticks > 0, "the temperature serve with drafts ran no verify tick")
    print("[share] serves " + json.dumps(out))
    return out


# -- phase 10: observability and the serving policy --------------------------------

# The SLO of phase 10's serves, in multiples of phase 5's untraced tick p50:
# a request's TTFT (queue wait included) within SLO_TTFT_TICKS ticks, its
# worst inter-token gap within SLO_ITL_TICKS.
SLO_TTFT_TICKS, SLO_ITL_TICKS = 25, 3
OBS_TRACE = ROOT / "build" / "obs_trace.json"  # phase 10a's Chrome trace (git-ignored)


def span_seq(spans) -> list:
    """(track, name, arguments but the queue wait's seconds) of each span."""
    return [(s.track, s.name, {k: v for k, v in s.args.items() if k != "queue_wait_s"})
            for s in spans]


def live_state(eng) -> list:
    """Every leaf of the engine's pool or contiguous slot cache."""
    tree = eng.kv.pools if eng.paged else eng.caches
    return [leaf for c in tree["blocks"].values() for leaf in c.values()]


def pool_graphs(eng) -> list:
    """The step graphs that hold the engine's pool: the ticks, the fused
    chunks and the pool's page moves."""
    out = [eng._decode] + ([eng._verify] if eng._verify is not None else [])
    out += [g for k, g in eng.servable.single._chunk_jit.items() if k[0] == "fused"]
    for cache in (eng.kv._scatter_jit, eng.kv._gather_jit, eng.kv._load_jit):
        out += [g for g in cache.values() if g is not None]
    return out


def observe_anew(eng, *, tracer=None, slo=None) -> None:
    """A fresh registry (the counters restart at 0), tracer and SLO policy
    for ``eng``'s next serve."""
    from repro_torch.obs import MetricsRegistry, Tracer

    eng.obs = tracer if tracer is not None else Tracer(enabled=False)
    eng.metrics, eng.slo, eng.prefill_chunks = MetricsRegistry(), slo, 0


def serve_again(res: dict, label: str, cfg, eng, reqs):
    """``reqs`` once more on ``eng`` (a ``serve`` engine), its launch counts
    at 0 just before and held to ``expected_launches`` after (they join the
    kernels line); returns (tokens per request, wall s, counts).  Its tick
    times go to ``eng.ticks``, cleared first."""
    def run():
        eng.ticks.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        uids = [eng.submit(p) for p in reqs]
        out = eng.run()
        torch.cuda.synchronize()
        return [out[u] for u in uids], time.perf_counter() - t0
    (toks, wall), launches = count_launches(label, run, lambda _: expected_launches(cfg, eng))
    fold_launches(res, launches)
    return toks, wall, launches


def latency_lines(tag: str, tls) -> list[dict]:
    """Print one line a request of its reconstructed timeline: queue wait,
    TTFT, worst and mean ITL, evictions and stall (ms)."""
    rows = [{"uid": t.uid, "queue_wait_ms": t.queue_wait_s * 1e3, "ttft_ms": t.ttft_s * 1e3,
             "itl_max_ms": t.itl_max_s * 1e3, "itl_mean_ms": t.itl_mean_s * 1e3,
             "evictions": t.evictions, "stall_ms": t.stall_s * 1e3, "tokens": t.tokens}
            for t in tls]
    for r in rows:
        print(f"[obs] {tag} uid {r['uid']}: queue wait {r['queue_wait_ms']:.2f} ms, TTFT "
              f"{r['ttft_ms']:.2f} ms, ITL max {r['itl_max_ms']:.2f} ms (mean "
              f"{r['itl_mean_ms']:.2f}), {r['evictions']} evictions, stall "
              f"{r['stall_ms']:.2f} ms, {r['tokens']} tokens")
    return rows


def phase_obs_policy(res: dict, main: tuple) -> dict:
    """Phase 10: observability and the serving policy on the full 36-layer
    bf16 qwen3-4b of phase 5 (``main``), its 6 requests, 4 slots, chunk 64,
    pages of 16.  (a) A traced serve with a metrics registry and an
    ``SLOPolicy`` (targets SLO_TTFT_TICKS and SLO_ITL_TICKS x phase 5's
    tick p50) on a fresh engine, then on the same engine warm (one untraced
    serve between): tokens bit-equal to phase 5's untraced serve, no span
    dropped, every span closed after it opened, no live STR002, the launch
    counts of the serve; per request the queue wait, TTFT and worst ITL;
    ITL p50 / p99 / max, SLO attainment and goodput; the warm trace written
    to OBS_TRACE and read back through ``timelines_from_trace``; the
    doctor's findings.  (b) Tracing's cost: tok/s and tick p50 of fresh
    serves untraced and traced, in turns, three each.  (c) The policy:
    ``measure_stage_times(128)`` with the slots active mid serve (every
    pool leaf and the page table unchanged, the serve's tokens phase 5's),
    R, the decision and the plan, the warm trace's overlap against the
    prediction from those stage times; then ``autotune(128)`` on the idle
    engine and a serve on it (tok/s, tick p50, agreement with phase 5's
    tokens, graphs captured before and after; at a new page size no graph
    over the old pool runs again or stays held).  (d) A traced serve in
    phase 5b's pool of PRESSURE_BLOCKS blocks, on a warm engine (one
    untraced serve before it): each request's TTFT and
    worst ITL beside its evictions and stall, the evict / readmit span
    times (the serve's evict and readmit synchronize around them), phase
    5's tokens.  (e) 2-layer full-width f32, card against CPU: the same
    stage times (c's) given to both engines' ``autotune`` make the same
    plan, the traced serves then give the same tokens and the same span
    sequence."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.core import rmetric
    from repro_torch.models import transformer as T
    from repro_torch.obs import (SLOPolicy, Tracer, overlap_report, reconstruct_timelines,
                                 stage_times_from_trace, timelines_from_trace)
    from repro_torch.obs.doctor import diagnose, render
    from repro_torch.runtime.serving import plan_decode_policy

    out: dict = {}
    e2e, paged_toks, params = main
    cfg = qwen3_4b.CONFIG
    reqs = prompts(cfg.vocab_size)
    n_tok = len(reqs) * NEW_TOKENS
    p50 = e2e["decode_tick_ms_p50"] / 1e3
    slo = SLOPolicy(ttft_s=SLO_TTFT_TICKS * p50, itl_s=SLO_ITL_TICKS * p50)
    print(f"[obs] SLO: TTFT <= {SLO_TTFT_TICKS} x {p50 * 1e3:.2f} ms = {slo.ttft_s * 1e3:.2f} "
          f"ms, ITL <= {SLO_ITL_TICKS} x = {slo.itl_s * 1e3:.2f} ms (phase 5's tick p50)")

    def same_tokens(label, toks, want=paged_toks):
        for i, (a, b) in enumerate(zip(toks, want)):
            check(np.array_equal(a, b), f"{label} request {i}: {a} != phase 5's {b}")

    def checked_trace(label, tracer, snap):
        spans = tracer.spans()
        check(spans and tracer.dropped == 0, f"{label}: {len(spans)} spans, "
              f"{tracer.dropped} dropped")
        check(all(s.t1_ns >= s.t0_ns for s in spans), f"{label}: a span ends before it starts")
        live = snap["counters"].get("analysis.str002_live", 0)
        check(live == 0, f"{label}: analysis.str002_live {live}")
        tls = reconstruct_timelines(spans)
        check(len(tls) == len(reqs) and all(t.finished and not t.partial
                                            and t.tokens == NEW_TOKENS for t in tls),
              f"{label}: timelines {[(t.uid, t.tokens, t.finished, t.partial) for t in tls]}")
        return spans, tls

    def summary(label, snap, tls, wall, ticks):
        itl = snap["histograms"]["latency.itl_s"]
        s = snap["derived"].get("slo", {})
        row = {"tokens_per_s": n_tok / wall, "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
               "itl_ms": {k: itl[k] * 1e3 for k in ("p50", "p99", "max")},
               "ttft_ms_p50": float(np.median([t.ttft_s for t in tls]) * 1e3),
               "slo_attainment": s.get("attainment"),
               "goodput_tokens_per_s": s.get("goodput_tokens_per_s"),
               "slo_violations": [s.get("ttft_violations"), s.get("itl_violations")],
               "requests": latency_lines(label, tls)}
        print(f"[obs] {label}: {row['tokens_per_s']:.1f} tok/s, tick p50 "
              f"{row['decode_tick_ms_p50']:.2f} ms; ITL p50 / p99 / max "
              f"{row['itl_ms']['p50']:.2f} / {row['itl_ms']['p99']:.2f} / "
              f"{row['itl_ms']['max']:.2f} ms; TTFT p50 {row['ttft_ms_p50']:.2f} ms"
              + (f"; SLO attainment {s['attainment']:.3f} ({s['met']}/{s['requests']}), goodput "
                 f"{s['goodput_tokens_per_s']:.1f} tok/s, violations TTFT "
                 f"{s['ttft_violations']} ITL {s['itl_violations']}" if s else ""))
        return row

    # (a) traced serves: a fresh engine, then the same engine warm.
    fresh_tr = Tracer()
    (eng, toks, _, ticks, wall), launches = counted_serve(cfg, params, reqs, tracer=fresh_tr,
                                                          slo=slo)
    fold_launches(res, launches)
    same_tokens("traced serve (fresh engine)", toks)
    snap = eng.metrics_snapshot()
    _, tls = checked_trace("fresh engine", fresh_tr, snap)
    out["fresh engine"] = summary("fresh engine", snap, tls, wall, ticks)
    observe_anew(eng)
    serve_again(res, "warm-up serve", cfg, eng, reqs)
    tracer = Tracer()
    observe_anew(eng, tracer=tracer, slo=slo)
    toks, wall, launches = serve_again(res, "traced serve (warm engine)", cfg, eng, reqs)
    same_tokens("traced serve (warm engine)", toks)
    snap = eng.metrics_snapshot()
    spans, tls = checked_trace("warm engine", tracer, snap)
    out["warm engine"] = summary("warm engine", snap, tls, wall, eng.ticks)
    out["warm engine"]["launches"] = launches
    OBS_TRACE.parent.mkdir(exist_ok=True)
    tracer.to_chrome(str(OBS_TRACE))
    back = timelines_from_trace(str(OBS_TRACE))
    check([(t.uid, t.tokens, t.finished) for t in back]
          == [(t.uid, t.tokens, t.finished) for t in tls]
          and all(abs(a.ttft_s - b.ttft_s) < 1e-5 for a, b in zip(back, tls)),
          "the trace file's timelines differ from the trace's")
    findings = diagnose(spans, snapshot=snap)
    check(not any(f.rule == "DOC005" for f in findings), "the doctor found a live STR002")
    print(render(findings, spans=len(spans), requests=len(tls), dropped=tracer.dropped))
    out["doctor"] = [(f.rule, f.severity, f.evidence) for f in findings]
    print(f"[obs] warm trace: {len(spans)} spans, {tracer.dropped} dropped, "
          f"{sum(s.name == 'decode_tick' for s in spans)} decode_tick spans; written to "
          f"{OBS_TRACE.relative_to(ROOT)} and read back ({len(back)} timelines); launches "
          f"{launches}")
    del eng

    # (b) tracing's cost, fresh engines in turns.
    cost = {False: [], True: []}
    for _ in range(3):
        for traced in (False, True):
            _, _, _, tk, w = serve(cfg, params, "cuda", reqs,
                                   tracer=Tracer() if traced else None)
            cost[traced].append((n_tok / w, float(np.median(tk) * 1e3)))
    med = {k: (float(np.median([x[0] for x in v])), float(np.median([x[1] for x in v])))
           for k, v in cost.items()}
    out["tracing cost"] = {"untraced": cost[False], "traced": cost[True],
                           "tok_s_ratio": med[True][0] / med[False][0],
                           "tick_p50_ratio": med[True][1] / med[False][1]}
    print(f"[obs] tracing cost (fresh engines, 3 each in turns): tok/s untraced "
          f"{[round(x[0], 1) for x in cost[False]]}, traced {[round(x[0], 1) for x in cost[True]]}"
          f" (median ratio {out['tracing cost']['tok_s_ratio']:.3f}); tick p50 ms untraced "
          f"{[round(x[1], 2) for x in cost[False]]}, traced {[round(x[1], 2) for x in cost[True]]}"
          f" (ratio {out['tracing cost']['tick_p50_ratio']:.3f})")

    # (c) the policy: a probe with the slots active, then autotune.
    probe = {}

    def probe_live(eng):
        before = [t.clone() for t in live_state(eng)]
        table = eng.kv.page_table.copy()
        probe["active"] = len(eng.active_slots)
        probe["st"] = eng.measure_stage_times(128)
        torch.cuda.synchronize()
        check(probe["active"] > 0, "the probe found no active slot")
        check(all(torch.equal(a, b) for a, b in zip(before, live_state(eng)))
              and np.array_equal(table, eng.kv.page_table),
              "measure_stage_times changed the live pool")
    eng, toks, _, _, _ = serve(cfg, params, "cuda", reqs, mid=probe_live)
    same_tokens("probed serve", toks)
    st = probe["st"]
    decision = rmetric.streaming_decision(st).value
    plan = plan_decode_policy(st, prompt_len=128, max_seq=eng.scfg.max_seq)
    rep = overlap_report(spans, st)
    traced_st = stage_times_from_trace(spans)
    out["policy"] = {"chunk_ms": st.h2d * 1e3, "decode_ms": st.kex * 1e3,
                     "r": st.transfer_ratio(), "decision": decision,
                     "plan": [plan.prefill_chunk, plan.decode_interleave, plan.block_size],
                     "active_slots_at_probe": probe["active"], "overlap": rep,
                     "trace_stage_ms": None if traced_st is None else
                     [traced_st.h2d * 1e3, traced_st.kex * 1e3]}
    m, pr = rep["measured"], rep["predicted"]
    print(f"[obs] stage probe with {probe['active']} slots active: chunk ({min(CHUNK, 128)} "
          f"tokens at 0) "
          f"{st.h2d * 1e3:.3f} ms, decode tick {st.kex * 1e3:.3f} ms, R {st.transfer_ratio():.3f}"
          f", {decision}; plan chunk {plan.prefill_chunk}, interleave {plan.decode_interleave}"
          f", block {plan.block_size}; pool and page table unchanged; the warm trace's overlap "
          f"{m['efficiency']:.3f} measured ({m['hidden_s'] * 1e3:.2f} of "
          f"{m['total_s'] * 1e3:.2f} ms hidden) against {pr['efficiency']:.3f} predicted "
          f"({pr['decision']}, {pr['n_streams']} streams); the trace's own stage estimate "
          + ("none" if traced_st is None else
             f"chunk {traced_st.h2d * 1e3:.3f} ms, tick {traced_st.kex * 1e3:.3f} ms"))
    block0, captured0 = eng.kv.block_size, eng.graphs.captured
    old = pool_graphs(eng)
    tuned = eng.autotune(128)  # its probe runs the old decode graph, then it rebuilds
    old = [(g, g.uses) for g in old]
    captured1 = eng.graphs.captured
    observe_anew(eng)
    toks_t, wall_t, launches_t = serve_again(res, "autotuned serve", cfg, eng, reqs)
    rebuilt = tuned.block_size != block0
    if rebuilt:
        check(eng.kv.block_size == tuned.block_size, "autotune did not rebuild the pool")
        check(all(g.uses == u for g, u in old), "a graph over the old pool ran again")
        held = pool_graphs(eng)
        check(not any(g is h for g, _ in old for h in held), "a graph over the old pool is held")
    check(all(len(t) == NEW_TOKENS for t in toks_t), "autotuned serve: short output")
    out["autotuned"] = {
        "plan": [tuned.decision, tuned.prefill_chunk, tuned.decode_interleave,
                 tuned.block_size],
        "stage_ms": [tuned.stage_times.h2d * 1e3, tuned.stage_times.kex * 1e3],
        "tokens_per_s": n_tok / wall_t, "decode_tick_ms_p50": float(np.median(eng.ticks) * 1e3),
        "prefill_chunks": eng.prefill_chunks, "agreement_with_untuned": agreement(toks_t, paged_toks),
        "graphs_captured": [captured0, captured1, eng.graphs.captured], "launches": launches_t}
    a = out["autotuned"]
    print(f"[obs] autotune(128) on the idle engine: {tuned.decision}, chunk "
          f"{tuned.prefill_chunk}, interleave {tuned.decode_interleave}, block "
          f"{tuned.block_size} (was {block0}; stage times {a['stage_ms'][0]:.3f} / "
          f"{a['stage_ms'][1]:.3f} ms); serve: {a['tokens_per_s']:.1f} tok/s, tick p50 "
          f"{a['decode_tick_ms_p50']:.2f} ms, {eng.prefill_chunks} chunks, agreement with the "
          f"untuned tokens {a['agreement_with_untuned']:.3f}; graphs captured "
          f"{captured0} before, {captured1} after autotune, {eng.graphs.captured} after the "
          f"serve" + ("; the old pool's graphs never ran again and none is held"
                      if rebuilt else "; the page size did not change"))
    del eng, old

    # (d) preemption latency in a pool of PRESSURE_BLOCKS blocks, warm.
    eng = serve(cfg, params, "cuda", reqs, num_blocks=PRESSURE_BLOCKS)[0]
    tr = Tracer()
    observe_anew(eng, tracer=tr, slo=slo)
    toks, wall, launches = serve_again(res, f"traced serve in {PRESSURE_BLOCKS} blocks", cfg,
                                       eng, reqs)
    same_tokens(f"traced serve in {PRESSURE_BLOCKS} blocks", toks)
    check(eng.preemptions >= 2, f"{eng.preemptions} preemptions in {PRESSURE_BLOCKS} blocks")
    snap = eng.metrics_snapshot()
    spans_d, tls = checked_trace("pressured", tr, snap)
    check(any(t.evictions for t in tls), "no timeline shows an eviction")
    out["pressured"] = summary(f"{PRESSURE_BLOCKS} blocks", snap, tls, wall, eng.ticks)
    out["pressured"]["evict_ms"] = [s.dur_s * 1e3 for s in spans_d if s.name == "evict"]
    out["pressured"]["readmit_ms"] = [s.dur_s * 1e3 for s in spans_d if s.name == "readmit"]
    print(f"[obs] {PRESSURE_BLOCKS} blocks: {eng.preemptions} preemptions; evict spans (ms) "
          f"{[round(x, 3) for x in out['pressured']['evict_ms']]}, readmit spans (ms) "
          f"{[round(x, 3) for x in out['pressured']['readmit_ms']]}; tokens equal phase 5's")
    del eng

    # (e) card against CPU at f32: the same plan from the same stage times.
    cfg2 = dataclasses.replace(cfg, n_layers=2, param_dtype=torch.float32,
                               compute_dtype=torch.float32)
    cpu_params = T.init_params(cfg2, 0, device="cpu")
    gpu_params = to_device(cpu_params, "cuda")
    reqs2 = prompts(cfg2.vocab_size)
    runs = {}

    def tune(eng):
        eng.measure_stage_times = lambda n: st
        eng.autotune(128)
    for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        tr = Tracer()
        eng, toks, _, _, _ = serve(cfg2, p, dev, reqs2, tracer=tr, prepare=tune)
        lp = eng.last_plan
        runs[dev] = ((lp.decision, lp.prefill_chunk, lp.decode_interleave, lp.block_size),
                     toks, span_seq(tr.spans()))
    plans = {dev: r[0] for dev, r in runs.items()}
    check(plans["cuda"] == plans["cpu"], f"plans card {plans['cuda']} != CPU {plans['cpu']}")
    for i, (a, b) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
        check(np.array_equal(a, b), f"autotuned 2-layer f32 request {i}: card {a} != CPU {b}")
    check(runs["cuda"][2] == runs["cpu"][2], "autotuned 2-layer f32: the span sequences differ")
    out["card vs cpu"] = {"plan": plans["cuda"], "spans": len(runs["cuda"][2])}
    print(f"[obs] 2-layer full-width f32, autotuned from the probe's stage times: plan "
          f"{plans['cuda']} on both devices; greedy tokens identical card vs CPU; span "
          f"sequences identical ({len(runs['cuda'][2])} spans)")
    del gpu_params, cpu_params, eng
    print("[obs] summary " + json.dumps(out, default=str))
    return out


TUNE_DB = ROOT / "build" / "tuning_smoke.json"  # phase 11's tuning dbs (git-ignored)
TUNE_BUDGET = dict(max_trials=4, sweeps=1, timed_runs=2)
LAUNCHER_TUNE_BUDGET = 3


def calibration(label: str, prof, prompt_len: int, max_seq: int) -> dict:
    """Print one stage profile and the plan ``plan_decode_policy`` makes
    from it; returns both as a row."""
    from repro_torch.runtime.serving import plan_decode_policy

    st = prof.stage_times()
    plan = plan_decode_policy(st, prompt_len=prompt_len, max_seq=max_seq)
    row = {"chunk_ms": prof.chunk_s * 1e3, "decode_ms": prof.decode_s * 1e3,
           "h2d_ms": prof.h2d_s * 1e3, "d2h_ms": prof.d2h_s * 1e3,
           "scatter_ms": prof.scatter_s * 1e3, "gather_ms": prof.gather_s * 1e3,
           "r": st.transfer_ratio(),
           "plan": [plan.decision, plan.prefill_chunk, plan.decode_interleave,
                    plan.block_size]}
    print(f"[tune] {label}: chunk {row['chunk_ms']:.3f} ms, decode tick "
          f"{row['decode_ms']:.3f} ms, H2D {row['h2d_ms']:.4f} ms, D2H "
          f"{row['d2h_ms']:.4f} ms, scatter {row['scatter_ms']:.4f} ms, gather "
          f"{row['gather_ms']:.4f} ms; R {row['r']:.3f} -> {plan.decision}, plan chunk "
          f"{plan.prefill_chunk}, interleave {plan.decode_interleave}, block "
          f"{plan.block_size}")
    return row


def phase_tune(res: dict, main: tuple) -> dict:
    """Phase 11: the measured tuner (``repro_torch.tuning``) on the full
    36-layer bf16 qwen3-4b of phase 5 (``main``), its 6 requests, 4 slots,
    chunk 64, pages of 16.  (a) The calibrations of ``profile_engine`` on an
    idle warm engine: untraced (the synchronized probe) after one serve,
    then traced after its second and after its third serve (the trace's
    stage estimate; the second serve still captures graphs), each with the
    plan ``plan_decode_policy`` makes from it.  (b) ``search_tuned_plan`` with
    TUNE_BUDGET over the prompts' workload descriptor: its log, trials and
    wall, ``memory_allocated`` before and after it (back at its level: every
    trial's engine is dropped), the plan and its tok/s against the analytic
    baseline's.  (c) A serve on ``StreamedBatchEngine(..., plan=plan)``,
    warm, its launches counted: tokens bit-equal to phase 5's (agreement >=
    QUANT_FLOOR for a quantized plan), beside a warm untuned serve (each
    engine's third serve).  (d) A
    ``TuningDB`` put / get whose fingerprint carries the card's name.  (e)
    The launcher with ``--autotune`` twice: searched, then cached."""
    from repro_torch import tuning
    from repro_torch.configs import qwen3_4b
    from repro_torch.launch import serve as launcher
    from repro_torch.obs import Tracer, stage_times_from_trace
    from repro_torch.runtime.serving import ServeConfig

    out: dict = {}
    _, paged_toks, params = main
    cfg = qwen3_4b.CONFIG
    reqs = prompts(cfg.vocab_size)
    desc = tuning.WorkloadDescriptor.from_prompts(reqs, max_new_tokens=NEW_TOKENS)
    max_seq = -(-(max(PROMPT_LENS) + NEW_TOKENS) // BLOCK) * BLOCK
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS,
                       max_batch=SLOTS, block_size=BLOCK, paged=True)
    print(f"[tune] workload: {desc}, bucket {desc.bucket()}")

    # (a) the calibrations on one idle warm engine.
    eng = serve(cfg, params, "cuda", reqs)[0]
    probe = tuning.profile_engine(eng, desc.prompt_len_mean)
    check(eng.kv.pages_in_use == 0, "the profile left pages in use")
    out["probe"] = calibration("probe calibration (untraced, synchronized)", probe,
                               desc.prompt_len_mean, max_seq)
    # The trace of the engine's second serve, then of its third: the second
    # still captures the chunk keys the first ran once, inside admissions.
    for nth in ("second", "third"):
        tracer = Tracer()
        observe_anew(eng, tracer=tracer)
        toks, _, _ = serve_again(res, f"traced {nth} serve", cfg, eng, reqs)
        check(all(np.array_equal(a, b) for a, b in zip(toks, paged_toks)),
              f"traced {nth} serve: tokens differ from phase 5's")
        traced = tuning.profile_engine(eng, desc.prompt_len_mean)
        from_trace = stage_times_from_trace(tracer.spans())
        check(from_trace is not None and (traced.chunk_s, traced.decode_s)
              == (from_trace.h2d, from_trace.kex),
              "the traced calibration did not read the trace's stage times")
        check(eng.kv.pages_in_use == 0, "the profile left pages in use")
        out[f"trace, {nth} serve"] = calibration(
            f"trace calibration (the trace of the engine's {nth} serve)", traced,
            desc.prompt_len_mean, max_seq)
    del eng

    # (b) the search, every trial's engine dropped before the next.
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    plan = tuning.search_tuned_plan(cfg, params, scfg, desc, device="cuda",
                                    budget=tuning.SearchBudget(**TUNE_BUDGET), log=print)
    wall = time.perf_counter() - t0
    gc.collect()
    torch.cuda.synchronize()
    mem1 = torch.cuda.memory_allocated()
    print(f"[tune] search ({TUNE_BUDGET}): {plan.trials} trials in {wall:.1f} s; "
          f"memory_allocated {mem0} B before, {mem1} B after ({(mem1 - mem0) / 2**20:+.3f} MiB)")
    check(1 <= plan.trials <= TUNE_BUDGET["max_trials"], f"{plan.trials} trials")
    check(mem1 <= mem0 + RESERVED_SLACK_GIB * 2**30,
          f"memory_allocated grew from {mem0} to {mem1} B over the search")
    check(plan.tokens_per_s >= plan.baseline_tokens_per_s,
          f"tuned {plan.tokens_per_s} tok/s < baseline {plan.baseline_tokens_per_s}")
    st = plan.measured_stage_times
    out["search"] = {"trials": plan.trials, "wall_s": wall, "memory_allocated": [mem0, mem1],
                     "plan": {k: v for k, v in plan.to_json().items()
                              if k not in ("fingerprint", "schema")}}
    print(f"[tune] plan ({plan.decision}/{plan.category}): chunk {plan.prefill_chunk}, "
          f"interleave {plan.decode_interleave}, block {plan.block_size}, num_blocks "
          f"{plan.num_blocks}, slots {plan.max_batch}, kv_dtype {plan.kv_dtype}; calibrated "
          f"chunk {st.h2d * 1e3:.3f} ms, tick {st.kex * 1e3:.3f} ms; {plan.tokens_per_s:.1f} "
          f"tok/s measured against {plan.baseline_tokens_per_s:.1f} for the analytic "
          f"baseline (admission {plan.admit_ms:.2f} / {plan.baseline_admit_ms:.2f} ms)")

    # (c) the tuned serve, warm, beside a warm untuned one.
    n_tok = len(reqs) * NEW_TOKENS
    served = {}
    for label, kw in (("untuned", {}), ("tuned", dict(plan=plan))):
        eng = serve(cfg, params, "cuda", reqs, **kw)[0]
        observe_anew(eng)
        serve_again(res, f"{label} warm-up serve", cfg, eng, reqs)
        observe_anew(eng)
        toks, w, launches = serve_again(res, f"{label} serve (warm)", cfg, eng, reqs)
        served[label] = {"tokens_per_s": n_tok / w, "decode_tick_ms_p50":
                         float(np.median(eng.ticks) * 1e3), "prefill_chunks":
                         eng.prefill_chunks, "launches": launches,
                         "agreement_with_phase5": agreement(toks, paged_toks)}
        del eng
    for name in ("paged_attention", "flash_attention"):
        key = f"{name}_quant" if name == "paged_attention" and plan.kv_dtype != "fp32" else name
        check(served["tuned"]["launches"][key] > 0, f"tuned serve: no {key} launch")
    a = served["tuned"]["agreement_with_phase5"]
    if plan.kv_dtype == scfg.kv_dtype:
        check(a == 1.0, f"tuned serve: agreement {a} with phase 5's tokens (bit-equal wanted)")
    else:
        check(a >= QUANT_FLOOR, f"tuned {plan.kv_dtype} serve: agreement {a} < {QUANT_FLOOR}")
    out["serves"] = served
    print("[tune] warm serves of phase 5's requests: " + "; ".join(
        f"{k} {v['tokens_per_s']:.1f} tok/s, tick p50 {v['decode_tick_ms_p50']:.2f} ms, "
        f"{v['prefill_chunks']} chunks, agreement with phase 5 "
        f"{v['agreement_with_phase5']:.3f}" for k, v in served.items()))

    # (d) the db round trip, keyed by the card.
    kind = torch.cuda.get_device_name(0)
    fp = tuning.fingerprint(cfg, desc, scfg, backend="cuda", device_kind=kind)
    check(plan.fingerprint == fp, "the plan's fingerprint is not the card's")
    TUNE_DB.parent.mkdir(exist_ok=True)
    TUNE_DB.unlink(missing_ok=True)
    tuning.TuningDB(TUNE_DB).put(plan)
    check(tuning.TuningDB(TUNE_DB).get(fp) == plan, "the tuning db did not round-trip")
    print(f"[tune] db {TUNE_DB.relative_to(ROOT)}: fingerprint {fp} (cuda, {kind}) "
          "round-trips")

    # (e) the launcher, twice.
    path = TUNE_DB.with_name("tuning_launcher.json")
    path.unlink(missing_ok=True)
    runs = []
    for _ in range(2):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            launcher.main(["--arch", "qwen3-4b", "--paged", "--autotune", "--tune-budget",
                           str(LAUNCHER_TUNE_BUDGET), "--tuning-db", str(path)])
        lines = [ln for ln in buf.getvalue().splitlines() if "autotune (" in ln]
        runs.append((lines, time.perf_counter() - t0))
        print("\n".join(ln for ln in buf.getvalue().splitlines()
                        if ln.startswith("[serve] autotune") or ln.startswith("[serve] qwen")))
    check(len(runs[0][0]) == 1 and "autotune (searched" in runs[0][0][0],
          f"first launcher run: {runs[0][0]}")
    check(len(runs[1][0]) == 1 and "autotune (cached" in runs[1][0][0],
          f"second launcher run: {runs[1][0]}")
    check(len(tuning.TuningDB(path)) == 1, "the launcher's db holds more than one plan")
    out["launcher_s"] = [r[1] for r in runs]
    print(f"[tune] launcher --autotune (smoke qwen3-4b): searched in {runs[0][1]:.1f} s, "
          f"then cached in {runs[1][1]:.1f} s")
    print("[tune] summary " + json.dumps(out, default=str))
    return out


def phase_analysis(res: dict, main: tuple, cache: dict) -> dict:
    """Phase 12: the stream-safety analyzer (``repro_torch.analysis``) on
    the card.  (a) The CLI's whole run (``python -m repro_torch.analysis``
    on the card, in process): the static passes on the CPU (31 paths, the
    kernel lint, the pool audit), KRN003 through the quantized kernels, and
    the live sync audit of the 9 (arch, mode) smoke engines, each serving 3
    requests under ``set_sync_debug_mode("error")`` (a paged one in
    ``synccheck.LIVE_BLOCKS`` blocks, which preempts); paths audited,
    findings by rule, wall; it must be clean (the port's waiver file holds
    no waiver).  (b) Phase 5's six requests on the full 36-layer bf16
    qwen3-4b of phase 5 (``main``) in phase 5b's PRESSURE_BLOCKS-block
    pool, which preempts, with ``REPRO_SANITIZE=1`` (the invariant suite
    after every pool mutation) and the live audit on every ``@tick_path``
    method of the engine and its pool: ``sanitize_checks``, each marked
    method's calls and most fetches in a call against its
    ``allowed_fetches``, the captures it sanctioned, tok/s beside phase
    5b's serve in the same pool (``cache``), and the tokens, which must be
    bit-equal to phase 5b's.  (c) The launches of (a) and (b), each counted
    from 0 just before it, join the kernels line; (b)'s must be
    ``expected_launches``."""
    import os

    from repro_torch.analysis import RULES, WAIVERS, apply_waivers, load_waivers, synccheck
    from repro_torch.analysis import __main__ as cli
    from repro_torch.configs import qwen3_4b
    from repro_torch.runtime.serving import ServeConfig, StreamedBatchEngine

    out = {}
    counters = zero_counters()
    t0 = time.perf_counter()
    report = cli.run(device="cuda")
    wall = time.perf_counter() - t0
    launches = Launches(counters)
    unwaived, waived = apply_waivers(report["findings"], load_waivers(WAIVERS))
    check(not unwaived and not waived,
          "analysis: findings " + "; ".join(str(f) for f in unwaived + waived))
    check(report["paths_audited"] == 31 and len(report["live"]) == 9,
          f"analysis: {report['paths_audited']} paths, {len(report['live'])} live engines")
    for name in ("paged_attention", "paged_attention_multi", "paged_attention_quant",
                 "paged_attention_multi_quant", "flash_attention", "ssd"):
        check(launches[name] > 0, f"analysis (a): no {name} launch")
    fold_launches(res, launches)
    live = {r["path"]: r for r in report["live"]}
    out["cli"] = {"wall_s": wall, "static_s": report["static_s"],
                  "paths_audited": report["paths_audited"], "rules": report["rules"],
                  "live_engines": len(report["live"]), "launches": launches}
    print(f"[analysis] (a) repro_torch.analysis on the card: {report['paths_audited']} paths "
          f"audited, {len(report['live'])} engines under the live audit, findings by rule "
          f"{json.dumps(report['rules'])} ({len(RULES)} rules; no waiver); wall {wall:.2f}s "
          f"(static passes on the CPU {report['static_s']:.2f}s); launches "
          f"{json.dumps(launches)}")
    for path, r in live.items():
        print(f"[analysis]   {path}: {r['tokens']} tokens in {r['seconds']:.3f}s, "
              f"{r['preemptions']} preemptions, sanctioned {json.dumps(r['sanctioned'])}, "
              f"{len(r['calls'])} marked methods driven, fetches (most in one call, "
              f"allowed) " + json.dumps({k.split(".")[-1]: [n, r["allowed_fetches"][k]]
                                         for k, n in r["max_fetches"].items() if n}))

    # (b) the full model, sanitized and audited, in the pool that preempts.
    _, _, params = main
    cfg = qwen3_4b.CONFIG
    reqs = prompts(cfg.vocab_size)
    max_seq = -(-(max(PROMPT_LENS) + NEW_TOKENS) // BLOCK) * BLOCK
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS,
                       max_batch=SLOTS, block_size=BLOCK, paged=True,
                       num_blocks=PRESSURE_BLOCKS)

    box = {}

    def run():
        """A fresh engine's serve of ``reqs`` (as phase 5b's), sanitized
        and under the live audit; returns (tokens, seconds of ``run``)."""
        os.environ["REPRO_SANITIZE"] = "1"
        try:
            eng = StreamedBatchEngine(cfg, params, scfg, device="cuda")
        finally:
            os.environ.pop("REPRO_SANITIZE", None)
        check(getattr(eng.kv, "sanitized", False), "REPRO_SANITIZE=1 not honoured")
        audit = synccheck.LiveAudit("cuda", path="live:qwen3-4b/paged-22").watch(eng)
        audit.watch(eng.kv)
        with audit:
            uids = [eng.submit(p) for p in reqs]
            t1 = time.perf_counter()
            got = eng.run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t1
        box["eng"], box["audit"] = eng, audit
        return [got[u] for u in uids], secs

    (toks, secs), launches = count_launches("analysis (b)", run,
                                            lambda _: expected_launches(cfg, box["eng"]))
    eng, audit = box.pop("eng"), box.pop("audit")
    fold_launches(res, launches)
    check(audit.findings == [], "live audit: " + "; ".join(map(str, audit.findings)))
    pressured = cache["pressured_tokens"]
    for i, (a, b) in enumerate(zip(toks, pressured)):
        check(np.array_equal(a, b), f"sanitized request {i}: {a} != phase 5b's {b}")
    check(eng.preemptions >= 2, f"sanitized serve: {eng.preemptions} preemptions")
    check(eng.kv.pages_in_use == 0, "sanitized serve: pages left in use")
    rep = audit.report()
    for name, n in rep["max_fetches"].items():
        check(n <= rep["allowed_fetches"][name], f"{name}: {n} fetches in one call")
    n = sum(len(t) for t in toks)
    row = {"tokens_per_s": n / secs, "phase_5b_tokens_per_s": cache["pressured_tokens_per_s"],
           "sanitize_checks": eng.kv.sanitize_checks, "preemptions": eng.preemptions,
           "decode_ticks": eng.decode_steps, "fetches": rep["fetches"],
           "calls": rep["calls"], "max_fetches": rep["max_fetches"],
           "allowed_fetches": rep["allowed_fetches"], "sanctioned": rep["sanctioned"],
           "launches": launches}
    out["sanitized_serve"] = row
    print(f"[analysis] (b) qwen3-4b 36 layers bf16, {PRESSURE_BLOCKS}-block pool, "
          f"REPRO_SANITIZE=1 + live audit: {n} tokens in {secs:.3f}s = {n / secs:.1f} tok/s "
          f"(phase 5b in the same pool, unsanitized: "
          f"{cache['pressured_tokens_per_s']:.1f}); tokens bit-equal to phase 5b's for "
          f"{len(toks)} requests; {eng.preemptions} preemptions; sanitize_checks "
          f"{eng.kv.sanitize_checks}; {rep['fetches']} fetches over {eng.decode_steps} ticks "
          f"and {eng.admissions} admissions; calls {json.dumps(rep['calls'])}; most fetches "
          f"in one call {json.dumps(rep['max_fetches'])} against allowed "
          f"{json.dumps(rep['allowed_fetches'])}; sanctioned {json.dumps(rep['sanctioned'])}; "
          f"launches {json.dumps(launches)}")
    del eng
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
    serve(cfg, params, "cuda", reqs, paged=False)  # warm-up
    check_engines_freed(cfg, params, reqs, "mamba2-2.7b contiguous")
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
        if label == "contiguous":  # after phase 12's smoke mamba engines
            res["ssd"]["launches"] = res["ssd"].get("launches", 0) + launches["ssd"]
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

    # One 64-token prefill chunk at position 64 over a b=1 cache, synchronized:
    # the chunk graph over the request cache (eager at its first use,
    # captured at its second, timed from the third), and the eager prefill.
    from repro_torch.runtime.kv_cache import zero_cache
    single = ServingEngine(cfg, params, eng.scfg, device="cuda",
                           unembed=T.unembed_f32(cfg, params))
    piece = torch.from_numpy(reqs[0][None].copy()).to("cuda")
    t_chunk, t_eager = [], []
    for _ in range(7):
        graphed = single.iter_prefill_chunks(reqs[0][None],
                                             caches=zero_cache(single.request_cache()))
        for times, chunks in ((t_chunk, graphed), (t_eager, single.iter_prefill_chunks(piece))):
            next(chunks)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            next(chunks)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
    summary = {k: {f: v for f, v in r.items() if f != "toks"} for k, r in out.items()}
    summary["prefill_chunk_ms"] = float(np.median(t_chunk[2:]) * 1e3)
    summary["prefill_chunk_eager_ms"] = float(np.median(t_eager[2:]) * 1e3)
    print(f"[mamba] prefill chunk (64 tokens at position 64, b=1) "
          f"{summary['prefill_chunk_ms']:.2f} ms graphed, "
          f"{summary['prefill_chunk_eager_ms']:.2f} ms eager")
    print("[mamba] serves " + json.dumps(summary))
    return summary


# -- phase 8: the decoder-only zoo --------------------------------------------------


def zoo_config(arch: str, **over):
    """A published config of the port's registry, with ``over`` replaced."""
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), **over)


#: 2-layer f32 cases held card vs CPU: gemma2 (one local and one global
#: layer) as published and with a window that bites on 128-token prompts,
#: qwen2-moe as published and with decode ticks that drop choices.
ZOO_CPU_CASES = {"gemma2-27b": ({}, dict(sliding_window=64)),
                 "qwen2-moe-a2.7b": ({}, dict(capacity_factor=0.5))}


def phase_zoo_card_vs_cpu() -> None:
    """Phase 8a: each ZOO_CPU_CASES config at published width cut to 2
    layers, f32, serves PROMPT_LENS on the card (kernels, graphed) and on
    the CPU (plain versions), paged (fused) and contiguous: admission logits
    allclose, greedy tokens identical per request; the graphed MoE serve
    equals the eager card serve.  The CPU serve counts the choices its
    decode ticks' routings dropped for capacity (printed).  The weights
    are drawn on the card once an arch and copied to the CPU."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as T

    route = moe.route_topk_indices
    for arch, variants in ZOO_CPU_CASES.items():
        base = zoo_config(arch, n_layers=2, param_dtype=torch.float32,
                          compute_dtype=torch.float32)
        gpu_params = T.init_params(base, 0, device="cuda")  # drawn on the card (fast)
        cpu_params = to_device(gpu_params, "cpu")
        reqs = prompts(base.vocab_size)
        for over, (label, kw) in itertools.product(
                variants, (("paged", {}), ("contiguous", dict(paged=False)))):
            cfg = dataclasses.replace(base, **over)
            graphed = serve(cfg, gpu_params, "cuda", reqs, **kw)
            _, tok_g, log_g, _, wall_g = graphed
            drops = []

            def counted(logits, *, top_k, capacity):
                out = route(logits, top_k=top_k, capacity=capacity)
                if logits.shape[0] == SLOTS:  # a decode tick's rows
                    drops.append(int((out[1] >= capacity).sum()))
                return out
            moe.route_topk_indices = counted
            try:
                _, tok_c, log_c, _, wall_c = serve(cfg, cpu_params, "cpu", reqs, **kw)
            finally:
                moe.route_topk_indices = route
            name = f"{arch} {json.dumps(over)} 2-layer f32 {label}"
            for i, (a, b) in enumerate(zip(log_g, log_c)):
                check(torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
                      f"{name} request {i}: card vs CPU admission logits differ by "
                      f"{(a - b).abs().max().item():.3e}")
            for i, (a, b) in enumerate(zip(tok_g, tok_c)):
                check(np.array_equal(a, b), f"{name} request {i}: card {a} != CPU {b}")
            worst = max((a - b).abs().max().item() for a, b in zip(log_g, log_c))
            print(f"[zoo] {name}: admission logits max abs diff {worst:.3e} (atol "
                  f"{LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens identical card vs CPU for "
                  f"{len(reqs)} requests x {NEW_TOKENS}"
                  + (f"; decode-tick routings (one a layer a tick, CPU) that dropped "
                     f"choices {sum(d > 0 for d in drops)} of {len(drops)}, {sum(drops)} "
                     "choices dropped" if cfg.n_experts else "")
                  + f"; card {wall_g:.2f}s, cpu {wall_c:.2f}s")
            if cfg.n_experts and label == "paged":
                graph_vs_eager(name, graphed,
                               serve(cfg, gpu_params, "cuda", reqs, eager=True, **kw))
        del gpu_params, cpu_params, graphed
        print(f"[zoo] memory_reserved after {arch}: {reserved_gib():.3f} GiB")


def phase_zoo_full(res: dict, arch: str, cfg, runs, *, note: str = "",
                   profile: bool = False, floor_bytes=None, encs=None) -> dict:
    """Phase 8b-d: ``cfg`` (published widths, bf16, random weights from
    seed 0; ``full_model``) serves each of ``runs`` ((label, prompts,
    ServeConfig options), the first the plain fused paged serve) once to
    warm it and once counted (``counted_run``: each tick of its kind and
    each chunk launches its kernel once a layer); tokens/s, tick p50, the
    graphed chunk, acceptance, page bytes, agreement with the plain serve
    (int8 pages: >= the reference's floor).  ``profile`` adds a
    torch.profiler serve of the first run's options.  ``floor_bytes`` as
    ``load_full``'s; ``encs``: the requests' encoder inputs (whisper),
    whose encode times are printed."""
    def measure(params, out):
        plain = None
        for label, rq, kw in runs:
            t1 = time.perf_counter()
            serve(cfg, params, "cuda", rq, encs=encs, **kw)  # warm-up
            reserved0 = reserved_gib()
            (eng, toks, logits, ticks, wall), launches, peak = counted_run(
                res, f"{arch} {label}", lambda: serve(cfg, params, "cuda", rq, encs=encs, **kw),
                lambda o: expected_launches(cfg, o[0]))
            check_graphed(eng, f"{arch} {label}")
            if cfg.n_encoder_layers:  # each encode (Sq = Sk 1500) on the wgmma body
                check(launches.by_body["wg"] >= cfg.n_encoder_layers * eng.admissions,
                      f"{arch} {label}: prefill launches by body {launches.by_body}, "
                      f"{eng.admissions} encodes of {cfg.n_encoder_layers} layers")
            for i, (t, lg) in enumerate(zip(toks, logits)):
                check(len(t) == NEW_TOKENS and bool(((t >= 0) & (t < cfg.padded_vocab)).all()),
                      f"{arch} {label} request {i}: {t}")
                check(bool(torch.isfinite(lg).all()), f"{arch} {label} request {i}: non-finite")
            n = sum(len(t) for t in toks)
            rate = eng.spec_accepted / eng.spec_proposed if eng.spec_proposed else None
            row = {"tokens_per_s": n / wall, "decode_tick_ms_p50": float(np.median(ticks) * 1e3),
                   "decode_ticks": eng.decode_steps, "verify_ticks": eng.spec_ticks,
                   "prefill_chunks": eng.prefill_chunks, "acceptance": rate,
                   "page_bytes": eng.kv.page_bytes if eng.paged else None,
                   "launches": launches, "peak_mem_gb": peak,
                   "memory_reserved_gib": [reserved0, reserved_gib()]}
            if eng.encode_s:
                row["encode_ms"] = [x * 1e3 for x in eng.encode_s]
            if plain is None:
                plain = toks
                row["prefill_chunk_ms"], row["prefill_chunk_eager_ms"] = time_chunk(eng, rq)
            elif rq is runs[0][1]:
                row["agreement_with_plain"] = agreement(toks, plain)
                if kw.get("kv_dtype") in ("int8", "fp8"):
                    check(row["agreement_with_plain"] >= QUANT_FLOOR,
                          f"{arch} {label}: agreement with the plain serve "
                          f"{row['agreement_with_plain']:.3f} < {QUANT_FLOOR}")
            del eng
            out[label] = row
            if profile and plain is toks:
                phase_profile(cfg, params, rq, f"{arch} {label}", **kw)
            print(f"[zoo] {arch} {label}: {n} tokens in {wall:.3f}s = {n / wall:.1f} tok/s; "
                  f"tick p50 {row['decode_tick_ms_p50']:.2f} ms over {row['decode_ticks']} "
                  f"ticks ({row['verify_ticks']} verify, acceptance "
                  f"{'-' if rate is None else f'{rate:.3f}'}); {row['prefill_chunks']} chunks"
                  + (f", a graphed 64-token chunk {row['prefill_chunk_ms']:.2f} ms (eager "
                     f"{row['prefill_chunk_eager_ms']:.2f} ms)" if "prefill_chunk_ms" in row
                     else "")
                  + f"; page_bytes {row['page_bytes']}"
                  + (f"; agreement with the plain serve {row['agreement_with_plain']:.3f}"
                     if "agreement_with_plain" in row else "")
                  + (f"; encode per admission (ms) {[round(x, 2) for x in row['encode_ms']]}"
                     if "encode_ms" in row else "")
                  + f"; launches {launches}; peak {row['peak_mem_gb']:.2f} GB; memory_reserved "
                  f"{row['memory_reserved_gib'][0]:.3f} -> {row['memory_reserved_gib'][1]:.3f} "
                  f"GiB; {time.perf_counter() - t1:.1f}s")
    return full_model(arch, cfg, measure, note=note, floor_bytes=floor_bytes)


def full_model(arch: str, cfg, measure, *, note: str = "", floor_bytes=None) -> dict:
    """``cfg``'s weights loaded (``load_full``), ``measure(params, out)`` run
    to fill the model's result dict, then the model dropped with every
    engine ``measure`` made, and memory_reserved read after (``dropped``)."""
    params, out = load_full(arch, cfg, note=note, floor_bytes=floor_bytes)
    measure(params, out)
    del params
    return dropped(arch, out)


def load_full(arch: str, cfg, *, note: str = "", floor_bytes=None) -> tuple[dict, dict]:
    """``cfg``'s weights (bf16, random from seed 0) drawn on the card, after
    checking that no earlier model is resident (under 2 GiB allocated);
    prints its size and a tick's weight-read floor: every weight and the f32
    table at 3.35 TB/s, or ``floor_bytes(params)``.  Returns the params and
    the model's result dict (weights_gb, floor_ms)."""
    from repro_torch.models import transformer as T

    alloc = torch.cuda.memory_allocated() / 2**30
    check(alloc < 2.0, f"{arch}: {alloc:.2f} GiB allocated before loading (an earlier model "
          "or engine is alive)")
    t0 = time.perf_counter()
    params = T.init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    wb = sum(t.numel() * t.element_size() for t in _leaves(params))
    table = cfg.padded_vocab * cfg.d_model * 4  # unembed_f32's copy, read every tick
    tick_bytes = wb + table if floor_bytes is None else floor_bytes(params)
    floor_ms = tick_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[zoo] {arch}: {cfg.n_layers} layers{note}, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab_size}, bf16, "
          f"{sum(t.numel() for t in _leaves(params)) / 1e9:.3f}B params = {wb / 1e9:.2f} GB "
          f"(+ {table / 1e9:.2f} GB f32 table); a tick's weight-read floor {floor_ms:.2f} ms "
          f"({tick_bytes / 1e9:.2f} GB) at 3.35 TB/s; init {time.perf_counter() - t0:.1f}s")
    return params, {"weights_gb": wb / 1e9, "floor_ms": floor_ms}


def dropped(arch: str, out: dict) -> dict:
    """``out`` with memory_reserved read after the caller dropped the model
    and its engines."""
    out["memory_reserved_gib_after"] = reserved_gib()
    print(f"[zoo] {arch} dropped: memory_reserved {out['memory_reserved_gib_after']:.3f} GiB")
    return out


#: mixtral-8x7b's full 32 layers (46.7B parameters, 93 GB in bf16) do not
#: fit in the card's 80 GB: its serve keeps the published widths at 16 layers.
MIXTRAL_LAYERS = 16


def phase_zoo(res: dict, *, profile: bool = False) -> dict:
    """Phase 8: the decoder-only zoo.  (a) card vs CPU at 2 layers
    (``phase_zoo_card_vs_cpu``); (b) gemma2-27b at full width and depth:
    fused paged bf16 pages, int8 pages, the contiguous cache and n-gram
    spec on tiled prompts; (c) qwen2-moe-a2.7b at full width and depth,
    fused paged plain and with n-gram spec; (d) one fused paged serve each
    of internlm2-20b and phi4-mini-3.8b (full) and mixtral-8x7b at published
    width cut to MIXTRAL_LAYERS layers.  Each phase's wall is printed."""
    out = {}
    t0 = time.perf_counter()
    phase_zoo_card_vs_cpu()
    print(f"[zoo] (a) card vs CPU {time.perf_counter() - t0:.1f}s")
    spec = dict(spec_decode=True, spec_k=SPEC_K)
    for arch, cut, extra in (
            ("gemma2-27b", None, [("int8 pages", dict(kv_dtype="int8")),
                                  ("contiguous", dict(paged=False)),
                                  ("spec, n-gram drafts (tiled prompts)", spec)]),
            ("qwen2-moe-a2.7b", None, [("spec, n-gram drafts (tiled prompts)", spec)]),
            ("internlm2-20b", None, []), ("phi4-mini-3.8b", None, []),
            ("mixtral-8x7b", MIXTRAL_LAYERS, [])):
        t0 = time.perf_counter()
        cfg = zoo_config(arch) if cut is None else zoo_config(arch, n_layers=cut)
        reqs, tiled = prompts(cfg.vocab_size), tiled_prompts(cfg.vocab_size)
        runs = [("fused paged", reqs, {})] + [
            (label, tiled if kw.get("spec_decode") else reqs, kw) for label, kw in extra]
        note = (f" (published {zoo_config(arch).n_layers}, cut to {cut}: the full bf16 "
                "weights do not fit in 80 GB)" if cut else "")
        out[arch] = phase_zoo_full(res, arch, cfg, runs, note=note, profile=profile)
        print(f"[zoo] {arch} {time.perf_counter() - t0:.1f}s")
    print("[zoo] serves " + json.dumps(out))
    return out


# -- phase 9: the rest of the zoo (jamba, whisper, paligemma) ------------------------

#: jamba-1.5-large's unit positions held card vs CPU at 2 layers (mamba +
#: dense FFN, attention + MoE), with its experts cut to JAMBA_CPU_EXPERTS.
JAMBA_CPU_UNIT, JAMBA_CPU_EXPERTS = (0, 3), 4
#: The full-width bf16 jamba serve keeps the unit's first JAMBA_LAYERS layers
#: (mamba + dense, mamba + MoE, mamba + dense, attention + MoE: 21.9B
#: parameters); one whole 8-layer unit is ~86 GB in bf16, past the card's 80.
JAMBA_LAYERS = 4
PALI_ROWS, PALI_TOKENS = 4, 64  # generate: 4 rows of 256 image rows + 64 tokens


def jamba_config(positions, **over):
    """jamba-1.5-large at published widths with the unit cut to its layers
    at ``positions`` (one repeat)."""
    full = zoo_config("jamba-1.5-large-398b")
    unit = tuple(full.layer_unit[i] for i in positions)
    return dataclasses.replace(full, layer_unit=unit, n_layers=len(unit), **over)


def enc_inputs(cfg, n: int, seed: int = 2) -> list[np.ndarray]:
    """``n`` requests' encoder frames (encoder_seq, d_model): 0.1 x a normal
    draw from ``seed``, as the launcher's."""
    rng = np.random.default_rng(seed)
    return [(0.1 * rng.standard_normal((cfg.encoder_seq, cfg.d_model))).astype(np.float32)
            for _ in range(n)]


def pali_inputs(cfg, seed: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """PALI_ROWS rows of PALI_TOKENS tokens and their (prefix_len, d_model)
    image embeddings (0.1 x a normal draw), from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (PALI_ROWS, PALI_TOKENS), dtype=np.int32)
    pre = (0.1 * rng.standard_normal((PALI_ROWS, cfg.prefix_len, cfg.d_model))
           ).astype(np.float32)
    return toks, pre


def hold_card_cpu(name, card, cpu) -> float:
    """Card vs CPU serves of the same requests: admission logits allclose,
    greedy tokens identical per request; returns the worst logit gap."""
    (_, tok_g, log_g, _, _), (_, tok_c, log_c, _, _) = card, cpu
    for i, (a, b) in enumerate(zip(log_g, log_c)):
        check(torch.allclose(a, b, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
              f"{name} request {i}: card vs CPU admission logits differ by "
              f"{(a - b).abs().max().item():.3e}")
    for i, (a, b) in enumerate(zip(tok_g, tok_c)):
        check(np.array_equal(a, b), f"{name} request {i}: card {a} != CPU {b}")
    return max((a - b).abs().max().item() for a, b in zip(log_g, log_c))


def pali_engine(cfg, params, device):
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import ServeConfig, ServingEngine

    max_seq = -(-(cfg.prefix_len + PALI_TOKENS + NEW_TOKENS) // BLOCK) * BLOCK
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS)
    return ServingEngine(cfg, params, scfg, device=device, unembed=T.unembed_f32(cfg, params))


def pali_generate(single, toks, pre):
    """The first chunk's last logits (4, V) on the host and ``generate``'s
    tokens (4, NEW_TOKENS) as numpy."""
    t = torch.from_numpy(toks).to(single.device)
    first = next(single.iter_prefill_chunks(t, prefix_embeds=pre))[0][:, -1].float().cpu()
    return first, single.generate(toks, prefix_embeds=pre).cpu().numpy()


def phase_rest_card_vs_cpu() -> None:
    """Phase 9a, f32 at published widths, cut in depth, weights drawn on the
    card from seed 0 and copied to the CPU: jamba (unit positions 0 and 3,
    JAMBA_CPU_EXPERTS experts top-2) and whisper-medium (2 decoder and 2
    encoder layers, 1500 frames, one evict / readmit mid decode) serve
    PROMPT_LENS paged and contiguous on the card (graphed) and on the CPU:
    admission logits allclose, greedy tokens identical, and the graphed
    card serve equal to the eager one; paligemma-3b (2 layers) generates
    for 4 rows of 256 image rows + 64 tokens on both: first-chunk logits
    allclose, tokens identical."""
    from repro_torch.models import transformer as T

    f32 = dict(param_dtype=torch.float32, compute_dtype=torch.float32)
    cases = [("jamba 2-layer f32", jamba_config(JAMBA_CPU_UNIT, n_experts=JAMBA_CPU_EXPERTS,
                                                 **f32), {}),
             ("whisper-medium 2+2-layer f32",
              zoo_config("whisper-medium", n_layers=2, n_encoder_layers=2, **f32),
              dict(mid=evict_readmit_oldest))]
    for base, cfg, extra in cases:
        t0 = time.perf_counter()
        gpu_params = T.init_params(cfg, 0, device="cuda")
        cpu_params = to_device(gpu_params, "cpu")
        reqs = prompts(cfg.vocab_size)
        if cfg.is_encoder_decoder:
            extra = dict(extra, encs=enc_inputs(cfg, len(reqs)))
        for label, kw in (("paged", {}), ("contiguous", dict(paged=False))):
            name = f"{base} {label}"
            graphed = serve(cfg, gpu_params, "cuda", reqs, **extra, **kw)
            cpu = serve(cfg, cpu_params, "cpu", reqs, **extra, **kw)
            worst = hold_card_cpu(name, graphed, cpu)
            graph_vs_eager(name, graphed,
                           serve(cfg, gpu_params, "cuda", reqs, eager=True, **extra, **kw))
            eng = graphed[0]
            print(f"[rest] {name}: admission logits max abs diff {worst:.3e} (atol "
                  f"{LOGIT_ATOL}, rtol {LOGIT_RTOL}); greedy tokens identical card vs CPU for "
                  f"{len(reqs)} requests x {NEW_TOKENS}; {eng.decode_steps} ticks, "
                  f"{eng.prefill_chunks} chunks; card {graphed[4]:.2f}s, cpu {cpu[4]:.2f}s")
        del gpu_params, cpu_params, graphed, cpu, eng
        print(f"[rest] {base}: {time.perf_counter() - t0:.1f}s; memory_reserved after "
              f"{reserved_gib():.3f} GiB")
    cfg = zoo_config("paligemma-3b", n_layers=2, **f32)
    gpu_params = T.init_params(cfg, 0, device="cuda")
    cpu_params = to_device(gpu_params, "cpu")
    toks, pre = pali_inputs(cfg)
    lg_g, tok_g = pali_generate(pali_engine(cfg, gpu_params, "cuda"), toks, pre)
    lg_c, tok_c = pali_generate(pali_engine(cfg, cpu_params, "cpu"), toks, pre)
    worst = (lg_g - lg_c).abs().max().item()
    check(torch.allclose(lg_g, lg_c, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
          f"paligemma 2-layer f32: card vs CPU first-chunk logits differ by {worst:.3e}")
    check(np.array_equal(tok_g, tok_c), f"paligemma 2-layer f32: card {tok_g} != CPU {tok_c}")
    print(f"[rest] paligemma-3b 2-layer f32 generate ({PALI_ROWS} rows x {cfg.prefix_len} "
          f"image rows + {PALI_TOKENS} tokens): first-chunk logits max abs diff {worst:.3e}; "
          f"greedy tokens identical card vs CPU ({NEW_TOKENS} a row)")
    del gpu_params, cpu_params


def block_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(params["blocks"]))


def phase_pali_full(res: dict) -> dict:
    """Phase 9b, paligemma-3b at full width and depth (18 layers, bf16,
    random weights from seed 0; ``full_model``): ``generate`` over 4 rows of
    256 image rows + 64 tokens, warm, then counted (``counted_run``: the
    prefill kernel once a layer a chunk, nothing else: decode is torch ops
    over the contiguous cache); tokens/s, the first chunk (320 rows) timed
    alone, the decode step (mean over the wall after the first chunk), a
    tick's weight-read floor (blocks + the f32 table)."""
    cfg = zoo_config("paligemma-3b")

    def measure(params, row):
        single = pali_engine(cfg, params, "cuda")
        toks, pre = pali_inputs(cfg)
        t = torch.from_numpy(toks).to("cuda")
        pre_d = torch.from_numpy(pre).to("cuda")
        single.generate(toks, prefix_embeds=pre_d)  # warm-up
        first = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            next(single.iter_prefill_chunks(t, prefix_embeds=pre_d))
            torch.cuda.synchronize()
            first.append(time.perf_counter() - t0)

        def run():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = single.generate(toks, prefix_embeds=pre_d).cpu().numpy()
            return out, time.perf_counter() - t0
        # one chunk (64 tokens) a layer
        want = dict({name: 0 for name in KERNELS}, flash_attention=cfg.n_layers)
        (out, wall), launches, peak = counted_run(res, "paligemma generate", run,
                                                  lambda _: want)
        check(out.shape == (PALI_ROWS, NEW_TOKENS)
              and bool(((out >= 0) & (out < cfg.padded_vocab)).all()), f"paligemma: {out}")
        chunk_ms = float(np.median(first[1:]) * 1e3)
        step_ms = (wall * 1e3 - chunk_ms) / (NEW_TOKENS - 1)
        row.update({"tokens_per_s": out.size / wall, "first_chunk_ms": chunk_ms,
                    "decode_step_ms_mean": step_ms, "launches": launches, "peak_mem_gb": peak})
        print(f"[rest] paligemma-3b generate {PALI_ROWS} rows x ({cfg.prefix_len} image rows "
              f"+ {PALI_TOKENS} tokens) -> {NEW_TOKENS}: {out.size} tokens in {wall:.3f}s = "
              f"{row['tokens_per_s']:.1f} tok/s; first chunk (320 rows) {chunk_ms:.2f} ms; "
              f"decode step {step_ms:.2f} ms (mean, eager); launches {launches}; peak "
              f"{row['peak_mem_gb']:.2f} GB")
    return full_model("paligemma-3b", cfg, measure, floor_bytes=lambda p: (
        block_bytes(p) + cfg.padded_vocab * cfg.d_model * 4))


def phase_rest(res: dict, *, profile: bool = False) -> dict:
    """Phase 9: (a) card vs CPU (``phase_rest_card_vs_cpu``); (b)
    jamba-1.5-large at full width cut to its unit's first JAMBA_LAYERS
    layers, paged and contiguous; whisper-medium, 24 + 24 layers, each
    request with 1500 frames from the seed, paged and contiguous; paligemma
    through ``generate`` (``phase_pali_full``).  Each model is dropped
    before the next."""
    out = {}
    t0 = time.perf_counter()
    phase_rest_card_vs_cpu()
    print(f"[rest] (a) card vs CPU {time.perf_counter() - t0:.1f}s")
    runs = [("paged", {}), ("contiguous", dict(paged=False))]
    t0 = time.perf_counter()
    cfg = jamba_config(range(JAMBA_LAYERS))
    reqs = prompts(cfg.vocab_size)
    out["jamba-1.5-large-398b"] = phase_zoo_full(
        res, "jamba-1.5-large-398b", cfg, [(lb, reqs, kw) for lb, kw in runs],
        note=f" (published 72, cut to the unit's first {JAMBA_LAYERS}: one 8-layer unit "
             "does not fit in 80 GB)", profile=profile,
        floor_bytes=lambda p: block_bytes(p) + cfg.padded_vocab * cfg.d_model * 4)
    print(f"[rest] jamba {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    wcfg = zoo_config("whisper-medium")
    reqs = prompts(wcfg.vocab_size)
    cross = (SLOTS * wcfg.n_layers * 2 * wcfg.encoder_seq * wcfg.n_kv_heads * wcfg.head_dim
             * 2)  # bf16 cross K/V of the 4 slots, read every tick
    out["whisper-medium"] = phase_zoo_full(
        res, "whisper-medium", wcfg, [(lb, reqs, kw) for lb, kw in runs],
        note=f" + {wcfg.n_encoder_layers} encoder layers", profile=profile,
        floor_bytes=lambda p: block_bytes(p) + wcfg.padded_vocab * wcfg.d_model * 4 + cross,
        encs=enc_inputs(wcfg, len(reqs)))
    print(f"[rest] whisper {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    out["paligemma-3b"] = phase_pali_full(res)
    print(f"[rest] paligemma {time.perf_counter() - t0:.1f}s")
    print("[rest] serves " + json.dumps(out))
    return out


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

    counters = zero_counters()
    results = S.run(device="cuda", n_tasks=8, streams=4)
    launches = Launches(counters)
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


# -- phase 13: training -------------------------------------------------------------

#: The Functions on the card against autograd through their plain versions,
#: relative to the plain tensor's largest magnitude.
TRAIN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: Card vs CPU grads of one 2-layer f32 train step, relative to each leaf's
#: largest CPU magnitude (f32 sums in another order through two layers, the
#: 152k-row vocabulary product and the attention kernel's exp).
STEP_TOL = 1e-3
TRAIN_ATTN_CASES = [  # (label, shape and mask); attn_chunk 512 (paligemma 256)
    ("qwen3-4b", dict(b=4, sq=512, h=32, hkv=8, hd=128, chunk=512)),
    ("gemma2-27b local (window 256 bites at 512, softcap 50, scale 144^-0.5)",
     dict(b=2, sq=512, h=32, hkv=16, hd=128, chunk=512, window=256, softcap=50.0,
          scale=144 ** -0.5)),
    ("whisper-medium encoder (non-causal 1500)",
     dict(b=1, sq=1500, h=16, hkv=16, hd=64, chunk=512, causal=False)),
    ("paligemma-3b prefix 256 + 64", dict(b=1, sq=320, h=8, hkv=1, hd=256, chunk=256,
                                          prefix_len=256)),
]
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 4, 512  # phase 13c: the launcher's settings
MAMBA_TRAIN_STEPS = 3


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max() /
            want.float().abs().max().clamp_min(1e-30)).item()


def train_attn_case(label: str, dtype, c: dict, res13: dict) -> None:
    """FlashAttention (kernel forward with lse, torch-ops backward) against
    autograd through the plain version at one training shape: out, lse, dq,
    dk, dv.  bf16 qwen3: the forward with lse timed beside SDPA and the
    bound (row 4d), the backward beside SDPA's."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref
    from repro_torch.models import attention as A

    c = dict(c)
    b, sq, h, hkv, hd, chunk = (c.pop(k) for k in ("b", "sq", "h", "hkv", "hd", "chunk"))
    kw = dict(causal=True, window=0, softcap=0.0, scale=1.0 / math.sqrt(hd),
              prefix_len=0) | c
    g = torch.Generator(device="cuda").manual_seed(13)
    q = torch.randn((b, sq, h, hd), generator=g, device="cuda").to(dtype)
    k = torch.randn((b, sq, hkv, hd), generator=g, device="cuda").to(dtype)
    v = torch.randn((b, sq, hkv, hd), generator=g, device="cuda").to(dtype)
    dout = torch.randn((b, sq, h, hd), generator=g, device="cuda").to(dtype)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = FA.KERNEL.launches
    out, lse = A.FlashAttention.apply(*ins, chunk, kw["causal"], kw["window"], kw["softcap"],
                                      kw["scale"], 0, kw["prefix_len"])
    grads = torch.autograd.grad(out, ins, dout)
    check(FA.KERNEL.launches == n0 + 1, f"train attention {label}: the kernel did not launch")
    pins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want, want_lse = ref.flash_attention_lse_ref(*pins, q_offset=0, **kw)
    want_grads = torch.autograd.grad(want, pins, dout)
    errs = {"out": rel_err(out, want), "lse": rel_err(lse, want_lse)}
    errs |= {n: rel_err(a, w) for n, a, w in zip(("dq", "dk", "dv"), grads, want_grads)}
    tol = TRAIN_TOL[dtype]
    check(max(errs.values()) <= tol, f"train attention {label} {dtype}: {errs} > {tol}")
    line = (f"[train] (a) attention {label}, {str(dtype).removeprefix('torch.')}: "
            + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()) + f" (tol {tol} x max)")
    if dtype == torch.bfloat16 and label == "qwen3-4b":
        held_prefill(f"train attention {label}", out.detach(), want.detach(), q, k, v, **kw)
        fwd = functools.partial(FA.flash_attention_lse, q, k, v, causal=True,
                                scale=kw["scale"])
        ms = device_ms(fwd, iters=QUEUED)
        nbytes, flops = flash_bytes_flops(q, k, 0, 0, lse=True)
        b_ms, b_by = bound(nbytes, flops, dtype)
        lib_ms, lib_name = yardstick({
            "sdpa, boolean mask": sdpa_prefill(q, k, v, 0, kw["scale"]),
            "sdpa, is_causal": sdpa_masked(q, k, v, kw["scale"], is_causal=True)})
        other, other_ms = other_body_ms(q, k, v, scale=kw["scale"])
        bwd = functools.partial(A.flash_backward, q, k, v, out.detach(), lse, dout,
                                q_offset=0, chunk=chunk, **kw)
        plain_ms = time_ms(functools.partial(ref.flash_attention_lse_ref, q, k, v, q_offset=0,
                                             **kw), iters=10, warmup=2)
        bwd_ms = time_ms(bwd, iters=10, warmup=2)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True) for x in (q, k, v))
        mask = torch.ones((sq, sq), dtype=torch.bool, device="cuda").tril()
        so = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, scale=kw["scale"],
                                            enable_gqa=True)
        dot = dout.transpose(1, 2).contiguous()
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(so, (qt, kt, vt), dot,
                                                          retain_graph=True), iters=10, warmup=2)
        res13["row_4d"] = {"ms": ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                           "library": lib_name, f"{other}_body_ms": other_ms,
                           "plan": flash_plan(q, k), "plain_ms": plain_ms,
                           "bwd_torch_ops_ms": bwd_ms, "sdpa_bwd_ms": sdpa_bwd_ms}
        line += (f"; row 4d: forward with lse {ms:.4f} ms, {lib_name} {lib_ms:.4f} ms "
                 f"({ms / lib_ms:.2f}x), the {other} body {other_ms:.4f} ms, plain "
                 f"{plain_ms:.4f} ms, bound {b_ms:.6f} ms ({b_by}), {flash_plan(q, k)}; "
                 f"backward (torch ops, no kernel) {bwd_ms:.3f} ms, SDPA's backward "
                 f"{sdpa_bwd_ms:.3f} ms")
    print(line)


def train_ssd_case(dtype) -> None:
    """SSDChunked (kernel forward, plain-recompute backward) against autograd
    through the plain version at mamba2-2.7b's shapes (H 80, P 64, N 128,
    chunk 256), from a random state: y, the final state and the six
    grads."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_chunk as SSD
    from repro_torch.models import mamba as M

    b, s, h, p, n, chunk = 2, 512, 80, 64, 128, 256
    g = torch.Generator(device="cuda").manual_seed(14)
    x = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dt = torch.nn.functional.softplus(torch.randn((b, s, h), generator=g, device="cuda") - 2)
    a = -torch.exp(torch.randn((h,), generator=g, device="cuda"))
    bm = torch.randn((b, s, n), generator=g, device="cuda").to(dtype)
    cm = torch.randn((b, s, n), generator=g, device="cuda").to(dtype)
    st = torch.randn((b, h, p, n), generator=g, device="cuda")
    dy = torch.randn((b, s, h, p), generator=g, device="cuda").to(dtype)
    dst = torch.randn((b, h, p, n), generator=g, device="cuda")
    ins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, st)]
    n0 = SSD.KERNEL.launches
    y, final = M.SSDChunked.apply(*ins, chunk)
    grads = torch.autograd.grad((y, final), ins, (dy, dst))
    check(SSD.KERNEL.launches == n0 + 1, "train SSD: the kernel did not launch")
    pins = [t.clone().requires_grad_(True) for t in (x, dt, a, bm, cm, st)]
    wy, wf = ref.ssd_chunked_ref(*pins[:5], chunk=chunk, init_state=pins[5])
    wgrads = torch.autograd.grad((wy, wf), pins, (dy, dst))
    errs = {"y": rel_err(y, wy), "state": rel_err(final, wf)}
    errs |= {f"d{n_}": rel_err(a_, w_) for n_, a_, w_ in
             zip(("x", "dt", "a", "b", "c", "state0"), grads, wgrads)}
    tol = max(TRAIN_TOL[dtype], SSD_RTOL[dtype])
    check(max(errs.values()) <= tol, f"train SSD {dtype}: {errs} > {tol}")
    print(f"[train] (a) SSD mamba2-2.7b shapes (B {b}, S {s}, H {h}, P {p}, N {n}, chunk "
          f"{chunk}), {str(dtype).removeprefix('torch.')}: "
          + ", ".join(f"{k_} {e:.2e}" for k_, e in errs.items()) + f" (tol {tol} x max)")


def two_layer(arch: str):
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), n_layers=2, param_dtype=torch.float32,
                               compute_dtype=torch.float32)


def train_step_card_vs_cpu(arch: str, accum: int) -> None:
    """One make_train_step step of 2-layer full-width ``arch`` in f32 on the
    card and on the CPU from the same params and batch: loss, grad norm
    and every leaf's grad held together; a leaf with a CPU grad must have
    a card grad (a kernel output without a grad_fn would leave the
    projections before it without one)."""
    from repro_torch.core.tree import tree_paths
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    cfg = two_layer(arch)
    ocfg = adamw.AdamWConfig(lr=1e-3)
    # drawn on the card and copied: the CPU takes ~25 s to draw the 0.6B
    params = to_device(T.init_params(cfg, 0, device="cuda"), "cpu")
    batch = SyntheticLM(cfg.vocab_size, global_batch=2, seq_len=64, seed=1).batch_at(0)
    out = {}
    for dev in ("cuda", "cpu"):
        p = _clone_tree(to_device(params, dev))
        opt = adamw.init_state(p)
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.perf_counter()
        _, _, m = steps.make_train_step(cfg, ocfg, accum=accum, keep_grads=True)(p, opt, b)
        float(m["loss"])
        out[dev] = (m, time.perf_counter() - t0)
    (mc, tc), (mp, tp) = out["cuda"], out["cpu"]
    loss_err = abs(float(mc["loss"]) - float(mp["loss"])) / abs(float(mp["loss"]))
    norm_err = abs(float(mc["grad_norm"]) - float(mp["grad_norm"])) / float(mp["grad_norm"])
    cpu_g, card_g = dict(tree_paths(mp["grads"])), dict(tree_paths(mc["grads"]))
    worst, where, missing = 0.0, ("-",), []
    for path, want in cpu_g.items():
        got = card_g[path].cpu()
        if want.abs().max() > 0 and got.abs().max() == 0:
            missing.append(path)
        e = rel_err(got, want)
        if e > worst:
            worst, where = e, path
    check(not missing, f"{arch} accum {accum}: no card grad for {missing}")
    check(loss_err <= 1e-4 and norm_err <= 1e-4 and worst <= STEP_TOL,
          f"{arch} accum {accum}: loss {loss_err:.2e}, grad norm {norm_err:.2e}, "
          f"worst grad {worst:.2e} at {where}")
    print(f"[train] (b) {arch} 2 layers full width f32, accum {accum}: card vs CPU loss "
          f"{float(mc['loss']):.6f} / {float(mp['loss']):.6f} (rel {loss_err:.2e}), grad norm "
          f"rel {norm_err:.2e}, {len(cpu_g)} leaves, worst grad {worst:.2e} x max at "
          f"{'/'.join(where)} (tol {STEP_TOL}); card {tc:.2f}s, cpu {tp:.2f}s")


def _clone_tree(tree):
    return {k: _clone_tree(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def train_full(res: dict, res13: dict, smi: str) -> None:
    """(c) The launcher at its settings on full qwen3-4b (36 layers, bf16,
    remat "dots"), then full mamba2-2.7b (64 layers) for a few steps; each
    run's launches counted from 0 and joined to the kernels line."""
    from repro_torch.launch import train as launcher
    from repro_torch.models import transformer as T
    from repro_torch import configs

    for arch, n_steps in (("qwen3-4b", TRAIN_STEPS), ("mamba2-2.7b", MAMBA_TRAIN_STEPS)):
        alloc = torch.cuda.memory_allocated() / 2**30
        check(alloc < 2.0, f"train {arch}: {alloc:.2f} GiB allocated before (a model is alive)")
        cfg = configs.get_config(arch)
        counters = zero_counters()
        torch.cuda.reset_peak_memory_stats()
        out = launcher.main(["--arch", arch, "--full", "--steps", str(n_steps), "--batch",
                             str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--accum", "1",
                             "--lr", "1e-3"])
        torch.cuda.synchronize()
        launches = Launches(counters)
        fold_launches(res, launches)
        if arch == "qwen3-4b":  # every forward (4 x 512) on the wgmma body
            check(0 < launches["flash_attention"] == launches.by_body["wg"],
                  f"train {arch}: prefill launches by body {launches.by_body}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses = out["losses"]
        check(all(math.isfinite(x) for x in losses) and losses[-1] < losses[0],
              f"train {arch}: losses {losses}")
        step_s = out["step_s"]
        p50 = float(np.median(step_s))
        tokens = TRAIN_BATCH * TRAIN_SEQ
        active = T.active_param_count(cfg)
        mfu = 6 * active * tokens / p50 / PEAK_FLOPS[torch.bfloat16]
        n_mixer = cfg.n_layers
        kernel = "flash_attention" if arch == "qwen3-4b" else "ssd"
        check(launches[kernel] >= n_mixer * n_steps,
              f"train {arch}: {launches[kernel]} {kernel} launches < {n_mixer} x {n_steps}")
        del out
        res13[arch] = {"losses": losses, "step_s": step_s, "step_s_p50": p50,
                       "tokens_per_s": tokens / p50, "mfu": mfu, "peak_gb": peak,
                       "launches": {k: v for k, v in launches.items() if v}}
        print(f"[train] (c) {arch} full ({cfg.n_layers} layers, {str(cfg.param_dtype)[6:]}, "
              f"remat {cfg.remat}, "
              f"{active / 1e9:.3f}B params), {n_steps} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, "
              f"accum 1, lr 1e-3, warmup 2: losses {[round(x, 4) for x in losses]}; step s "
              f"{[round(x, 3) for x in step_s]}, p50 {p50:.3f} s, {tokens / p50:.0f} tokens/s, "
              f"6 N tokens/s = {mfu:.3f} of 989 TFLOP/s; peak allocated {peak:.1f} GB; "
              f"launches {res13[arch]['launches']} ({smi})")
        print(f"[train] memory_reserved after dropping {arch}: {reserved_gib():.3f} GiB")


def work_trainer(cfg, tcfg, work_ms: float, params_fn):
    """A Trainer on the card that starts from ``params_fn()`` and whose
    synthetic source spends ``work_ms`` of host time a batch (the
    reference's ``SyntheticLM(work_ms=)``)."""
    from repro_torch.data.pipeline import PrefetchIterator, SyntheticLM
    from repro_torch.optim import adamw
    from repro_torch.runtime.trainer import Trainer

    class WorkTrainer(Trainer):
        def init_state(self, seed):
            params = params_fn()
            return params, adamw.init_state(params)

        def _source(self, start_step):
            src = SyntheticLM(self.cfg.vocab_size, global_batch=self.tcfg.global_batch,
                              seq_len=self.tcfg.seq_len, seed=self.tcfg.seed, work_ms=work_ms)
            return PrefetchIterator(iter(src), depth=self.tcfg.prefetch_depth,
                                    start_step=start_step, device=self.device)

    return WorkTrainer(cfg, tcfg, log=lambda *_: None, device="cuda")


def train_resume_prefetch(res13: dict) -> None:
    """(d) 2-layer full-width qwen3-4b (bf16): an uninterrupted 5-step run,
    then the same run with checkpoints every 3 steps whose last checkpoint
    is removed (a crash before the final save) and a resume: losses of
    steps 3-4 equal.  Then PrefetchIterator at depth 0 and 2 with host work
    of about half a step a batch: losses equal, walls printed."""
    import shutil

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.models import transformer as T
    from repro_torch.runtime.trainer import TrainConfig

    from repro_torch import configs
    cfg = dataclasses.replace(configs.get_config("qwen3-4b"), n_layers=2)
    params0 = T.init_params(cfg, 0, device="cuda")
    fresh = lambda: _clone_tree(params0)  # noqa: E731
    ck_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    kw = dict(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=5, log_every=100, lr=1e-3,
              warmup=2, checkpoint_every=3)
    with deterministic():
        full = work_trainer(cfg, TrainConfig(**kw), 0.0, fresh).train()
        t0 = time.perf_counter()
        work_trainer(cfg, TrainConfig(checkpoint_dir=str(ck_dir), **kw), 0.0,
                          fresh).train()
        ckpt_s = time.perf_counter() - t0
        ck = Checkpointer(str(ck_dir))
        check(ck.steps() == [2, 4], f"train resume: checkpoints {ck.steps()}")
        shutil.rmtree(ck._step_dir(4))
        t0 = time.perf_counter()
        resumed = work_trainer(cfg, TrainConfig(checkpoint_dir=str(ck_dir), **kw), 0.0,
                                    fresh).train()
        resume_s = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in ck_dir.rglob("*") if f.is_file()) / 1e9 / 2
    shutil.rmtree(ck_dir, ignore_errors=True)
    check(resumed["losses"] == full["losses"][3:],
          f"train resume: {resumed['losses']} != {full['losses'][3:]}")
    step_ms = float(np.median(full["step_s"])) * 1e3
    print(f"[train] (d) 2-layer full-width qwen3-4b bf16, 5 steps: resumed from step 2, "
          f"losses of steps 3-4 {resumed['losses']} bit-equal to the uninterrupted run's; "
          f"run with 2 async saves {ckpt_s:.1f} s, restore + 3 steps + final save "
          f"{resume_s:.1f} s, {size:.2f} GB a checkpoint; step p50 {step_ms:.1f} ms")
    work_ms = 0.5 * step_ms
    walls, losses = {}, {}
    for depth in (0, 2):
        with deterministic():
            tr = work_trainer(cfg, TrainConfig(prefetch_depth=depth, **dict(
                kw, steps=12, checkpoint_every=0)), work_ms, fresh)
            out = tr.train()
        walls[depth], losses[depth] = out["wall_s"], out["losses"]
    check(losses[0] == losses[2], f"train prefetch: depth 0 {losses[0]} != depth 2 {losses[2]}")
    res13["resume"] = {"ckpt_run_s": ckpt_s, "resume_s": resume_s, "ckpt_gb": size,
                       "step_ms": step_ms}
    res13["prefetch"] = {"work_ms": work_ms, "wall_s_depth0": walls[0],
                         "wall_s_depth2": walls[2]}
    print(f"[train] (d) prefetch, host work {work_ms:.1f} ms a batch, 12 steps: depth 0 wall "
          f"{walls[0]:.3f} s, depth 2 wall {walls[2]:.3f} s ({walls[0] / walls[2]:.2f}x); "
          f"losses bit-equal")


@contextlib.contextmanager
def deterministic():
    """Deterministic kernels where torch has them (the embedding's
    accumulating backward among them), so that equal runs give equal bits."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def phase_train(res: dict, smi: str) -> dict:
    """Phase 13: (a) the Functions against their plain versions at training
    shapes, (b) a 2-layer train step card vs CPU, (c) full-width training,
    (d) resume and prefetch."""
    res13: dict = {}
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for label, c in TRAIN_ATTN_CASES:
            train_attn_case(label, dtype, c, res13)
        train_ssd_case(dtype)
    print(f"[train] (a) {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    for arch in ("qwen3-4b", "mamba2-2.7b"):
        for accum in (1, 2):
            train_step_card_vs_cpu(arch, accum)
    print(f"[train] (b) {time.perf_counter() - t0:.1f}s")
    gc.collect()
    # The host issues a training step op by op, so a step's time includes
    # the collector's passes over every live object: the earlier phases'
    # objects are moved out of its way (gc.freeze) while (c) and (d) time
    # steps, and handed back after.
    gc.collect()
    tracked = len(gc.get_objects())
    gc.freeze()
    try:
        t0 = time.perf_counter()
        train_full(res, res13, smi)
        print(f"[train] (c) {time.perf_counter() - t0:.1f}s ({tracked} objects frozen)")
        t0 = time.perf_counter()
        train_resume_prefetch(res13)
        print(f"[train] (d) {time.perf_counter() - t0:.1f}s")
    finally:
        gc.unfreeze()
    print(f"[train] summary {json.dumps(res13)}")
    return res13


MESH_STEPS = 3  # phase 14a
DRYRUN_OUT = ROOT / "build" / "dryrun_qwen3_train_4k.json"


def mesh_env() -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


def mesh_step(res: dict, res14: dict, smi: str) -> None:
    """(a) Trainer(mesh=) over a 1 x 1 NCCL mesh against the single-device
    Trainer: the full qwen3-4b at phase 13c's settings for MESH_STEPS
    steps, deterministic kernels; losses and params bit-equal."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.core.tree import tree_paths
    from repro_torch.launch import mesh as M
    from repro_torch.runtime.trainer import TrainConfig, Trainer

    cfg = configs.get_config("qwen3-4b")
    tcfg = TrainConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ, steps=MESH_STEPS,
                       accum=1, log_every=100, lr=1e-3, warmup=2)
    quiet = lambda *_: None  # noqa: E731
    alloc = torch.cuda.memory_allocated() / 2**30
    check(alloc < 2.0, f"mesh: {alloc:.2f} GiB allocated before (a model is alive)")
    with deterministic():
        one = Trainer(cfg, tcfg, device="cuda", log=quiet).train()
    want = {path: t.detach().cpu() for path, t in tree_paths(one["params"])}
    want_losses, one_p50 = one["losses"], float(np.median(one["step_s"]))
    del one
    gc.collect()
    torch.cuda.empty_cache()
    dev = M.init_distributed("cuda")
    try:
        mesh = M.make_host_mesh(data=1, model=1)
        counters = zero_counters()
        torch.cuda.reset_peak_memory_stats()
        with deterministic():
            out = Trainer(cfg, tcfg, mesh=mesh, device=dev, log=quiet).train()
        torch.cuda.synchronize()
        launches = Launches(counters)
        peak = torch.cuda.max_memory_allocated() / 1e9
        worst, where = 0.0, None
        for path, t in tree_paths(out["params"]):
            d = float((t.detach().to_local().float() - want[path].to(t.device).float()).abs().max())
            if d > worst:
                worst, where = d, path
        placements = str(out["params"]["blocks"]["layer0"]["mixer"]["wq"].placements)
        losses, step_s = out["losses"], out["step_s"]
        del out
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    fold_launches(res, launches)
    check(losses == want_losses and worst == 0.0,
          f"mesh 1 x 1: losses {losses} vs single device {want_losses}; largest param "
          f"difference {worst:.3e} at {where}")
    n_fa = launches["flash_attention"]
    check(n_fa >= cfg.n_layers * MESH_STEPS,
          f"mesh 1 x 1: {n_fa} flash_attention launches < {cfg.n_layers} x {MESH_STEPS}")
    p50 = float(np.median(step_s))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    res14["step"] = {"losses": losses, "step_s": step_s, "step_s_p50": p50,
                     "single_device_step_s_p50": one_p50,
                     "tokens_per_s": tokens / p50, "peak_gb": peak,
                     "launches": {k: v for k, v in launches.items() if v}}
    print(f"[mesh] (a) qwen3-4b full ({cfg.n_layers} layers, bf16, remat {cfg.remat}), "
          f"Trainer(mesh=1 x 1 over NCCL), {MESH_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}: "
          f"losses {[round(x, 4) for x in losses]} bit-equal to the single-device Trainer's, "
          f"every param bit-equal (wq placed {placements}); step s "
          f"{[round(x, 3) for x in step_s]}, p50 {p50:.3f} s (single device {one_p50:.3f} s), "
          f"{tokens / p50:.0f} tokens/s; "
          f"peak allocated {peak:.1f} GB; launches {res14['step']['launches']} ({smi})")


def mesh_launcher(res14: dict) -> None:
    """(b) The launcher under torch.distributed.run, one rank over NCCL,
    on the 2-layer full-width qwen3-4b."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m", "repro_torch.launch.train", "--mesh-data", "1",
           "--mesh-model", "1", "--full", "--layers", "2", "--steps", "4", "--batch",
           str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env=mesh_env(), capture_output=True, text=True,
                         timeout=300)
    wall = time.perf_counter() - t0
    line = next((ln for ln in out.stdout.splitlines() if ln.startswith("[train] ")), "")
    check(out.returncode == 0 and line, f"mesh launcher: exit {out.returncode}\n"
          f"{out.stdout[-2000:]}\n{out.stderr[-3000:]}")
    first, last = (float(x) for x in line.split("loss ")[1].split(" in ")[0].split(" -> "))
    check(last < first, f"mesh launcher: loss {first} -> {last}")
    res14["launcher"] = {"exit": out.returncode, "loss_first": first, "loss_last": last,
                         "wall_s": wall}
    print(f"[mesh] (b) {' '.join(cmd[1:])}: exit {out.returncode} in {wall:.1f} s; {line}")


def mesh_dryrun_start() -> subprocess.Popen:
    """(c) The dry run, started in the background on the CPU (fake world)."""
    DRYRUN_OUT.unlink(missing_ok=True)
    env = dict(mesh_env(), CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-4b", "--shape",
           "train_4k", "--mesh", "single", "--out", str(DRYRUN_OUT)]
    return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def mesh_dryrun_finish(proc: subprocess.Popen, res14: dict, t_start: float) -> None:
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    wall = time.perf_counter() - t_start
    check(proc.returncode == 0 and DRYRUN_OUT.exists(),
          f"dryrun: exit {proc.returncode}\n{stdout[-2000:]}\n{stderr[-3000:]}")
    r = json.loads(DRYRUN_OUT.read_text())[0]
    check(r["hlo_flops"] > 0 and r["mem_temp_bytes"] > 0 and "all-gather" in
          r["collective_breakdown"], f"dryrun: {r}")
    keep = ("mesh", "n_chips", "accum", "mem_argument_bytes", "mem_output_bytes",
            "mem_temp_bytes", "hlo_flops", "hlo_bytes", "collective_bytes",
            "collective_breakdown", "bottleneck", "t_compute_s", "t_memory_s",
            "t_collective_s", "model_flops", "useful_flops_ratio", "trace_s")
    res14["dryrun"] = {k: r[k] for k in keep}
    print(f"[mesh] (c) dryrun qwen3-4b train_4k on a fake {r['mesh']} world (rank 0, "
          f"{r['n_chips']} ranks, accum {r['accum']}, CPU, {wall:.1f} s wall): per-rank "
          f"memory arguments {r['mem_argument_bytes'] / 1e9:.3f} GB, outputs "
          f"{r['mem_output_bytes'] / 1e9:.3f} GB, temporaries {r['mem_temp_bytes'] / 1e9:.3f} GB; "
          f"flops {r['hlo_flops']:.4e} a rank ({r['hlo_flops'] * r['n_chips']:.4e} in all) "
          f"against the analytic 6 N D {r['model_flops']:.4e} (ratio "
          f"{r['useful_flops_ratio']:.3f}); bytes {r['hlo_bytes']:.4e}; collective bytes "
          f"{json.dumps(r['collective_breakdown'])}; bottleneck {r['bottleneck']} "
          f"(compute {r['t_compute_s']:.3f} s, memory {r['t_memory_s']:.3f} s, collective "
          f"{r['t_collective_s']:.3f} s at H100 peaks)")


def phase_mesh(res: dict, smi: str) -> dict:
    """Phase 14: (a) the world-of-1 sharded Trainer against the
    single-device one, (b) the launcher under torch.distributed.run, (c)
    the dry run, beside them on the CPU."""
    res14: dict = {}
    t0 = time.perf_counter()
    dry = mesh_dryrun_start()
    try:
        gc.collect()
        tracked = len(gc.get_objects())
        gc.freeze()  # as phase 13: the collector stays off the earlier phases' objects
        try:
            mesh_step(res, res14, smi)
        finally:
            gc.unfreeze()
        print(f"[mesh] (a) {time.perf_counter() - t0:.1f}s ({tracked} objects frozen)")
        t1 = time.perf_counter()
        mesh_launcher(res14)
        print(f"[mesh] (b) {time.perf_counter() - t1:.1f}s")
    finally:
        mesh_dryrun_finish(dry, res14, t0)
    print(f"[mesh] summary {json.dumps(res14)}")
    return res14


# -- phase 15: the last modules -----------------------------------------------------

LAST_B, LAST_S, LAST_CHUNK, LAST_NEW = 2, 512, 64, 16  # 15a's prompt, chunk, new tokens
# 15a: max |streamed - one-shot| of the last logits over the one-shot's largest
# magnitude.  Both paths round every activation to bf16 (2^-8 relative) but
# group the matmuls and the prefill kernel's key splits differently, and 36
# layers carry a last-bit difference on: a few bf16 ulps of the logits, so
# 5e-2 leaves room without admitting a wrong mask or position (O(1)).
LAST_RTOL = 5e-2
E2E_CKPT = ROOT / "build" / "e2e_ckpt"  # train_e2e's checkpoints (git-ignored)
# Each example at the reference's default arguments, and the kernels its path
# must launch (serve_streamed's n-gram drafts rarely fire on random prompts, so
# its verify entry may not run).
EXAMPLE_RUNS = (
    ("quickstart", [], ("flash_attention",)),
    ("serve_streamed", [], ("flash_attention", "paged_attention", "paged_attention_quant")),
    ("overlap_demo", [], ("streamed_matmul", "fwt", "fwt_columns", "nw_tile")),
    ("nw_wavefront", [], ("nw_tile",)),
    ("train_e2e", ["--size", "10m", "--steps", "40", "--ckpt", str(E2E_CKPT)],
     ("flash_attention",)),
)


def measured_prefill(res: dict, label: str, run, flash: int) -> tuple[torch.Tensor, dict]:
    """``run()`` (a prefill of the full model, warmed once before) with the
    launch counts at 0 and the peak memory reset just before it: its wall
    (synchronized), peak allocated and the peak above what was allocated
    before (caches + activations), and exactly ``flash`` prefill launches
    (nothing else launches).  Returns (its logits, the row)."""
    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        logits, launches = count_launches(
            label, run, lambda _: {name: 0 for name in KERNELS} | {"flash_attention": flash})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fold_launches(res, launches)
    peak = torch.cuda.max_memory_allocated()
    return logits.clone(), {"wall_ms": wall * 1e3, "peak_gb": peak / 1e9,
                            "above_base_gb": (peak - base) / 1e9,
                            "flash_launches": launches["flash_attention"],
                            "flash_by_body": launches.by_body}


def phase_last_full(res: dict, main: tuple) -> dict:
    """Phase 15a: on phase 5's full qwen3-4b, ServingEngine.prefill_streamed
    of a B 2 x 512 prompt in chunks of 64 against transformer.prefill of the
    same prompt in one shot (the check), then generate of 16 tokens through
    prefill_streamed."""
    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T
    from repro_torch.runtime.serving import ServeConfig, ServingEngine

    cfg, params = qwen3_4b.CONFIG, main[2]
    max_seq = LAST_S + LAST_NEW
    tokens = torch.randint(0, cfg.vocab_size, (LAST_B, LAST_S), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(15)).cuda()
    eng = ServingEngine(cfg, params, ServeConfig(
        max_seq=max_seq, prefill_chunk=LAST_CHUNK, max_new_tokens=LAST_NEW),
        device="cuda", unembed=T.unembed_f32(cfg, params))
    n_chunks = LAST_S // LAST_CHUNK
    streamed, row_s = measured_prefill(res, "prefill_streamed",
                                       lambda: eng.prefill_streamed(tokens)[0],
                                       cfg.n_layers * n_chunks)
    one, row_o = measured_prefill(res, "transformer.prefill", lambda: T.prefill(
        cfg, params, {"tokens": tokens}, max_seq=max_seq, unembed=eng.unembed)[0],
        cfg.n_layers)
    check(row_o["flash_by_body"]["wg"] == cfg.n_layers,
          f"transformer.prefill (B {LAST_B} x {LAST_S}): prefill launches by body "
          f"{row_o['flash_by_body']}, want all {cfg.n_layers} on the wgmma body")
    check(streamed.shape == one.shape == (LAST_B, 1, cfg.padded_vocab),
          f"last logits {tuple(streamed.shape)} / {tuple(one.shape)}")
    check(bool(torch.isfinite(streamed).all() and torch.isfinite(one).all()),
          "non-finite last logits")
    scale = one.abs().max().item()
    err = (streamed - one).abs().max().item()
    check(err <= LAST_RTOL * scale, f"streamed vs one-shot: max |dlogit| {err} > "
          f"{LAST_RTOL} x {scale}")
    agree = (streamed.argmax(-1) == one.argmax(-1)).float().mean().item()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, launches = count_launches(
        "generate", lambda: eng.generate(tokens),
        lambda _: {name: 0 for name in KERNELS} | {"flash_attention": cfg.n_layers * n_chunks})
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    fold_launches(res, launches)
    check(tuple(toks.shape) == (LAST_B, LAST_NEW)
          and bool(((toks >= 0) & (toks < cfg.padded_vocab)).all()), f"generate: {toks}")
    check(torch.equal(toks[:, 0], streamed[:, -1].argmax(-1).to(toks.dtype)),
          "generate's first token is not the argmax of prefill_streamed's logits")
    out = {"prompt": [LAST_B, LAST_S], "chunk": LAST_CHUNK, "streamed": row_s,
           "one_shot": row_o, "max_abs_dlogit": err, "one_shot_max_abs": scale,
           "rel": err / scale, "tol": LAST_RTOL, "argmax_agreement": agree,
           "generate": {"tokens": LAST_NEW, "wall_s": gen_s, "flash_launches":
                        launches["flash_attention"]}}
    print(f"[last] full qwen3-4b, B {LAST_B} x {LAST_S} tokens: prefill_streamed ({n_chunks} "
          f"chunks of {LAST_CHUNK}) {row_s['wall_ms']:.2f} ms, peak {row_s['peak_gb']:.3f} GB "
          f"({row_s['above_base_gb']:.3f} above what was allocated before), "
          f"{row_s['flash_launches']} prefill launches; transformer.prefill (one shot) "
          f"{row_o['wall_ms']:.2f} ms, peak {row_o['peak_gb']:.3f} GB "
          f"({row_o['above_base_gb']:.3f} above), "
          f"{row_o['flash_launches']} launches (by body: streamed {row_s['flash_by_body']}, "
          f"one shot {row_o['flash_by_body']}); max |dlogit| {err:.4e} = {err / scale:.3e} of "
          f"{scale:.3f} (tol {LAST_RTOL}), argmax agreement {agree:.2f}; generate "
          f"{LAST_NEW} tokens {gen_s:.3f} s ({launches['flash_attention']} launches)")
    del eng
    return out


def phase_last_examples(res: dict) -> dict:
    """Phase 15b: each repro_torch.examples module's main in process at the
    reference's default arguments, on the card, with the launch counts at 0
    just before it; it returns 0 and its path's kernels launch."""
    import importlib
    import shutil

    out = {}
    for name, argv, kernels in EXAMPLE_RUNS:
        module = importlib.import_module(f"repro_torch.examples.{name}")
        shutil.rmtree(E2E_CKPT, ignore_errors=True)
        counters = zero_counters()
        t0 = time.perf_counter()
        rc = module.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = Launches(counters)
        check(rc == 0, f"examples.{name} returned {rc}")
        for k in kernels:
            check(launches[k] > 0, f"examples.{name}: {k} not launched")
        fold_launches(res, launches)
        out[name] = {"argv": argv, "wall_s": wall,
                     "launches": {k: n for k, n in launches.items() if n}}
        print(f"[last] examples.{name} {' '.join(argv)}: exit 0 in {wall:.1f}s; launches "
              f"{out[name]['launches']}")
    shutil.rmtree(E2E_CKPT, ignore_errors=True)
    return out


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
    cache = phase_cache_paths(res, main_path, profile=args.profile)
    print(f"[cache] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_sharing_sampling(res, main_path)
    print(f"[share] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_obs_policy(res, main_path)
    print(f"[obs] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_tune(res, main_path)
    print(f"[tune] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_analysis(res, main_path, cache)
    print(f"[analysis] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    last = {"full": phase_last_full(res, main_path)}
    t_last = time.perf_counter() - t0
    print(f"[last] (a) {t_last:.1f}s")
    del main_path  # the full model's weights
    t0 = time.perf_counter()
    phase_main_mamba(res, profile=args.profile)
    print(f"[mamba] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_streams(res)
    print(f"[streams] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_zoo(res, profile=args.profile)
    print(f"[zoo] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_rest(res, profile=args.profile)
    print(f"[rest] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_train(res, smi)
    print(f"[train] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_mesh(res, smi)
    print(f"[mesh] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    last["examples"] = phase_last_examples(res)
    print(f"[last] (b) {time.perf_counter() - t0:.1f}s")
    print(f"[last] summary {json.dumps(last)}")
    print(f"[last] {t_last + time.perf_counter() - t0:.1f}s")
    kernels = [{"name": n, "route": "cuda", "source": KERNELS[n][0],
                "replaces": KERNELS[n][1], "launches": r["launches"],
                "max_abs_err": r["err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"]}
               | ({"launches_by_body": r["launches_by_body"]} if "launches_by_body" in r else {})
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
