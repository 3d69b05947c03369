#!/usr/bin/env python3
"""Chip smoke of the PyTorch port: builds its CUDA kernels, holds each
against its plain PyTorch version, holds the card against the CPU on a
2-layer full-width qwen3-4b, then serves requests through the full 36-layer
bf16 qwen3-4b on the card.

    python3 chip_smoke.py            # every phase, on one CUDA card
    python3 chip_smoke.py --profile  # the same, plus a torch.profiler serve

Phases (any failed check raises, and the script exits non-zero):
  1. device: card name and power limit (nvidia-smi), torch and CUDA versions;
     TF32 off for matmuls and cuDNN so f32 means f32.
  2. build: every kernel from src/repro_torch/kernels/csrc, timed.
  3. kernels: each kernel against its plain version in f32 (atol 1e-5) and
     bf16 (atol 2e-2) at the serving shapes; kernel, plain, SDPA (library)
     times and the memory/compute bound.
  4. card vs CPU: qwen3-4b at full width cut to 2 layers, f32, 6 requests
     served on cuda (kernels) and on cpu (plain versions): admission logits
     allclose (atol 2e-3, rtol 1e-3) and greedy tokens identical per uid.
  5. main path: full qwen3-4b (36 layers, bf16, random weights from a seed)
     serves the same 6 requests; tokens/s, decode-tick and prefill-chunk
     times; each kernel launched 36 times per decode tick / prefill chunk.
With --profile, phase 5 adds a torch.profiler breakdown (device busy time
by kernel, idle share).  The last two lines of stdout are the kernels JSON
and the result JSON.
"""

from __future__ import annotations

import argparse
import dataclasses
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
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # kernel vs plain, max abs
LOGIT_ATOL, LOGIT_RTOL = 2e-3, 1e-3  # card vs CPU, f32, 2 layers
PROMPT_LENS = (128, 100, 77, 128, 64, 33)
NEW_TOKENS, SLOTS, CHUNK, BLOCK = 16, 4, 64, 16


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


def paged_bytes_flops(q, kp, pt, cl, window):
    """Bytes and flops the function needs: q read and the output written
    once, the table and lengths, and K and V of positions lo..cur_len only."""
    hkv, hd = kp.shape[2], kp.shape[3]
    keys = 0
    for c in cl.tolist():
        lo = max(0, c - window + 1) if window else 0
        keys += c - lo + 1
    nbytes = (2 * q.numel() * q.element_size() + pt.numel() * 4 + cl.numel() * 4
              + 2 * keys * hkv * hd * kp.element_size())
    return nbytes, 4.0 * keys * q.shape[1] * hd


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


def phase_kernels() -> dict:
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import paged_attention as PA

    scale = 1.0 / math.sqrt(128)
    res = {"paged_attention": {"err": 0.0}, "flash_attention": {"err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        cases = [dict(cur=[0, 15, 16, 100], trash_row=0),
                 dict(cur=[143, 100, 15, 16]),
                 dict(cur=[143, 100, 15, 16], window=32),
                 dict(cur=[143, 100, 15, 0], softcap=30.0, trash_row=3)]
        for i, c in enumerate(cases):
            kw = {k: c[k] for k in ("window", "softcap") if k in c}
            q, kp, vp, pt, cl = paged_case(dtype, c["cur"], trash_row=c.get("trash_row"),
                                           seed=i)
            got = ops.paged_attention(q, kp, vp, pt, cl, **kw)
            want = PA.paged_attention_plain(q, kp, vp, pt, cl, scale=scale, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"paged {dtype} {c}: non-finite")
            check(err <= TOL[dtype], f"paged {dtype} {c}: max abs err {err}")
            res["paged_attention"]["err"] = max(res["paged_attention"]["err"], err)
            print(f"[kernels] paged_attention {str(dtype):14s} {c}: max abs err {err:.3e} "
                  f"(tol {TOL[dtype]})")
        for i, (sq, off, kw) in enumerate([(64, 0, {}), (64, 64, {}), (36, 64, {}),
                                           (64, 64, dict(window=32, softcap=30.0))]):
            q, k, v = flash_case(dtype, sq, off, seed=i)
            got = ops.flash_attention(q, k, v, q_offset=off, **kw)
            want = FA.flash_attention_plain(q, k, v, scale=scale, q_offset=off, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            check(bool(torch.isfinite(got).all()), f"flash {dtype} {sq},{off}: non-finite")
            check(err <= TOL[dtype], f"flash {dtype} Sq={sq} q_offset={off} {kw}: "
                                     f"max abs err {err}")
            res["flash_attention"]["err"] = max(res["flash_attention"]["err"], err)
            print(f"[kernels] flash_attention {str(dtype):14s} Sq={sq} q_offset={off} "
                  f"{kw}: max abs err {err:.3e} (tol {TOL[dtype]})")

    # Times at the main path's shapes: bf16, 4 slots, 9 pages of 16; a 64-token
    # chunk at q_offset 64 (the second chunk of a 128-token prompt).
    dt = torch.bfloat16
    q, kp, vp, pt, cl = paged_case(dt, [143, 115, 92, 80], seed=9)
    pt_l = pt.long()
    b, n_pages, bs = pt.shape[0], pt.shape[1], kp.shape[1]
    kc = kp[pt_l].reshape(b, n_pages * bs, 8, 128).transpose(1, 2).contiguous()
    vc = vp[pt_l].reshape(b, n_pages * bs, 8, 128).transpose(1, 2).contiguous()
    mask = (torch.arange(n_pages * bs, device="cuda")[None, :] <= cl.long()[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    r = res["paged_attention"]
    r["ms"] = time_ms(lambda: ops.paged_attention(q, kp, vp, pt, cl))
    r["plain_ms"] = time_ms(lambda: PA.paged_attention_plain(q, kp, vp, pt, cl, scale=scale))
    r["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kc, vc, attn_mask=mask, scale=scale, enable_gqa=True))
    r["bound_ms"], r["bound_by"] = bound(*paged_bytes_flops(q, kp, pt, cl, 0), dt)

    q, k, v = flash_case(dt, 64, 64, seed=9)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qpos = torch.arange(64, 128, device="cuda")[:, None]
    fmask = qpos >= torch.arange(128, device="cuda")[None, :]
    r = res["flash_attention"]
    r["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, q_offset=64))
    r["plain_ms"] = time_ms(lambda: FA.flash_attention_plain(q, k, v, scale=scale,
                                                             q_offset=64))
    r["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=fmask, scale=scale, enable_gqa=True))
    r["bound_ms"], r["bound_by"] = bound(*flash_bytes_flops(q, k, 64, 0), dt)
    for name, r in res.items():
        print(f"[kernels] {name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
              f"SDPA {r['library_ms']:.4f} ms, bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    return res


# -- phases 4 and 5: serving -------------------------------------------------------


def prompts(vocab: int) -> list[np.ndarray]:
    rng = np.random.default_rng(1)
    return [rng.integers(0, vocab, n, dtype=np.int32) for n in PROMPT_LENS]


def serve(cfg, params, device, reqs):
    """Serve ``reqs`` on ``device``; returns (engine, tokens per request,
    admission logits per request, per-tick seconds, wall seconds)."""
    from repro_torch.runtime.serving import ServeConfig, StreamedBatchEngine

    class Engine(StreamedBatchEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.logits, self.ticks = {}, []

        def _on_admit_logits(self, uid, logits):
            self.logits[uid] = logits.float().cpu()

        def _decode_tick(self):
            t0 = time.perf_counter()
            super()._decode_tick()  # ends in the picks' device-to-host copy
            self.ticks.append(time.perf_counter() - t0)

    max_seq = -(-(max(PROMPT_LENS) + NEW_TOKENS) // BLOCK) * BLOCK
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=CHUNK, max_new_tokens=NEW_TOKENS,
                       max_batch=SLOTS, block_size=BLOCK)
    eng = Engine(cfg, params, scfg, device=device)
    t0 = time.perf_counter()
    uids = [eng.submit(p) for p in reqs]
    out = eng.run()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (eng, [out[u] for u in uids], [eng.logits[u] for u in uids], eng.ticks, wall)


def phase_card_vs_cpu() -> None:
    from repro_torch.configs import qwen3_4b
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(qwen3_4b.CONFIG, n_layers=2, param_dtype=torch.float32,
                              compute_dtype=torch.float32)
    cpu_params = T.init_params(cfg, 0, device="cpu")

    def to_cuda(t):
        return {k: to_cuda(v) if isinstance(v, dict) else v.to("cuda")
                for k, v in t.items()}

    reqs = prompts(cfg.vocab_size)
    _, tok_gpu, log_gpu, _, wall_gpu = serve(cfg, to_cuda(cpu_params), "cuda", reqs)
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


def phase_profile(cfg, params, reqs) -> None:
    """torch.profiler over one more serve of the requests: device busy time
    by kernel, and the device's idle share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, _, _, wall = serve(cfg, params, "cuda", reqs)
    kern = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kern)
    groups: dict[str, float] = {}
    for name, ms, _ in kern:
        low = name.lower()
        group = ("paged_attention" if "paged_attention" in low else
                 "flash_attention" if "flash_attention" in low else
                 "matmul" if any(w in low for w in ("gemm", "gemv", "nvjet", "xmma",
                                                     "cutlass"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
    print(f"[profile] serve of {len(reqs)} requests: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {1 - busy / (wall * 1e3):.3f}; by group (ms) "
          + json.dumps({k: round(v, 3) for k, v in sorted(groups.items())}))
    for name, ms, n in sorted(kern, key=lambda r: -r[1])[:10]:
        print(f"[profile]   {ms:9.3f} ms  {n:6d} x  {name[:100]}")


def phase_main_path(res: dict, *, profile: bool = False) -> dict:
    from repro_torch.configs import qwen3_4b
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
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

    PA.KERNEL.launches = 0
    FA.KERNEL.launches = 0
    eng, toks, logits, ticks, wall = serve(cfg, params, "cuda", reqs)
    launches = {"paged_attention": PA.KERNEL.launches,
                "flash_attention": FA.KERNEL.launches}

    for i, (t, lg) in enumerate(zip(toks, logits)):
        check(len(t) == NEW_TOKENS, f"request {i}: {len(t)} tokens")
        check(bool(((t >= 0) & (t < cfg.padded_vocab)).all()), f"request {i}: {t}")
        check(bool(torch.isfinite(lg).all()), f"request {i}: non-finite logits")
    check(launches["paged_attention"] == cfg.n_layers * eng.decode_steps > 0,
          f"paged_attention launches {launches['paged_attention']} != "
          f"{cfg.n_layers} x {eng.decode_steps} ticks")
    check(launches["flash_attention"] == cfg.n_layers * eng.prefill_chunks > 0,
          f"flash_attention launches {launches['flash_attention']} != "
          f"{cfg.n_layers} x {eng.prefill_chunks} chunks")

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
           "launches": launches,
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
    for name in res:
        res[name]["launches"] = launches[name]
    return e2e


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
    phase_card_vs_cpu()
    print(f"[card_vs_cpu] {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    phase_main_path(res, profile=args.profile)
    print(f"[main] {time.perf_counter() - t0:.1f}s")
    meta = {"paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                                "src/repro/kernels/paged_attention.py:40"),
            "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:32")}
    kernels = [{"name": n, "route": "cuda", "source": meta[n][0], "replaces": meta[n][1],
                "launches": r["launches"], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
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
