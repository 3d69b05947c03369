"""Serving launcher of the port: N requests through the continuous-batching
engine, or one batch at a time through ``ServingEngine.generate``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --requests 4 --prompt-len 128 --new-tokens 16 [--device cpu] \
        [--temperature 0.8] [--paged [--num-blocks N] [--kv-dtype int8|fp8] \
        [--prefix-sharing [--prefix-min-pages 1] [--prefix-store PATH]]] \
        [--spec-decode --spec-k 4 --spec-ngram 3] [--sequential]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        [--paged] [--state-snapshots] [--device cpu]

``--arch`` takes every arch of ``configs.list_archs()``: qwen3-4b,
mamba2-2.7b, internlm2-20b, phi4-mini-3.8b, gemma2-27b, qwen2-moe-a2.7b and
mixtral-8x7b.

Without ``--paged`` each slot holds a contiguous cache of ``max_seq`` rows
(the reference's default); with it the slots share a page pool, and a pool
too small for every slot's growth preempts (the line counts preemptions).
``--sequential`` serves the requests as one batch through the single-request
``ServingEngine.generate`` instead, as the reference launcher does.  With
``--prefix-sharing`` the first page-aligned half of every prompt is one
shared system prompt (the reference's workload) and the line counts the
prefix hits, the pages mapped and the COW forks; ``--prefix-store`` restores
the registry from PATH at start and saves it at the end (run twice to see
``N restored``).

Like the reference launcher it serves the arch's smoke-size config with
random weights from a fixed seed.  It runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.runtime.serving import ServeConfig, ServingEngine, StreamedBatchEngine


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=configs.list_archs())
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; else each request samples from its own stream")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="decode slots for continuous batching")
    ap.add_argument("--interleave", type=int, default=1,
                    help="decode steps per in-flight prefill chunk")
    ap.add_argument("--sequential", action="store_true",
                    help="force the one-request-at-a-time baseline (ServingEngine.generate)")
    ap.add_argument("--paged", action="store_true",
                    help="page the batched KV cache (global pool + free list + per-slot "
                         "page tables)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="cache rows per KV page")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="page-pool size; default = every slot at max_seq")
    ap.add_argument("--kv-dtype", default="fp32", choices=("fp32", "int8", "fp8"),
                    help="KV page storage: full precision, or int8 / fp8 codes with "
                         "per-(page, kv head) scales")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="map common page-aligned prompt prefixes to the same physical "
                         "pages (copy-on-write; needs --paged)")
    ap.add_argument("--prefix-min-pages", type=int, default=1,
                    help="shortest prefix worth sharing, in pages")
    ap.add_argument("--prefix-store", default=None, metavar="PATH",
                    help="persist the prefix registry across runs (restored at start, "
                         "saved after the run; needs --prefix-sharing)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="speculative decode: n-gram drafts, one batched verify step")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--spec-ngram", type=int, default=3,
                    help="longest n-gram the prompt-lookup drafter matches")
    ap.add_argument("--state-snapshots", action="store_true",
                    help="mamba: reuse chunk-aligned SSM-state snapshots across requests")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.prefix_sharing and not args.paged:
        ap.error("--prefix-sharing requires --paged")
    cfg = configs.get_smoke_config(args.arch)
    device = resolve_device(args.device)

    params = T.init_params(cfg, 0, device=device)
    max_seq = -(-(args.prompt_len + args.new_tokens) // args.block_size) * args.block_size
    scfg = ServeConfig(max_seq=max_seq, prefill_chunk=args.prefill_chunk,
                       max_new_tokens=args.new_tokens, temperature=args.temperature,
                       max_batch=args.max_batch, decode_interleave=args.interleave,
                       block_size=args.block_size, num_blocks=args.num_blocks,
                       kv_dtype=args.kv_dtype, prefix_sharing=args.prefix_sharing,
                       prefix_min_pages=args.prefix_min_pages, spec_decode=args.spec_decode,
                       spec_k=args.spec_k, spec_ngram=args.spec_ngram, paged=args.paged,
                       state_snapshots=args.state_snapshots, prefix_store=args.prefix_store)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len), dtype=np.int32)
    if args.prefix_sharing:
        # The shared-system-prompt workload: the first page-aligned half of
        # every prompt is one prefix, the tails stay unique.
        sys_len = max(args.block_size,
                      (args.prompt_len // 2) // args.block_size * args.block_size)
        tokens[:, :sys_len] = rng.integers(0, cfg.vocab_size, sys_len, dtype=np.int32)

    if args.sequential:
        single = ServingEngine(cfg, params, scfg, device=device,
                               unembed=T.unembed_f32(cfg, params))
        t0 = time.perf_counter()
        rows = single.generate(tokens).cpu().numpy().tolist()
        dt = time.perf_counter() - t0
        total_new = sum(len(r) for r in rows)
        print(f"[serve] {args.arch} on {device} (sequential-batch, contiguous cache): "
              f"{args.requests} requests x {args.prompt_len} prompt -> "
              f"{total_new // args.requests} new tokens each in {dt:.2f}s "
              f"({total_new / dt:.1f} tok/s incl. prefill)")
        for i, row in enumerate(rows[:3]):
            print(f"[serve] req{i}: {row[:12]}{'...' if len(row) > 12 else ''}")
        return
    eng = StreamedBatchEngine(cfg, params, scfg, device=device)
    t0 = time.perf_counter()
    uids = [eng.submit(t) for t in tokens]
    outs = eng.run()
    saved = eng.save_prefixes()
    dt = time.perf_counter() - t0
    rows = [outs[u].tolist() for u in uids]
    total_new = sum(len(r) for r in rows)
    spec = ""
    if args.spec_decode:
        rate = eng.spec_accepted / eng.spec_proposed if eng.spec_proposed else 0.0
        spec = (f", spec k={args.spec_k}: {eng.spec_ticks} verify ticks, acceptance "
                f"{rate:.2f} ({eng.spec_accepted}/{eng.spec_proposed})")
    if args.state_snapshots:
        spec += (f", state snapshots: {eng.snapshot_hits} hits, "
                 f"{eng.snapshot_tokens_reused} tokens reused")
    if args.paged:
        st = eng.kv.stats(active_slots=eng.peak_active)
        cache = (f"paged block={eng.kv.block_size} kv_dtype={args.kv_dtype} (peak "
                 f"{st.peak_in_use}/{st.capacity} pages, page_bytes={st.page_bytes}, "
                 f"preemptions={eng.preemptions})")
        if args.prefix_sharing:
            cache += (f", prefix-sharing {eng.prefix_hits} hits / "
                      f"{eng.prefix_pages_shared} pages mapped, "
                      f"{eng.kv.cow_forks} cow_forks")
        if args.prefix_store:
            cache += f", prefix-store {eng.prefixes_restored} restored / {saved} saved"
    else:
        cache = "contiguous slot cache"
    temp = f"temperature {args.temperature}" if args.temperature > 0 else "greedy"
    print(f"[serve] {args.arch} on {device} (continuous-batching x{args.max_batch} "
          f"slots, {temp}, {eng.decode_steps} batched decode steps{spec}, {cache}): "
          f"{args.requests} requests x {args.prompt_len} prompt -> "
          f"{total_new // args.requests} new tokens each in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. prefill)")
    for i, row in enumerate(rows[:3]):
        print(f"[serve] req{i}: {row[:12]}{'...' if len(row) > 12 else ''}")


if __name__ == "__main__":
    main()
