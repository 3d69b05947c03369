"""Serving launcher of the port: N requests through the continuous-batching
engine, or one batch at a time through ``ServingEngine.generate``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --requests 4 --prompt-len 128 --new-tokens 16 [--device cpu] \
        [--temperature 0.8] [--paged [--num-blocks N] [--kv-dtype int8|fp8] \
        [--prefix-sharing [--prefix-min-pages 1] [--prefix-store PATH]]] \
        [--spec-decode --spec-k 4 --spec-ngram 3] [--sequential] \
        [--trace PATH] [--metrics] [--metrics-out PATH] [--slo-ttft-ms MS] [--slo-itl-ms MS] \
        [--autotune [--tuning-db PATH] [--tune-budget N] [--retune]]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        [--paged] [--state-snapshots] [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium [--paged]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch paligemma-3b

``--arch`` takes every arch of ``configs.list_archs()``: qwen3-4b,
mamba2-2.7b, internlm2-20b, phi4-mini-3.8b, gemma2-27b, qwen2-moe-a2.7b,
mixtral-8x7b, jamba-1.5-large-398b, whisper-medium and paligemma-3b.
whisper-medium gives each request synthetic encoder frames (0.1 x a
normal draw from a fixed seed, ``enc_inputs``); paligemma-3b is served one
batch at a time through ``ServingEngine.generate`` with synthetic image
embeddings (``prefix_embeds``), as the reference launcher does.

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

``--trace PATH`` records the engine's spans and writes a Chrome trace
(open it at ui.perfetto.dev; ``python -m repro_torch.obs.doctor PATH
[--metrics SNAP]`` diagnoses it) and prints the measured overlap and the
per-request latencies; ``--metrics`` prints ``metrics_snapshot()`` and
``--metrics-out PATH`` writes it; ``--slo-ttft-ms`` / ``--slo-itl-ms`` score
every request against those targets (the snapshot's ``derived.slo``).  They
instrument the batched engine, so they reject ``--sequential`` and
paligemma-3b, as the reference launcher does.

``--autotune`` tunes the batched engine's knobs by measurement
(``repro_torch.tuning``: profile the device, warm-start from the paper's
generic flow, coordinate-descend on measured tokens/s), keeps the plan in
the tuning db under a fingerprint of (device, model, serving mode,
workload bucket) and serves with it; a second run with the same flags
finds the plan there ("cached") unless ``--retune``.  Like the tuning
flags of the reference launcher, it acts on the batched engine only (not
``--sequential``, not paligemma-3b).

Like the reference launcher it serves the arch's smoke-size config with
random weights from a fixed seed.  It runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import repro_torch.configs as configs
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.obs import (SLOPolicy, Tracer, overlap_report, reconstruct_timelines,
                             timeline_aggregates)
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
    ap.add_argument("--autotune", action="store_true",
                    help="measurement-driven tuning (repro_torch.tuning): profile the "
                         "device, warm-start from the paper's generic flow, "
                         "coordinate-descend on measured tokens/s, persist the plan to "
                         "the tuning db")
    ap.add_argument("--tuning-db", default=None,
                    help="tuning-db JSON path (default $REPRO_TUNING_DB or "
                         "~/.cache/repro_torch/tuning.json)")
    ap.add_argument("--tune-budget", type=int, default=12,
                    help="max measured candidate runs the tuner may spend")
    ap.add_argument("--retune", action="store_true",
                    help="ignore a cached TunedPlan and search afresh")
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
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record per-tick spans and write a Chrome/Perfetto trace.json here "
                         "after the run; also prints the measured overlap and the "
                         "per-request latencies")
    ap.add_argument("--metrics", action="store_true",
                    help="print engine.metrics_snapshot() as JSON after the run")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write engine.metrics_snapshot() as JSON to this file (the "
                         "snapshot obs.doctor reads beside --trace)")
    ap.add_argument("--slo-ttft-ms", type=float, default=None,
                    help="SLO target: submit -> first token, milliseconds (queue wait "
                         "included)")
    ap.add_argument("--slo-itl-ms", type=float, default=None,
                    help="SLO target: worst per-token inter-token latency, milliseconds")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.prefix_sharing and not args.paged:
        ap.error("--prefix-sharing requires --paged")
    cfg = configs.get_smoke_config(args.arch)
    slo_flags = args.slo_ttft_ms is not None or args.slo_itl_ms is not None
    if (args.trace or args.metrics or args.metrics_out or slo_flags) and (
            args.sequential or cfg.prefix_len):
        ap.error("--trace/--metrics/--metrics-out/--slo-* instrument StreamedBatchEngine; "
                 "this arch/flag combination falls back to the sequential engine")
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
    enc_inputs = prefix = None
    if cfg.is_encoder_decoder:  # whisper: each request's encoded-audio frames
        enc_inputs = 0.1 * np.random.default_rng(2).standard_normal(
            (args.requests, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.prefix_len:  # paligemma: each row's image embeddings
        prefix = 0.1 * np.random.default_rng(3).standard_normal(
            (args.requests, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        max_seq = -(-(cfg.prefix_len + args.prompt_len + args.new_tokens)
                    // args.block_size) * args.block_size
        scfg.max_seq = max_seq
    if args.prefix_sharing:
        # The shared-system-prompt workload: the first page-aligned half of
        # every prompt is one prefix, the tails stay unique.
        sys_len = max(args.block_size,
                      (args.prompt_len // 2) // args.block_size * args.block_size)
        tokens[:, :sys_len] = rng.integers(0, cfg.vocab_size, sys_len, dtype=np.int32)

    if args.sequential or cfg.prefix_len:
        single = ServingEngine(cfg, params, scfg, device=device,
                               unembed=T.unembed_f32(cfg, params))
        t0 = time.perf_counter()
        rows = single.generate(tokens, enc_inputs=enc_inputs,
                               prefix_embeds=prefix).cpu().numpy().tolist()
        dt = time.perf_counter() - t0
        total_new = sum(len(r) for r in rows)
        print(f"[serve] {args.arch} on {device} (sequential-batch, contiguous cache): "
              f"{args.requests} requests x {args.prompt_len} prompt -> "
              f"{total_new // args.requests} new tokens each in {dt:.2f}s "
              f"({total_new / dt:.1f} tok/s incl. prefill)")
        for i, row in enumerate(rows[:3]):
            print(f"[serve] req{i}: {row[:12]}{'...' if len(row) > 12 else ''}")
        return
    slo = (SLOPolicy.from_ms(ttft_ms=args.slo_ttft_ms, itl_ms=args.slo_itl_ms)
           if slo_flags else None)
    plan = autotune(args, cfg, params, scfg, tokens, device) if args.autotune else None
    eng = StreamedBatchEngine(cfg, params, scfg, device=device, plan=plan,
                              tracer=Tracer() if args.trace else None, slo=slo)
    t0 = time.perf_counter()
    uids = [eng.submit(t, enc_inputs=None if enc_inputs is None else enc_inputs[i])
            for i, t in enumerate(tokens)]
    outs = eng.run()
    saved = eng.save_prefixes()
    dt = time.perf_counter() - t0
    rows = [outs[u].tolist() for u in uids]
    total_new = sum(len(r) for r in rows)
    spec = ""
    if args.spec_decode:
        rate = eng.spec_accepted / eng.spec_proposed if eng.spec_proposed else 0.0
        spec = (f", spec k={eng.scfg.spec_k}: {eng.spec_ticks} verify ticks, acceptance "
                f"{rate:.2f} ({eng.spec_accepted}/{eng.spec_proposed})")
    if args.state_snapshots:
        spec += (f", state snapshots: {eng.snapshot_hits} hits, "
                 f"{eng.snapshot_tokens_reused} tokens reused")
    if args.paged:
        st = eng.kv.stats(active_slots=eng.peak_active)
        cache = (f"paged block={eng.kv.block_size} kv_dtype={eng.kv.kv_dtype} (peak "
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
    print(f"[serve] {args.arch} on {device} (continuous-batching x{eng.scfg.max_batch} "
          f"slots, {temp}, {eng.decode_steps} batched decode steps{spec}, {cache}): "
          f"{args.requests} requests x {args.prompt_len} prompt -> "
          f"{total_new // args.requests} new tokens each in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s incl. prefill)")
    for i, row in enumerate(rows[:3]):
        print(f"[serve] req{i}: {row[:12]}{'...' if len(row) > 12 else ''}")
    if args.trace:
        eng.obs.to_chrome(args.trace)
        spans = eng.obs.spans()
        rep = overlap_report(spans, dropped=eng.obs.dropped)
        m = rep["measured"]
        line = (f"[serve] trace: {args.trace} ({len(spans)} spans, {eng.obs.dropped} "
                f"dropped) — overlap {m['efficiency']:.0%} ({m['hidden_s'] * 1e3:.1f}ms of "
                f"{m['total_s'] * 1e3:.1f}ms transfer hidden)")
        if m["partial"]:
            line += " [PARTIAL: ring wrapped, efficiency is truncated]"
        print(line)
        agg = timeline_aggregates(reconstruct_timelines(spans, dropped=eng.obs.dropped,
                                                        warn=False))
        print(f"[serve] requests: {agg['requests']} timelines ({agg['finished']} finished, "
              f"{agg['partial']} partial) — ttft p50 {agg['ttft_p50_s'] * 1e3:.1f}ms, queue "
              f"wait p50 {agg['queue_wait_p50_s'] * 1e3:.1f}ms, itl p50 "
              f"{agg['itl_p50_s'] * 1e3:.2f}ms, {agg['evictions']} evictions")
    if args.metrics or args.metrics_out:
        snap = eng.metrics_snapshot()
        if args.metrics_out:
            with open(args.metrics_out, "w") as f:
                json.dump(snap, f, indent=2, sort_keys=True)
            print(f"[serve] metrics: {args.metrics_out}")
        if args.metrics:
            print(json.dumps(snap, indent=2, sort_keys=True))


def autotune(args, cfg, params, scfg, tokens, device):
    """The ``TunedPlan`` for this workload: the db's, or (none there, or
    ``--retune``) a fresh search, stored in the db."""
    from repro_torch import tuning
    desc = tuning.WorkloadDescriptor.from_prompts(list(tokens),
                                                  max_new_tokens=args.new_tokens)
    db = tuning.TuningDB(args.tuning_db)
    fp = tuning.fingerprint(cfg, desc, scfg, device=device)
    plan = None if args.retune else db.get(fp)
    cached = plan is not None
    if plan is None:
        plan = tuning.search_tuned_plan(
            cfg, params, scfg, desc, device=device,
            budget=tuning.SearchBudget(max_trials=args.tune_budget), log=print)
        db.put(plan)
    st = plan.measured_stage_times
    print(f"[serve] autotune ({'cached' if cached else 'searched'}, "
          f"{plan.decision}/{plan.category}): chunk={plan.prefill_chunk} "
          f"interleave={plan.decode_interleave} block={plan.block_size} "
          f"slots={plan.max_batch} kernel={plan.paged_kernel} "
          f"(chunk {st.h2d * 1e3:.2f}ms, decode {st.kex * 1e3:.2f}ms; "
          f"{plan.tokens_per_s:.1f} tok/s measured vs "
          f"{plan.baseline_tokens_per_s:.1f} analytic; db {db.path})")
    return plan


if __name__ == "__main__":
    main()
