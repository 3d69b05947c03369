"""Streamed (chunked) prefill serving demo: the paper's pipeline at
inference time (reference ``examples/serve_streamed.py``).

Shows: (1) streamed prefill gives the one-shot prefill's logits; (2) peak
activation size drops from O(prompt) to O(chunk); (3) batched decode after
the stream; (4) continuous batching: many queued requests through a shared
slot pool, token-identical to one-at-a-time; then the paged pool, state
snapshots (mamba), prefix sharing, speculative decode, quantized pages and
the measured tuner.

    PYTHONPATH=src python -m repro_torch.examples.serve_streamed \\
        [--arch mamba2-2.7b] [--prompt-len 256 --chunk 32 --new-tokens 16] \\
        [--kv-dtype int8|fp8] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch import tuning
from repro_torch.device import resolve_device
from repro_torch.examples import wall
from repro_torch.kernels import quant
from repro_torch.models import transformer as T
from repro_torch.runtime.model_iface import arch_kind_of
from repro_torch.runtime.serving import ServeConfig, ServingEngine, StreamedBatchEngine


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=C.list_archs())
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--kv-dtype", choices=("int8", "fp8"), default="int8",
                    help="quantized-pool mode the demo's capacity section "
                         "exercises (the other sections stay fp32)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.get_smoke_config(args.arch)
    params = T.init_params(cfg, 0, device=dev)
    b, s = 2, args.prompt_len
    tokens = torch.randint(0, cfg.vocab_size, (b, s), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    kw = {}
    if cfg.is_encoder_decoder:
        kw["enc_inputs"] = 0.1 * torch.randn(
            (b, cfg.encoder_seq, cfg.d_model), generator=torch.Generator().manual_seed(2))
    if cfg.prefix_len:
        kw["prefix_embeds"] = 0.1 * torch.randn(
            (b, cfg.prefix_len, cfg.d_model), generator=torch.Generator().manual_seed(3))

    max_seq = s + cfg.prefix_len + args.new_tokens
    eng = ServingEngine(cfg, params, ServeConfig(
        max_seq=max_seq, prefill_chunk=args.chunk, max_new_tokens=args.new_tokens),
        device=dev, unembed=T.unembed_f32(cfg, params))

    (logits_stream, _, pos), t_stream = wall(dev, lambda: eng.prefill_streamed(tokens, **kw))

    # one-shot reference
    batch = {"tokens": tokens.to(dev), **{k: v.to(dev) for k, v in kw.items()}}
    with torch.inference_mode():
        (logits_one, _), t_one = wall(dev, lambda: T.prefill(
            cfg, params, batch, max_seq=max_seq, unembed=eng.unembed))

    err = float((logits_stream - logits_one).abs().max())
    n_chunks = -(-s // args.chunk)
    print(f"[serve] arch={args.arch} prompt={s} chunk={args.chunk} "
          f"({n_chunks} stream tasks)")
    print(f"[serve] streamed-vs-oneshot max |dlogit| = {err:.2e}")
    print(f"[serve] peak prefill activation: O({args.chunk}) vs O({s}) tokens "
          f"({s // args.chunk}x reduction)")
    print(f"[serve] walltime: streamed {t_stream:.2f}s, one-shot {t_one:.2f}s "
          f"(on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'CPU'})")

    toks = eng.generate(tokens, **kw).cpu()
    print(f"[serve] decoded {toks.shape[1]} tokens/request: {toks.tolist()[0][:8]}...")
    assert err < 1e-3

    # continuous batching: a queue of staggered requests through the shared
    # slot pool matches the one-at-a-time output exactly.  Every servable
    # arch (transformer, mamba/jamba, whisper with per-request enc_inputs)
    # rides the same engine behind the ServableModel interface; only the
    # prefix-LM configs stay on ServingEngine.generate.
    kind = arch_kind_of(cfg)
    enc = kw.get("enc_inputs")
    prompts = tokens.numpy()

    def submit_all(e):
        return [e.submit(prompts[i], enc_inputs=None if enc is None else enc[i].numpy())
                for i in range(b)]

    def same_as(outs, uids, want):
        return all(outs[u].tolist() == want[i].tolist() for i, u in enumerate(uids))

    block = 16
    pseq = -(-max_seq // block) * block
    if kind != "prefix_lm":
        cbe = StreamedBatchEngine(cfg, params, ServeConfig(
            max_seq=max_seq, prefill_chunk=args.chunk,
            max_new_tokens=args.new_tokens, max_batch=2), device=dev)
        uids = submit_all(cbe)
        same = same_as(cbe.run(), uids, toks)
        print(f"[serve] continuous batching ({cbe.decode_steps} batched "
              f"decode steps): token-identical={same}")
        assert same

        # paged KV cache: same outputs, memory per request tracks its actual
        # length (pages allocated lazily from a shared pool) not max_seq.
        pge = StreamedBatchEngine(cfg, params, ServeConfig(
            max_seq=pseq, prefill_chunk=args.chunk,
            max_new_tokens=args.new_tokens, max_batch=2,
            paged=True, block_size=block), device=dev)
        puids = submit_all(pge)
        psame = same_as(pge.run(), puids, toks)
        st = pge.kv.stats()
        print(f"[serve] paged KV ({block}-row pages): token-identical="
              f"{psame}; peak {st.peak_in_use}/{st.capacity} pages "
              f"({st.page_bytes}B/page) vs {pseq // block} pages/slot "
              f"contiguous")
        assert psame

    # state snapshots (pure-SSM mamba): page-granular prefix sharing is
    # impossible (the state at position t summarizes all of [0, t)), so
    # sharing degrades to chunk-aligned state snapshots: admission restores
    # the longest stored proper prefix and streams only the tail.
    if kind == "mamba" and all(u.mixer == "mamba" for u in cfg.layer_unit):
        # longest chunk-aligned proper prefix <= 2 chunks (snapshots only
        # land on the chunk grid, strictly inside the prompt)
        head = min(2 * args.chunk, (s - 1) // args.chunk * args.chunk)
        sh = prompts.copy()
        sh[1, :head] = sh[0, :head]  # two prompts, one shared 2-chunk head
        ref_sh = eng.generate(sh).cpu()
        sse = StreamedBatchEngine(cfg, params, ServeConfig(
            max_seq=max_seq, prefill_chunk=args.chunk,
            max_new_tokens=args.new_tokens, max_batch=2,
            state_snapshots=True), device=dev)
        sn_ids = [sse.submit(sh[i]) for i in range(b)]
        sn_same = same_as(sse.run(), sn_ids, ref_sh)
        print(f"[serve] state snapshots: {sse.snapshot_hits} hits, "
              f"{sse.snapshot_tokens_reused} prompt tokens restored from "
              f"stored SSM state; token-identical={sn_same}")
        assert sn_same and (head == 0 or sse.snapshot_hits >= 1)

    if kind == "transformer":
        # prefix sharing: requests with a common system prompt map the same
        # physical pages (the paper's SYNC transfer staged once) and only
        # prefill their unique tails: same tokens, fewer pages.
        sys_len = max(block, (s // 2) // block * block)
        shared = prompts.copy()
        shared[:, :sys_len] = prompts[0, :sys_len]
        outs_ref = {}
        for cfg_share in (False, True):
            se = StreamedBatchEngine(cfg, params, ServeConfig(
                max_seq=pseq, prefill_chunk=args.chunk,
                max_new_tokens=args.new_tokens, max_batch=2,
                paged=True, block_size=block, prefix_sharing=cfg_share), device=dev)
            sids = [se.submit(shared[i]) for i in range(b)]
            souts = se.run()
            outs_ref[cfg_share] = [souts[u].tolist() for u in sids]
            if cfg_share:
                sst = se.kv.stats()
                print(f"[serve] prefix sharing: {se.prefix_hits} hits, "
                      f"{se.prefix_pages_shared} pages mapped instead of "
                      f"prefilled ({se.prefix_pages_shared * sst.page_bytes}"
                      f"B of copies avoided), peak {se.kv.peak_pages_in_use}"
                      f" pages")
        assert outs_ref[True] == outs_ref[False]
        print("[serve] prefix sharing token-identical=True")

        # speculative multi-token decode: an n-gram/prompt-lookup drafter
        # proposes spec_k tokens per slot, one batched verify step scores
        # all k+1 positions, and slots advance by the accepted prefix: the
        # ITERATIVE (per-token) decode chain restructured into a streamable
        # chunked pipeline.  Greedy tokens stay identical.
        spe = StreamedBatchEngine(cfg, params, ServeConfig(
            max_seq=pseq, prefill_chunk=args.chunk,
            max_new_tokens=args.new_tokens, max_batch=2,
            paged=True, block_size=block, spec_decode=True, spec_k=4), device=dev)
        vids = [spe.submit(prompts[i]) for i in range(b)]
        vsame = same_as(spe.run(), vids, toks)
        vrate = spe.spec_accepted / max(1, spe.spec_proposed)
        print(f"[serve] speculative decode (k=4): {spe.spec_ticks} verify "
              f"steps for {b * args.new_tokens} tokens, "
              f"{spe.spec_accepted}/{spe.spec_proposed} drafts accepted "
              f"({vrate:.0%}); token-identical={vsame}")
        assert vsame

        # quantized KV pages: the pool stores int8/fp8 codes plus per-page
        # per-kv-head scales, so the same pool bytes hold ~4x the pages
        # (~4x the concurrent requests).  Dequantization is fused into the
        # attention reads; greedy outputs may diverge within a documented
        # tolerance (unlike every fp32 mode above, which is bitwise).
        qe = StreamedBatchEngine(cfg, params, ServeConfig(
            max_seq=pseq, prefill_chunk=args.chunk,
            max_new_tokens=args.new_tokens, max_batch=2,
            paged=True, block_size=block, kv_dtype=args.kv_dtype), device=dev)
        qids = [qe.submit(prompts[i]) for i in range(b)]
        qouts = qe.run()
        agree = float(np.mean([np.mean(qouts[u] == toks[i].numpy())
                               for i, u in enumerate(qids)]))
        fp32_pb = quant.page_bytes_est(block, cfg.n_kv_heads, cfg.head_dim, "fp32")
        quant_pb = quant.page_bytes_est(block, cfg.n_kv_heads, cfg.head_dim, args.kv_dtype)
        print(f"[serve] quantized KV pages ({args.kv_dtype}): "
              f"{quant_pb}B/page vs {fp32_pb}B fp32 "
              f"({fp32_pb / quant_pb:.1f}x pages per pool byte); "
              f"greedy agreement vs fp32 = {agree:.2f}")
        assert agree >= 0.5  # the documented divergence tolerance

        # measurement-driven autotuning: profile the live backend, search
        # around the analytic plan, and build an engine from the TunedPlan:
        # same tokens, measured (not guessed) knobs.
        desc = tuning.WorkloadDescriptor.from_prompts(
            [prompts[i] for i in range(b)], max_new_tokens=args.new_tokens)
        base = ServeConfig(
            max_seq=pseq, prefill_chunk=args.chunk,
            max_new_tokens=args.new_tokens, max_batch=2,
            paged=True, block_size=block)
        plan = tuning.search_tuned_plan(
            cfg, params, base, desc, device=dev,
            budget=tuning.SearchBudget(max_trials=4, sweeps=1))
        te = StreamedBatchEngine(cfg, params, base, plan=plan, device=dev)
        tids = [te.submit(prompts[i]) for i in range(b)]
        tsame = same_as(te.run(), tids, toks)
        print(f"[serve] autotuned (chunk={plan.prefill_chunk} "
              f"block={plan.block_size} slots={plan.max_batch}): "
              f"{plan.tokens_per_s:.1f} tok/s measured vs "
              f"{plan.baseline_tokens_per_s:.1f} analytic; "
              f"token-identical={tsame}")
        assert tsame
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
