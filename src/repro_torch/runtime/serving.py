"""Continuous-batching engine with chunked prefill (reference
``runtime/serving.py``): transformer serving over a contiguous slot cache
or a paged pool (fused prefill, or scatter-after-prefill), mamba and
hybrid (jamba) serving over a contiguous slot cache or beside a paged
pool, and whisper serving, each request with its own encoder input
(``submit(..., enc_inputs=)``).  ``ServingEngine`` holds the b=1 streamed
prefill of one admission and ``generate``, the one-batch-at-a-time oracle,
which also serves paligemma's image prefix (``prefix_embeds=``).

* **Slots**: ``max_batch`` decode slots share the cache; each carries its
  own position ``cur``, so rope, the cache write and the attention cut are
  per row.  Free slots ride along as padding rows: their table rows point
  at the trash page, and their rows of the contiguous cache or slot state
  fill with garbage that the next admission's scatter overwrites whole.
* **Admission**: a request's prompt streams in ``prefill_chunk`` pieces;
  after each chunk is enqueued, ``decode_interleave`` batched decode ticks
  run for the active slots.  Paged: its pages are reserved through its
  first decode write and its table row is shielded until the prompt is in.
  With ``prefix_sharing`` the longest registered chunk-aligned prefix of
  the prompt is mapped into its table at refcount + 1 (the paper's SYNC
  transfer, staged once) and only the uncovered tail is prefilled, on the
  chunk grid a full prefill runs; its own page-aligned prefixes are then
  registered for later admissions (``kv_cache.PrefixRegistry``).
  Fused (paged transformers by default): each chunk's K/V are written
  straight into its pages (the host row carries the real pages for the
  chunks).  Otherwise the chunks run over a b=1 contiguous cache (mamba:
  optionally resumed from a restored state snapshot), which is scattered
  into the slot when the prompt is in (``kv.scatter`` into pages, or the
  slot's rows of the contiguous cache).
* **Decode tick**: fault in each active slot's write page (a shared page
  forks copy-on-write first), one batched step with its pick on the
  device, and exactly one device-to-host copy — the ``(B,)`` int32 picks.
  At ``temperature`` > 0 each row draws from its request's own stream at
  its token count (``runtime.sampling``), so a request's tokens do not
  depend on its slot, its neighbours, the cache layout or preemption.
* **Speculative tick** (``spec_decode``): a drafter proposes up to
  ``spec_k`` tokens per slot, one multi-token verify step scores the
  pending token plus the draft, and each slot advances by its accepted
  prefix plus the bonus token; one device-to-host copy of ``(emit,
  n_accept)``.  Draft pages are faulted best-effort and rolled back
  (``kv.truncate``) past the accepted prefix.  Greedy output equals the
  plain ticks' by construction; at temperature the verify step
  rejection-samples, so each token is still a sample of the target.
* **Quantized pages** (``kv_dtype`` "int8" / "fp8"): the pool stores codes
  and per-(page, kv head) scales; see ``kernels/quant``.
* **Backpressure and preemption** (paged): a request waits in the queue
  (FIFO) until the free list holds its pages.  When a tick cannot fault
  in a slot's write page, the youngest other slot is evicted (its pages
  gathered into a b=1 cache, then freed) and waits to be readmitted
  (scattered back, a registered prefix of its prompt re-mapped instead)
  before any new admission; with no other victim the faulting slot evicts
  itself.  Retained prefix pages are reclaimed (least recently used first)
  before a request waits.  ``submit`` rejects a request that could not
  finish alone in the pool, so every request finishes.
* **Telemetry** (``repro_torch.obs``): the counters live in a
  ``MetricsRegistry`` (the attribute names stay, assignable), beside the
  latency histograms (queue wait, TTFT, per-token ITL) and the transfer
  counters; with a ``Tracer`` the engine records the reference's spans
  (``admit``, ``prefill_chunk``, ``decode_tick`` with its per-slot
  ``uids`` / ``toks``, ``evict``, ``readmit``, ...) and checks each tick's
  fetched bytes against the step's ``@transfer_budget`` (live STR002);
  with an ``SLOPolicy`` every finished request is scored at reap.  Spans
  are host clock reads with no synchronisation: a tick's span ends at its
  one device-to-host copy, a prefill chunk's at the end of the ticks
  interleaved behind it (its launches are asynchronous).
* **Policy** (the paper's generic flow applied to serving):
  ``measure_stage_times`` times a prefill chunk (the ingest stage, h2d)
  and a batched decode tick (the compute stage, kex) without touching live
  state; ``plan_decode_policy`` turns them into R, the stream decision, the
  chunk size, the decode interleave and the page size; ``autotune`` applies
  the plan, rebuilding the pool and every graph over it when the page size
  changes and the pool is idle.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.analysis.budget import budget_of, host_fetch, tick_path, transfer_budget
from repro_torch.configs.base import ModelConfig
from repro_torch.core import rmetric
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.models import transformer as T
from repro_torch.obs import MetricsRegistry, Tracer
from repro_torch.runtime import spec
from repro_torch.runtime.graphs import _CHUNK_JIT_CAP, Graphs, StepGraph, lru_get
from repro_torch.runtime.kv_cache import (PAGED_LEAVES, TRASH_PAGE, gather_slot_state,
                                          scatter_slot_state, zero_cache)

@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    prefill_chunk: int = 256  # task size for streamed prefill
    max_new_tokens: int = 32
    temperature: float = 0.0  # 0 = greedy
    max_batch: int = 4  # decode slots
    decode_interleave: int = 1  # decode ticks per in-flight prefill chunk
    block_size: int = 16  # cache rows per page
    num_blocks: int | None = None  # pool size; None = every slot at max_seq + trash
    kv_dtype: str = "fp32"  # pool storage: "fp32" | "int8" | "fp8"
    prefix_sharing: bool = False  # map common prompt prefixes copy-on-write
    prefix_min_pages: int = 1  # shortest prefix worth sharing, in pages
    # speculative decode: a drafter proposes spec_k tokens, one batched
    # verify step scores all k + 1 positions
    spec_decode: bool = False
    spec_k: int = 4  # draft tokens proposed per verify step
    spec_ngram: int = 3  # longest n-gram the default prompt-lookup matches
    # Page the batched cache (kv_cache.PagedKVCache); else one contiguous
    # cache of max_seq rows per slot (the reference's default).
    paged: bool = False
    # Write prefill K/V straight into pool pages; None = on for paged
    # transformers, off elsewhere (resolved by validate_arch).
    fused_prefill: bool | None = None
    # mamba: reuse chunk-aligned SSM-state snapshots across admissions.
    state_snapshots: bool = False
    # Stamped by build_servable from the model ("transformer" | "mamba" |
    # "whisper"); setting it up front validates arch-dependent flags early.
    arch_kind: str | None = None
    # Path: persist the prefix registry across engines (restored at
    # construction, saved by engine.save_prefixes; a stale store is ignored).
    prefix_store: str | None = None
    # Step-graph cache caps (runtime.graphs); None = the module defaults.
    chunk_jit_cap: int | None = None  # per-(len, first, pos0) prefill chunk graphs
    page_jit_cap: int | None = None  # per-n_pages scatter / gather / load graphs

    def __post_init__(self) -> None:
        for name in ("max_seq", "prefill_chunk", "max_new_tokens", "max_batch",
                     "decode_interleave", "block_size", "prefix_min_pages", "spec_k",
                     "spec_ngram"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        for cap in ("chunk_jit_cap", "page_jit_cap"):
            if getattr(self, cap) is not None and getattr(self, cap) < 1:
                raise ValueError(
                    f"{cap} must be >= 1 when set, got {getattr(self, cap)}")
        quant.validate_kv_dtype(self.kv_dtype)
        if quant.is_quantized(self.kv_dtype) and not self.paged:
            raise ValueError(
                "kv_dtype quantizes the paged KV pool; it requires paged=True (the "
                "contiguous cache stays full precision)")
        if self.fused_prefill and not self.paged:
            raise ValueError(
                "fused_prefill writes prefill K/V through the page table; it requires "
                "paged=True")
        if self.prefix_sharing and not self.paged:
            raise ValueError(
                "prefix_sharing shares physical KV pages; it requires paged=True")
        if self.paged:
            if self.max_seq % self.block_size:
                raise ValueError(
                    f"max_seq {self.max_seq} must be a multiple of block_size "
                    f"{self.block_size} (pages tile the cache)")
            if self.num_blocks is not None and self.num_blocks < 2:
                raise ValueError(
                    f"num_blocks must be >= 2 (block 0 is the trash page), got "
                    f"{self.num_blocks}")
        if self.prefix_store is not None and not self.prefix_sharing:
            raise ValueError(
                "prefix_store persists the prefix registry; it requires "
                "prefix_sharing=True")
        self.validate_arch()

    def validate_arch(self) -> None:
        """Arch-dependent flag validation (the reference's rules and
        messages, plus the port's): a no-op until ``arch_kind`` is stamped,
        which ``build_servable`` does with the model in hand."""
        kind = self.arch_kind
        if kind is None:
            return
        if kind not in ("transformer", "mamba", "whisper"):
            raise ValueError(
                f"unknown arch_kind {kind!r}; expected transformer | mamba | whisper")
        if kind == "mamba":
            if self.prefix_sharing:
                raise NotImplementedError(
                    "prefix sharing maps attention KV pages; mamba/hybrid archs carry "
                    "per-slot SSM state with no page-granular snapshot — "
                    "state_snapshots=True gives the chunk-aligned state-reuse "
                    "degradation instead")
            if self.spec_decode:
                raise NotImplementedError(
                    "speculative decode rolls rejected positions back by masking KV "
                    "writes; mamba/hybrid archs advance irreversible per-slot SSM state")
        if kind == "whisper":
            if self.prefix_sharing:
                raise NotImplementedError(
                    "prefix sharing keys pages by prompt tokens alone, but whisper's "
                    "self-attention KV depends on each request's encoder output — "
                    "identical text prefixes are not shareable across requests")
            if self.spec_decode:
                raise NotImplementedError(
                    "speculative decode needs the multi-token verify step, which has no "
                    "cross-attention path; serve encoder-decoder configs with "
                    "spec_decode=False")
        if kind != "transformer":
            if quant.is_quantized(self.kv_dtype):
                raise NotImplementedError(
                    "quantized KV pages cover attention K/V pool blocks; "
                    f"arch_kind={kind!r} carries cache state (SSM rows / cross-attention "
                    "slabs) with no per-page scale — serve it with kv_dtype='fp32'")
            if self.fused_prefill:
                raise NotImplementedError(
                    "fused_prefill routes prefill K/V through the decoder page table; "
                    f"arch_kind={kind!r} prefills through arch-specific caches — leave "
                    "fused_prefill unset")
        if self.fused_prefill is None:
            # The fused path exists only for the transformer prefill chain
            # over a paged pool.
            self.fused_prefill = bool(self.paged) and kind == "transformer"
        if self.state_snapshots and kind != "mamba":
            raise ValueError(
                "state_snapshots reuse recurrent SSM state across admissions; "
                f"arch_kind={kind!r} carries none (mamba only)")


class ServingEngine:
    """The b=1 streamed prefill of one admission (the reference's
    ``ServingEngine.iter_prefill_chunks``) and the batched engine's prefill
    chunk graphs, in the LRU cache ``_chunk_jit`` capped by
    ``_chunk_jit_cap`` as the reference's: b=1 streamed chunks keyed
    ``(chunk_len, first, pos0)`` over the engine-owned request cache (a
    whisper first chunk takes the encoder output as an input, not as part
    of its key), fused chunks keyed ``("fused", chunk_len, pos0)`` over the
    page pool.  Also ``generate``, the one-batch-at-a-time decode, which
    stays eager, as does whisper's encode of each admission."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg, *, device, unembed,
                 graphs: Graphs | None = None):
        self.cfg, self.params, self.scfg, self.device = cfg, params, scfg, device
        self.unembed = unembed
        self.graphs = graphs if graphs is not None else Graphs(device)
        self._chunk_jit: collections.OrderedDict = collections.OrderedDict()
        self._chunk_jit_cap = scfg.chunk_jit_cap or _CHUNK_JIT_CAP
        self._request_cache: dict | None = None

    def request_cache(self) -> dict:
        """The b=1 full-length contiguous cache every admission's streamed
        prefill runs over (admissions are serial), made at first use and
        never replaced: the chunk graphs and the pool's page moves hold its
        addresses.  The admission zeroes it (:func:`zero_cache`)."""
        if self._request_cache is None:
            # The streamed prefill needs full-length caches (no SWA ring).
            self._request_cache = T.init_cache(self.cfg, 1, self.scfg.max_seq, ring=False,
                                               device=self.device)
        return self._request_cache

    @transfer_budget(d2h_arrays=0, d2h_outputs=())
    def _prefill_chunk_fn(self, chunk_len: int, first: bool, pos0: int) -> StepGraph:
        """The graph of one b=1 prompt chunk over the request cache; static
        input ``tokens`` (1, chunk_len) and, for a whisper first chunk,
        ``enc_out`` (1, encoder_seq, D), whose cross K/V it stores; output
        the last logits (1, 1, V)."""
        def make():
            cfg, params, unembed = self.cfg, self.params, self.unembed
            caches = self.request_cache()
            inputs = {"tokens": ((1, chunk_len), torch.int32)}
            if first and cfg.is_encoder_decoder:
                inputs["enc_out"] = ((1, cfg.encoder_seq, cfg.d_model), cfg.compute_dtype)

            @torch.inference_mode()
            def fn(tokens, enc_out=None):
                return T.prefill_chunk(cfg, params, tokens, caches, pos0, unembed=unembed,
                                       enc_out=enc_out)[0]
            return StepGraph(self.graphs, fn, inputs)
        return lru_get(self._chunk_jit, (chunk_len, first, pos0), make,
                       cap=self._chunk_jit_cap)

    @transfer_budget(d2h_arrays=0, d2h_outputs=())
    def _fused_chunk_fn(self, chunk_len: int, pos0: int, pools: dict) -> StepGraph:
        """The graph of one prompt chunk written straight into ``pools``
        (the engine's, always the same); static inputs ``tokens`` (1,
        chunk_len) and ``page_table`` (1, pages covering the context so
        far), output the last logits (1, 1, V)."""
        def make():
            cfg, params, unembed = self.cfg, self.params, self.unembed
            n_pages = -(-(pos0 + chunk_len) // self.scfg.block_size)

            @torch.inference_mode()
            def fn(tokens, page_table):
                return T.prefill_chunk_paged(cfg, params, tokens, pools, page_table, pos0,
                                             unembed=unembed)[0]
            return StepGraph(self.graphs, fn, {"tokens": ((1, chunk_len), torch.int32),
                                               "page_table": ((1, n_pages), torch.int32)})
        return lru_get(self._chunk_jit, ("fused", chunk_len, pos0), make,
                       cap=self._chunk_jit_cap)

    def _device_f32(self, x) -> torch.Tensor:
        """``x`` as f32 on the engine's device.  Host data goes to a card
        through pinned memory without a host wait (an admission's encoder
        input is staged once, on the stream, not by a blocking copy)."""
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))
        if x.device.type == "cpu" and torch.device(self.device).type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        return x.to(device=self.device, dtype=torch.float32)

    def encode(self, enc_inputs) -> torch.Tensor:
        """Whisper's encoder over ``enc_inputs`` (B, encoder_seq, D), eager:
        (B, encoder_seq, D) in ``compute_dtype`` on the engine's device."""
        with torch.inference_mode():
            return T.encode(self.cfg, self.params, self._device_f32(enc_inputs))

    def iter_prefill_chunks(self, tokens, *, caches=None, pos0: int = 0, enc_inputs=None,
                            prefix_embeds=None) -> Iterator[tuple[torch.Tensor, dict, int]]:
        """Yield (logits-so-far (1, 1, V), caches, position after the chunk)
        per prompt chunk.  ``caches`` None: an eager prefill of ``tokens``
        (B, S) over a fresh cache (``generate``).  Else ``caches`` is
        :meth:`request_cache`, holding the first ``pos0`` tokens (zeros, a
        restored snapshot or a loaded prefix), and each chunk of ``tokens``
        (1, S) runs its graph; its logits are good until the engine's next
        replay.  The chunk grid is anchored at position 0 (the chunk size is
        picked from the *full* length ``pos0 + s``), so a continued prefill
        dispatches the chunks a full prefill would.

        A whisper prompt needs ``enc_inputs`` (B, encoder_seq, D): they are
        encoded first and the first chunk stores their cross K/V.  A
        paligemma prompt needs ``prefix_embeds`` (B, prefix_len, D), eager
        only: they ride the first chunk, before its tokens, which then
        advances the position by ``prefix_len`` more (as the reference)."""
        cfg, params, unembed = self.cfg, self.params, self.unembed
        b, s = tokens.shape
        if cfg.is_encoder_decoder and enc_inputs is None and pos0 == 0:
            raise ValueError(f"{cfg.name}: the prefill needs enc_inputs (B, encoder_seq, D)")
        if (prefix_embeds is None) != (cfg.prefix_len == 0):
            raise ValueError(f"{cfg.name}: prefix_embeds (B, prefix_len={cfg.prefix_len}, D) "
                             "go with a prefix-LM config, and only with one")
        enc_out = self.encode(enc_inputs) if enc_inputs is not None else None
        prefix = None
        graphed = caches is not None
        if graphed:
            assert caches is self.request_cache(), "chunk graphs run over the request cache"
            assert prefix_embeds is None, "the image prefix is served by generate only"
            tokens = tokens.cpu().numpy() if isinstance(tokens, torch.Tensor) else tokens
        else:
            assert pos0 == 0, "a continued prefill needs its context cache"
            caches = T.init_cache(cfg, b, self.scfg.max_seq, ring=False,
                                  device=self.device)
            if prefix_embeds is not None:
                prefix = self._device_f32(prefix_embeds)
                if tuple(prefix.shape) != (b, cfg.prefix_len, cfg.d_model):
                    raise ValueError(f"prefix_embeds {tuple(prefix.shape)} != "
                                     f"{(b, cfg.prefix_len, cfg.d_model)}")
        chunk = min(self.scfg.prefill_chunk, pos0 + s)
        pos = pos0
        for lo in range(0, s, chunk):
            piece = tokens[:, lo: lo + chunk]
            n = piece.shape[1]
            first = lo == 0 and pos0 == 0
            if graphed:
                extra = {"enc_out": enc_out} if first and enc_out is not None else {}
                logits = self._prefill_chunk_fn(n, first, pos)(tokens=piece, **extra)
            else:
                with torch.inference_mode():
                    logits, caches = T.prefill_chunk(
                        cfg, params, piece, caches, pos, unembed=unembed,
                        enc_out=enc_out if first else None, prefix=prefix if first else None)
            pos += n + (cfg.prefix_len if first and prefix is not None else 0)
            yield logits, caches, pos

    def generate(self, tokens, *, enc_inputs=None, prefix_embeds=None) -> torch.Tensor:
        """Decode ``max_new_tokens`` after a streamed prefill of ``tokens``
        (B, S) (reference ``ServingEngine.generate``): every row at one
        position, one decode step a token over the contiguous cache, the
        pick on the device.  ``enc_inputs`` (whisper) and ``prefix_embeds``
        (paligemma) as in :meth:`iter_prefill_chunks`.  At temperature row b
        draws its token i from stream (uid b, step i) of
        ``runtime.sampling``, where the reference splits one key for the
        whole batch per token.  Returns (B, max_new_tokens) int32 on the
        engine's device."""
        tokens = torch.as_tensor(np.asarray(tokens, np.int32)).to(self.device)
        logits = caches = None
        pos = 0
        for logits, caches, pos in self.iter_prefill_chunks(
                tokens, enc_inputs=enc_inputs, prefix_embeds=prefix_embeds):
            pass
        b = tokens.shape[0]
        rows = torch.arange(b, dtype=torch.int32, device=self.device)
        temp = self.scfg.temperature

        def steps(i):
            return torch.full((b,), i, dtype=torch.int32, device=self.device)
        nxt = T.sample_tokens(logits[:, -1], temperature=temp, uids=rows, steps=steps(0))
        out = [nxt]
        with torch.inference_mode():
            for i in range(self.scfg.max_new_tokens - 1):
                cur = torch.full((b,), pos + i, dtype=torch.int32, device=self.device)
                nxt, caches = T.decode_and_sample(
                    self.cfg, self.params, nxt[:, None], caches, cur, unembed=self.unembed,
                    temperature=temp, uids=rows, steps=steps(i + 1))
                out.append(nxt)
        return torch.stack(out, dim=1)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int
    # whisper: this request's frames (1, encoder_seq, d_model) f32, encoded
    # at admission (its cross K/V then travel with the slot's state)
    enc_inputs: np.ndarray | None = None
    t_submit: float = 0.0  # perf_counter at submit: queue wait and TTFT start here


@dataclasses.dataclass
class _Slot:
    """Decode-batch slot bookkeeping (positions live here, not in the pool)."""

    index: int
    uid: int | None = None  # None = free
    prompt: np.ndarray | None = None  # prompt tokens: the drafter's lookup corpus
    cur: int = 0  # absolute position of the next KV write
    pending: int = 0  # last sampled token (next decode input)
    emitted: list[int] = dataclasses.field(default_factory=list)
    max_new: int = 0
    seq: int = 0  # admission order (the youngest is preempted first)
    # Latency bookkeeping (host floats; scored at reap by the SLO policy,
    # carried unchanged through evict and readmit):
    ttft_s: float = 0.0  # submit -> first token (queue wait + admission)
    t_last: float = 0.0  # perf_counter of the request's last emitted token
    itl_max: float = 0.0  # worst per-token inter-token latency so far (a
    # stall between evict and readmit lands here)
    evictions: int = 0  # times this request was evicted mid-decode

    @property
    def free(self) -> bool:
        return self.uid is None

    @property
    def done(self) -> bool:
        return self.uid is not None and len(self.emitted) >= self.max_new


@dataclasses.dataclass
class EvictedRequest:
    """A request pulled out of its slot: its cache rows and positions,
    ready to readmit into any free slot.  ``caches`` carries the slot's
    per-slot state whole (mamba's SSM state and conv tail, whisper's
    cross-attention K/V), so a readmission needs no encode.  The latency
    fields ride along, so the SLO score at reap sees the whole request,
    its stall included."""

    uid: int
    caches: dict  # b=1 cache: max_seq rows (contiguous), or the gathered pages
    cur: int
    pending: int
    emitted: list[int]
    max_new: int
    n_pages: int = 0  # pages gathered (0 = contiguous eviction)
    seq: int = 0  # original admission order, restored on readmit
    prompt: np.ndarray | None = None  # the drafter's corpus
    ttft_s: float = 0.0
    t_last: float = 0.0
    itl_max: float = 0.0
    evictions: int = 0


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """Chunk / interleave / page-size policy from the paper's generic flow."""

    decision: str  # rmetric.StreamDecision value
    prefill_chunk: int
    decode_interleave: int
    stage_times: rmetric.StageTimes
    block_size: int = 16  # rows per KV page

    def __post_init__(self) -> None:
        # A plan is a contract: ServeConfig and PagedKVCache would reject
        # these, so none is ever emitted.
        for field in ("prefill_chunk", "decode_interleave", "block_size"):
            if getattr(self, field) < 1:
                raise ValueError(
                    f"invalid plan: {field} must be >= 1, got {getattr(self, field)}")


def plan_block_size(stage_times: rmetric.StageTimes, *, prefill_chunk: int,
                    max_seq: int | None = None, min_block: int = 8,
                    max_block: int = 128) -> int:
    """The KV page size from the stage times that size the chunks (the
    reference's rule): a page is the Independent transfer task of the paged
    cache, so one prefill chunk's K/V splits into ``optimal_streams``
    page-tasks; when streaming is not worthwhile (R below the gate) pages go
    as coarse as allowed.  The largest power of two at or below the target,
    clipped to [min_block, max_block], halved until it divides ``max_seq``
    (else the largest divisor of ``max_seq`` below it: pages must tile the
    cache)."""
    decision = rmetric.streaming_decision(stage_times)
    if decision is rmetric.StreamDecision.NOT_WORTHWHILE:
        n_tasks = 1
    else:
        n_tasks = rmetric.optimal_streams(stage_times, max_streams=8)
    target = max(min_block, prefill_chunk // max(1, n_tasks))
    block = 1 << (int(target).bit_length() - 1)  # largest power of two <= target
    block = int(np.clip(block, min_block, max_block))
    if max_seq is not None:
        while block > min_block and max_seq % block != 0:
            block //= 2
        if max_seq % block != 0:
            block = next(d for d in range(block, 0, -1) if max_seq % d == 0)
    return block


def plan_decode_policy(stage_times: rmetric.StageTimes, *, prompt_len: int,
                       max_interleave: int = 8, min_chunk: int = 16,
                       max_seq: int | None = None) -> ServingPlan:
    """(prefill_chunk, decode_interleave, block_size) from measured stage
    times, h2d = one prefill chunk (the ingest stage), kex = one batched
    decode tick (the compute stage), as the reference plans them.  The R
    gate decides whether interleaving is worthwhile: below it the prompt
    is one chunk and one tick runs behind it; in the band
    ``optimal_streams`` gives the number of chunks; above it (a chunk
    dwarfs a tick) chunks are as fine as ``min_chunk`` allows.  The
    interleave equalizes the stages (chunk time over tick time, clipped to
    [1, max_interleave]); the page size follows (``plan_block_size``)."""
    decision = rmetric.streaming_decision(stage_times)
    if decision is rmetric.StreamDecision.NOT_WORTHWHILE:
        chunk = max(min_chunk, prompt_len)
        return ServingPlan(decision.value, chunk, 1, stage_times,
                           plan_block_size(stage_times, prefill_chunk=chunk, max_seq=max_seq))
    if decision is rmetric.StreamDecision.STREAM:
        n_chunks = max(1, min(rmetric.optimal_streams(stage_times, max_streams=16),
                              prompt_len // min_chunk))
    else:
        n_chunks = max(1, prompt_len // min_chunk)
    chunk = max(min_chunk, -(-prompt_len // n_chunks))
    ratio = stage_times.h2d / max(stage_times.kex, 1e-9)
    interleave = int(np.clip(round(ratio), 1, max_interleave))
    return ServingPlan(decision.value, chunk, interleave, stage_times,
                       plan_block_size(stage_times, prefill_chunk=chunk, max_seq=max_seq))


class _MetricAttr:
    """A counter attribute of the engine kept in its metrics registry under
    ``metric``: reads come from ``engine.metrics``, writes (callers reset
    the counters to 0 between runs) go back into it, with the type the
    caller stored."""

    def __init__(self, metric: str):
        self.metric = metric

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        return obj.metrics.value(self.metric)

    def __set__(self, obj, value):
        obj.metrics.set_value(self.metric, value)


class StreamedBatchEngine:
    """Continuous-batching serving on ``device`` (CUDA unless the caller
    passes ``"cpu"``).  Greedy output per request equals the reference
    engine's, with or without prefix sharing.  With ``spec_decode``,
    ``drafter`` (anything with ``propose(context, k)``) replaces the
    default ``NGramDrafter``.  ``plan`` (anything with ``apply(scfg) ->
    scfg``, as the reference's tuned plans) rewrites the serving knobs
    before anything is built.  ``tracer`` records spans (a disabled
    ``Tracer`` by default: each hook is one attribute check), ``metrics``
    holds the counters (a fresh ``MetricsRegistry`` by default) and ``slo``
    (an ``obs.SLOPolicy``) scores each finished request."""

    # The counters, kept in the metrics registry under the reference's
    # names; the attributes stay readable and assignable.
    decode_steps = _MetricAttr("serving.decode_steps")
    peak_active = _MetricAttr("serving.peak_active")
    preemptions = _MetricAttr("serving.preemptions")
    admissions = _MetricAttr("serving.admissions")
    admit_seconds = _MetricAttr("serving.admit_seconds")
    prefix_hits = _MetricAttr("serving.prefix_hits")
    prefix_pages_shared = _MetricAttr("serving.prefix_pages_shared")
    snapshot_hits = _MetricAttr("serving.snapshot_hits")
    snapshot_tokens_reused = _MetricAttr("serving.snapshot_tokens_reused")
    readmit_prefix_hits = _MetricAttr("serving.readmit_prefix_hits")
    readmit_prefix_pages = _MetricAttr("serving.readmit_prefix_pages")
    spec_ticks = _MetricAttr("serving.spec_ticks")
    spec_proposed = _MetricAttr("serving.spec_proposed")
    spec_accepted = _MetricAttr("serving.spec_accepted")

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig, *,
                 device=None, plan: Any = None, drafter: spec.Drafter | None = None,
                 tracer: Tracer | None = None, metrics: MetricsRegistry | None = None,
                 slo: Any = None):
        if plan is not None:
            scfg = plan.apply(scfg)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        # Set before the counters below: the _MetricAttr descriptors route
        # through the registry.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.obs = tracer if tracer is not None else Tracer(enabled=False)
        self.slo = slo  # None: no SLO scoring at reap
        self._tick_index = 0  # the decode spans' tick= ordinal
        self._budget_flagged = False  # live STR002 warns once per engine
        # Imported here: model_iface imports this module eagerly.
        from repro_torch.runtime.model_iface import build_servable
        # The engine's step graphs (CUDA graphs on a card, eager on the CPU)
        # and their one memory pool, freed with the engine.
        self.graphs = Graphs(self.device)
        self.servable = build_servable(cfg, params, scfg, device=self.device,
                                       graphs=self.graphs)
        self.paged = scfg.paged
        self.prefixes_restored = 0  # registry entries restored from scfg.prefix_store
        if self.paged:
            self.kv = self.servable.make_kv_pool()
            self.caches = None  # the state lives in self.kv.pools
            if scfg.prefix_sharing and scfg.prefix_store:
                self.prefixes_restored = self.kv.load_prefixes(scfg.prefix_store)
        else:
            self.kv = None
            self.caches = self.servable.init_slot_caches(scfg.max_batch)
        self.slots = [_Slot(index=i) for i in range(scfg.max_batch)]
        self.queue: collections.deque[Request] = collections.deque()
        # page-pressure victims waiting to be readmitted (before new admissions)
        self._preempted: collections.deque[EvictedRequest] = collections.deque()
        self.outputs: dict[int, np.ndarray] = {}
        self._next_uid = 0
        self._admit_seq = 0
        self._evicted_out = 0  # evicted requests not yet readmitted (pin the page size)
        self.decode_steps = 0  # batched decode ticks run (plain and verify)
        self.prefill_chunks = 0  # prompt chunks run (the port's own counter)
        self.admissions = 0
        self.admit_seconds = 0.0  # queue pop -> first token, summed over admissions
        self.preemptions = 0  # evictions for page pressure
        self.peak_active = 0  # most requests resident at once
        self.prefix_hits = 0  # admissions that mapped a shared prefix
        self.prefix_pages_shared = 0  # pages mapped instead of prefilled
        self.readmit_prefix_hits = 0  # readmissions that re-mapped their prefix
        self.readmit_prefix_pages = 0  # pages re-mapped instead of scattered
        self.snapshot_hits = 0  # admissions that restored an SSM-state snapshot
        self.snapshot_tokens_reused = 0  # prompt tokens never re-prefilled
        self.spec_ticks = 0  # verify steps run
        self.spec_proposed = 0  # draft tokens scored by verify steps
        self.spec_accepted = 0  # draft tokens accepted (rate = accepted / proposed)
        self.last_stage_times: rmetric.StageTimes | None = None  # the newest probe's
        self.last_plan: ServingPlan | None = None  # the newest autotune's
        # The admission gate's prefix match (uid, n_pages, blocks, probed),
        # handed to _admit: nothing runs between the gate and the admission.
        self._gate_match: tuple[int, int, list[int], bool] | None = None
        self.drafter = None
        if scfg.spec_decode:
            self.drafter = (drafter if drafter is not None
                            else spec.NGramDrafter(max_n=scfg.spec_ngram))
        self._build_ticks()
        # The declared budgets of the steps in use: each traced tick's
        # fetched bytes are checked against them (live STR002).
        self._decode_budget = budget_of(self.servable.decode_fn)
        self._verify_budget = (budget_of(self.servable.verify_fn) if scfg.spec_decode
                               else None)

    def _build_ticks(self) -> None:
        """The decode (and verify) tick graphs over the current pool or slot
        cache; rebuilt whenever the pool is."""
        self._decode = self._tick_graph(self.servable.decode_fn(paged=self.paged), t=1)
        self._verify = None
        if self.scfg.spec_decode:
            self._verify = self._tick_graph(self.servable.verify_fn(paged=self.paged),
                                            t=self.scfg.spec_k + 1, verify=True)

    def _tick_graph(self, step, *, t: int, verify: bool = False) -> StepGraph:
        """The graph of a batched tick: ``step`` is the servable's decode or
        verify function over the engine's pools or slot cache.  Static
        inputs (B = max_batch): ``toks`` (B, t), the full-width
        ``page_table`` (paged), ``cur`` (B,), ``d_len`` (B,) (verify) and,
        at temperature, ``uids`` and ``steps`` (B,).  Output: the (B,)
        picks, or (B, t + 1) ``emit`` beside ``n_accept`` (verify), for the
        tick's one device-to-host copy."""
        b, i32 = self.scfg.max_batch, torch.int32
        paged = self.paged
        state = self.kv.pools if paged else self.caches
        inputs = {"toks": ((b, t), i32), "cur": ((b,), i32)}
        if paged:
            inputs["page_table"] = ((b, self.kv.max_pages), i32)
        if verify:
            inputs["d_len"] = ((b,), i32)
        if self.scfg.temperature > 0.0:
            inputs["uids"], inputs["steps"] = ((b,), i32), ((b,), i32)

        @torch.inference_mode()
        def fn(toks, cur, page_table=None, d_len=None, uids=None, steps=None):
            args = (toks, state, *((page_table,) if paged else ()), cur,
                    *((d_len,) if verify else ()), uids, steps)
            out = step(*args)
            if verify:
                return torch.cat([out[0], out[1][:, None]], dim=1)
            return out[0]
        return StepGraph(self.graphs, fn, inputs)

    # -- queue -------------------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int | None = None, *, enc_inputs=None) -> int:
        """Queue one prompt; returns its uid.  ``enc_inputs`` (encoder_seq,
        d_model) is the request's encoder input, required for whisper and
        rejected for every other arch (the servable validates it)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("prompt must contain at least one token")
        enc_inputs = self.servable.validate_request(tokens, enc_inputs)
        max_new = self.scfg.max_new_tokens if max_new_tokens is None else max_new_tokens
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if len(tokens) + max_new > self.scfg.max_seq:
            raise ValueError(
                f"prompt {len(tokens)} + max_new {max_new} exceeds max_seq "
                f"{self.scfg.max_seq}")
        if self.paged:
            # A request must be able to finish alone in the pool: the progress
            # guarantee behind backpressure and preemption.
            worst = self.kv.pages_for(len(tokens) + max_new)
            if worst > self.kv.allocator.capacity:
                raise ValueError(
                    f"request needs {worst} pages but the pool has "
                    f"{self.kv.allocator.capacity}; grow num_blocks or shrink it")
        uid = self._next_uid
        self._next_uid += 1
        self.queue.append(Request(uid, tokens, max_new, enc_inputs,
                                  t_submit=time.perf_counter()))
        return uid

    @property
    def active_slots(self) -> list[_Slot]:
        return [s for s in self.slots if not s.free]

    @property
    def pending(self) -> bool:
        return bool(self.queue) or bool(self.active_slots) or bool(self._preempted)

    # -- admission ---------------------------------------------------------------

    def _lookup_prefix(self, req: Request) -> tuple[int, list[int], bool]:
        """The shared-prefix match of ``req`` -> (n_pages, blocks, probed);
        (0, [], False) without sharing.  Aligned to the prompt's chunk, so
        the tail runs the chunk grid a full prefill would.  Uncounted: the
        gate re-runs it every quantum a request waits, so ``_admit``
        records the one outcome of an admission (none when nothing was
        probed).  The lookup also marks the entry recently used, shielding
        it from the reclaim the gate may run next."""
        if not (self.paged and self.scfg.prefix_sharing):
            return 0, [], False
        chunk = min(self.scfg.prefill_chunk, len(req.tokens))
        n, blocks = self.kv.lookup_prefix(req.tokens, min_pages=self.scfg.prefix_min_pages,
                                          align_tokens=chunk, count=False)
        return n, blocks, self.kv.last_lookup_probed

    @tick_path(allowed_fetches=0)
    def _admission_fits(self, req: Request) -> bool:
        """The admission gate: pages through the first decode write
        (len + 1) are free, a shared-prefix match credited (mapped, not
        allocated), after reclaiming retained prefixes when short.  A
        reclaim may drop the matched entry itself, so the match is taken
        again (match -> reclaim -> match converges within 3 rounds).  The
        surviving match is stashed for ``_admit``."""
        full = self.kv.pages_for(len(req.tokens) + 1)
        for _ in range(3):
            n, blocks, probed = self._lookup_prefix(req)
            if full - n <= self.kv.free_pages:
                self._gate_match = (req.uid, n, blocks, probed)
                return True
            if not self.kv.reclaim_for(full - n):
                return False
        return False

    @tick_path(allowed_fetches=1)
    def _sample(self, logits_row: torch.Tensor, uid: int, step: int) -> int:
        """The admission's pick of token ``step`` of request ``uid``
        (greedy, or from its stream), reduced on the device and fetched
        with one ``host_fetch`` of its int32."""
        # The row's uid and step are filled on the device: a tensor built from
        # a Python list would be a blocking pageable copy on the tick path.
        dev = logits_row.device
        pick = T.sample_tokens(logits_row[None], temperature=self.scfg.temperature,
                               uids=torch.full((1,), uid, dtype=torch.int64, device=dev),
                               steps=torch.full((1,), step, dtype=torch.int64, device=dev))
        val = host_fetch(pick)
        self.metrics.inc("transfer.d2h_bytes", int(val.nbytes))
        return int(val[0])

    @tick_path(allowed_fetches=0)
    def _admit(self, req: Request, slot: _Slot) -> None:
        """Chunked prefill of ``req`` into ``slot``, with decode ticks for
        the active slots between chunks: fused into the slot's pages, or
        streamed over a b=1 cache and scattered into the slot.  A shared
        prefix is mapped first and only the tail is prefilled."""
        t0 = time.perf_counter()
        ot0 = self.obs.t()
        # Queue wait: submit -> queue pop (a direct _admit call has no stamp).
        queue_wait = max(0.0, t0 - req.t_submit) if req.t_submit else 0.0
        self.metrics.observe("latency.queue_wait_s", queue_wait)
        chunks0 = self.prefill_chunks
        shared_pages = 0
        if self.paged:
            if self.scfg.prefix_sharing:
                if self._gate_match and self._gate_match[0] == req.uid:
                    _, shared_pages, blocks, probed = self._gate_match
                else:  # a direct _admit call: no gate ran
                    shared_pages, blocks, probed = self._lookup_prefix(req)
                self._gate_match = None
                if probed:  # one counted outcome per admission
                    self.kv.registry.record_lookup(bool(shared_pages))
                if shared_pages:
                    self.kv.map_shared(slot.index, blocks)
                    self.prefix_hits += 1
                    self.prefix_pages_shared += shared_pages
            ok = self.kv.alloc(slot.index, len(req.tokens) + 1)
            assert ok, "admission checked free pages before popping the queue"
            # Until the slot goes active it is a padding row of the
            # interleaved ticks: its writes must go to the trash page, not
            # into its reserved (possibly shared) pages.
            self.kv.shield(slot.index)
        if self.scfg.fused_prefill:
            logits, pos, shared_len = self._fused_prefill(req, slot, shared_pages)
        else:
            logits, pos, shared_len = self._streamed_prefill(req, slot, shared_pages)
        if self.paged:
            self.kv.publish(slot.index)
            if self.scfg.prefix_sharing:
                self.kv.register_prefix(req.tokens, slot.index,
                                        min_pages=self.scfg.prefix_min_pages,
                                        align_tokens=self.scfg.prefill_chunk)
        first = self._sample(logits[0, -1], req.uid, 0)
        slot.uid = req.uid
        slot.prompt = req.tokens
        slot.cur = pos
        slot.pending = first
        slot.emitted = [first]
        slot.max_new = req.max_new_tokens
        slot.seq = self._admit_seq
        self._admit_seq += 1
        self.peak_active = max(self.peak_active, len(self.active_slots))
        self.admissions += 1
        dt = time.perf_counter() - t0
        self.admit_seconds += dt
        slot.ttft_s = queue_wait + dt  # the SLO policy's TTFT: from submit
        slot.t_last = t0 + dt  # the ITL clock starts at the first token
        slot.itl_max = 0.0
        slot.evictions = 0
        self.metrics.observe("latency.ttft_s", dt)
        self.metrics.inc("serving.tokens_emitted", 1)  # the first token
        self.obs.add("prefill", "admit", ot0, uid=req.uid,
                     chunks=self.prefill_chunks - chunks0, shared_len=shared_len,
                     prompt_len=len(req.tokens), slot=slot.index, queue_wait_s=queue_wait,
                     max_new=req.max_new_tokens)
        self._on_admit_logits(req.uid, logits[0, -1])
        self._reap(slot)

    def _interleave(self) -> None:
        """The decode ticks run after each dispatched prefill chunk."""
        for _ in range(self.scfg.decode_interleave):
            if self.active_slots:
                self._decode_tick()

    def _stage_prompt(self, req: Request, shared_len: int) -> np.ndarray:
        """The prompt tokens past ``shared_len`` as (1, n) host int32, under
        the reference's ``h2d_stage`` span (its bytes are the prompt's; the
        port's copies to the card happen per chunk, inside the step)."""
        ht0 = self.obs.t()
        tokens = req.tokens[None, shared_len:]
        self.obs.add("transfer", "h2d_stage", ht0, uid=req.uid,
                     h2d_bytes=int(len(req.tokens) - shared_len) * 4)
        return tokens

    def _fused_prefill(self, req: Request, slot: _Slot,
                       shared_pages: int) -> tuple[torch.Tensor, int, int]:
        """Each chunk's K/V written straight into ``slot``'s pages, from
        the end of its ``shared_pages`` mapped prefix pages (which the
        chunks read back through the table).  The device row stays shielded
        for the interleaved ticks; the chunks get a host row with the real
        pages, cut to the pages that cover the context so far.  The chunk
        grid is anchored at position 0, as a full prefill's.  Returns (last
        logits, prompt length, shared length)."""
        own = self.kv.slot_pages(slot.index)
        row = np.zeros((1, self.kv.max_pages), np.int32)
        row[0, : len(own)] = own
        shared_len = shared_pages * self.scfg.block_size
        tokens = self._stage_prompt(req, shared_len)
        s_total = tokens.shape[1]
        chunk = min(self.scfg.prefill_chunk, shared_len + s_total)
        pos = shared_len
        logits = None
        for lo in range(0, s_total, chunk):
            ct0 = self.obs.t()
            piece = tokens[:, lo: lo + chunk]
            n = piece.shape[1]
            step = self.servable.single._fused_chunk_fn(n, pos, self.kv.pools)
            logits = step(tokens=piece, page_table=row[:, : self.kv.pages_for(pos + n)])
            pos += n
            if pos == len(req.tokens):
                logits = logits.clone()  # kept past the ticks' replays
            self.prefill_chunks += 1
            self._interleave()
            # The chunk's in-flight window (dispatch through the interleaved
            # ticks), not its compute time.
            self.obs.add("prefill", "prefill_chunk", ct0, uid=req.uid, pos=pos, fused=True)
        return logits, pos, shared_len

    def _streamed_prefill(self, req: Request, slot: _Slot,
                          shared_pages: int) -> tuple[torch.Tensor, int, int]:
        """The b=1 streamed prefill (non-fused paths): load the slot's
        ``shared_pages`` mapped prefix pages into the front of a b=1 cache,
        or restore the longest stored state snapshot of the prompt (if any,
        mamba), and stream the rest, offering each chunk boundary for a
        snapshot; then scatter the b=1 cache into the slot's pages past the
        shared ones, or overwrite its rows of the contiguous cache whole
        (padding ticks filled them with garbage).  Returns (last logits,
        prompt length, shared or restored length)."""
        caches = zero_cache(self.servable.single.request_cache())
        if shared_pages:
            # The pool pages are never rewritten: the slot reads them
            # through its table; the copy is the tail's prefill context.
            shared_len = shared_pages * self.scfg.block_size
            self.kv.load_prefix(caches, self.kv.slot_pages(slot.index)[:shared_pages])
        else:
            shared_len, _ = self.servable.lookup_snapshot(req.tokens, into=caches)
            if shared_len:
                self.snapshot_hits += 1
                self.snapshot_tokens_reused += shared_len
        tokens = self._stage_prompt(req, shared_len)
        logits, pos = None, shared_len
        ct0 = self.obs.t()
        for logits, caches, pos in self.servable.iter_prefill_chunks(
                req, tokens, caches=caches, pos0=shared_len):
            self.servable.maybe_snapshot(req.tokens, caches, pos)
            if pos == len(req.tokens):
                logits = logits.clone()  # kept past the ticks' replays
            self.prefill_chunks += 1
            self._interleave()
            self.obs.add("prefill", "prefill_chunk", ct0, uid=req.uid, pos=pos, fused=False)
            ct0 = self.obs.t()
        st0 = self.obs.t()
        if self.paged:
            self.kv.scatter(slot.index, caches, pos, start_page=shared_pages)
            self.obs.add("transfer", "page_scatter", st0, uid=req.uid,
                         pages=int(self.kv.pages_for(pos) - shared_pages))
        else:
            scatter_slot_state(self.caches, caches, slot.index)
            self.obs.add("transfer", "slot_scatter", st0, uid=req.uid)
        return logits, pos, shared_len

    def _on_admit_logits(self, uid: int, logits: torch.Tensor) -> None:
        """Hook for callers that check the admission step's logits (the
        chip smoke holds card against CPU on them); a no-op here."""

    def _reap(self, slot: _Slot) -> None:
        """Free a finished slot and its pages, record its output; with an
        ``slo`` policy, score the request here (every request passes
        through once)."""
        if slot.done:
            if self.slo is not None:
                m = self.metrics
                m.inc("slo.requests")
                if self.slo.met(ttft_s=slot.ttft_s, itl_s=slot.itl_max):
                    m.inc("slo.requests_met")
                    m.inc("slo.goodput_tokens", len(slot.emitted))  # met requests only
                else:
                    if not self.slo.ttft_ok(slot.ttft_s):
                        m.inc("slo.ttft_violations")
                    if not self.slo.itl_ok(slot.itl_max):
                        m.inc("slo.itl_violations")
            self.outputs[slot.uid] = np.asarray(slot.emitted, np.int32)
            slot.uid = None
            slot.prompt = None
            slot.emitted = []
            if self.paged:
                self.kv.release(slot.index)

    # -- decode ------------------------------------------------------------------

    def _preempt_for_pages(self, protect: frozenset[int]) -> bool:
        """Evict the youngest active slot (by admission order) outside
        ``protect`` to the preempted queue, freeing its pages.  False =
        nobody to preempt."""
        victims = [s for s in self.active_slots if s.index not in protect]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.seq)
        self._preempted.append(self.evict(victim.uid))
        self.preemptions += 1
        return True

    @tick_path(allowed_fetches=0)
    def _fault_base_positions(self) -> None:
        """Lazy page fault: make each active slot's write position resident,
        oldest first, preempting the youngest other slots while the pool is
        dry.  With no other victim left (the rest of the pool may be an
        admission's reserved pages) the faulting slot preempts itself and
        waits for pages.  Shared by the plain and the speculative tick."""
        for s in sorted(self.active_slots, key=lambda s: s.seq):
            if s.uid is None:
                continue  # preempted earlier in this loop
            while not self.kv.ensure_write(s.index, s.cur):
                if not self._preempt_for_pages(frozenset({s.index})):
                    self._preempted.append(self.evict(s.uid))
                    self.preemptions += 1
                    break

    @tick_path(allowed_fetches=0)
    def _decode_tick(self) -> None:
        """One decode tick: speculative (draft + batched verify) when
        ``spec_decode`` is on, else one plain batched single-token step."""
        if self.scfg.spec_decode:
            self._spec_tick()
        else:
            self._plain_tick()

    def _tick_inputs(self, act: list[_Slot], toks: np.ndarray, cur: np.ndarray) -> dict:
        """A tick graph's host inputs: ``toks`` and ``cur``, the host page
        table as it stands (paged), and at temperature the (B,) uids and
        tokens emitted so far that key each row's draws (zeros on padding
        rows)."""
        vals = {"toks": toks, "cur": cur}
        if self.paged:
            vals["page_table"] = self.kv.page_table
        if self.scfg.temperature > 0.0:
            b = self.scfg.max_batch
            vals["uids"], vals["steps"] = np.zeros((b,), np.int32), np.zeros((b,), np.int32)
            for s in act:
                vals["uids"][s.index] = s.uid
                vals["steps"][s.index] = len(s.emitted)
        return vals

    def _emitted(self, s: _Slot, n: int, t1: float) -> None:
        """Per-request ITL of ``n`` tokens emitted at ``t1``: the gap since
        the slot's last token split across them (a readmitted slot's first
        tick absorbs its stall), observed once a token."""
        gap = (t1 - s.t_last) / n
        s.t_last = t1
        if gap > s.itl_max:
            s.itl_max = gap
        for _ in range(n):
            self.metrics.observe("latency.itl_s", gap)

    def _account_tick(self, name: str, ot0: int, dt: float, *, n_slots: int,
                      new_tokens: int, d2h_bytes: int, h2d_bytes: int, budget: Any,
                      attrib: dict[str, Any] | None = None) -> None:
        """A tick's bookkeeping, shared by the plain and speculative ticks:
        the token, time and byte counters, the per-tick D2H histogram, the
        decode-track span (``attrib``: the per-slot uid / token lists, when
        tracing), and, while tracing, the fetched bytes held to the step's
        declared ``@transfer_budget``: an excess is a live STR002 (counter,
        instant span on the transfer track, one warning per engine).  Every
        value is on the host already: nothing here waits on the device."""
        m = self.metrics
        m.inc("serving.tokens_emitted", new_tokens)
        m.inc("time.tick_seconds", dt)
        m.inc("transfer.d2h_bytes", d2h_bytes)
        m.inc("transfer.h2d_bytes", h2d_bytes)
        m.observe("transfer.d2h_bytes_per_tick", d2h_bytes)
        self._tick_index += 1
        self.obs.add("decode", name, ot0, tick=self._tick_index, slots=n_slots,
                     tokens=new_tokens, d2h_bytes=d2h_bytes, h2d_bytes=h2d_bytes,
                     **(attrib or {}))
        if budget is not None and self.obs.enabled:
            limit = budget.bytes_limit(self.scfg)
            if limit is not None and d2h_bytes > limit * self.scfg.max_batch:
                m.inc("analysis.str002_live")
                self.obs.instant("transfer", "STR002", tick=self._tick_index,
                                 d2h_bytes=d2h_bytes,
                                 limit=int(limit) * self.scfg.max_batch)
                if not self._budget_flagged:
                    self._budget_flagged = True
                    warnings.warn(
                        f"STR002 (live): {name} fetched {d2h_bytes} B this tick, over "
                        f"the declared @transfer_budget of "
                        f"{int(limit) * self.scfg.max_batch} B ({int(limit)} B/slot x "
                        f"{self.scfg.max_batch} slots)", RuntimeWarning, stacklevel=3)

    def metrics_snapshot(self) -> dict[str, Any]:
        """The engine's telemetry as one JSON-serializable dict, the
        reference's schema: the registry's ``counters`` and ``histograms``,
        and ``derived``: tokens/s over the engine's wall (ticks + admissions),
        spec acceptance, the prefix and snapshot hit rates, the SLO block
        (with a policy) and the pool's accounting (paged)."""
        snap = self.metrics.snapshot()
        c = snap["counters"]
        tokens = c.get("serving.tokens_emitted", 0)
        wall = c.get("time.tick_seconds", 0.0) + c.get("serving.admit_seconds", 0.0)
        admissions = c.get("serving.admissions", 0)
        proposed = c.get("serving.spec_proposed", 0)
        derived: dict[str, Any] = {
            "tokens_per_s": tokens / wall if wall > 0 else 0.0,
            "spec_acceptance": (c.get("serving.spec_accepted", 0) / proposed
                                if proposed else 0.0),
            "prefix_hit_rate": (c.get("serving.prefix_hits", 0) / admissions
                                if admissions else 0.0),
            "snapshot_hit_rate": (c.get("serving.snapshot_hits", 0) / admissions
                                  if admissions else 0.0),
        }
        if self.slo is not None:
            done = c.get("slo.requests", 0)
            met = c.get("slo.requests_met", 0)
            derived["slo"] = {
                "policy": self.slo.as_dict(),
                "requests": done,
                "met": met,
                "attainment": met / done if done else 0.0,
                "goodput_tokens_per_s": (c.get("slo.goodput_tokens", 0) / wall
                                         if wall > 0 else 0.0),
                "ttft_violations": c.get("slo.ttft_violations", 0),
                "itl_violations": c.get("slo.itl_violations", 0),
            }
        if self.paged:
            st = self.kv.stats(active_slots=len(self.active_slots))
            derived["pool"] = {
                "capacity": st.capacity,
                "in_use": st.in_use,
                "peak_in_use": st.peak_in_use,
                "utilization": st.utilization,
                "page_bytes": st.page_bytes,
                "bytes_in_use": st.bytes_in_use,
            }
        snap["derived"] = derived
        return snap

    @tick_path(allowed_fetches=1)
    def _plain_tick(self) -> None:
        """One batched decode step for all slots (free ones pad); the only
        device-to-host copy is the (B,) int32 picks, where the tick's span
        ends."""
        if self.paged:
            self._fault_base_positions()
        act = self.active_slots
        if not act:
            return
        ot0 = self.obs.t()
        t0 = time.perf_counter()
        b = self.scfg.max_batch
        toks = np.zeros((b, 1), np.int32)
        cur = np.zeros((b,), np.int32)
        for s in act:
            toks[s.index, 0] = s.pending
            cur[s.index] = s.cur
        nxt = self._decode(**self._tick_inputs(act, toks, cur))
        self.decode_steps += 1
        picks = host_fetch(nxt)  # the tick's one device-to-host copy
        t1 = time.perf_counter()
        attrib = (dict(uids=[s.uid for s in act], slot_ids=[s.index for s in act],
                       toks=[1] * len(act)) if self.obs.enabled else None)
        for s in act:
            s.cur += 1
            s.pending = int(picks[s.index])
            s.emitted.append(s.pending)
            self._emitted(s, 1, t1)
            self._reap(s)
        self._account_tick("decode_tick", ot0, t1 - t0, n_slots=len(act),
                           new_tokens=len(act), d2h_bytes=int(picks.nbytes),
                           h2d_bytes=int(toks.nbytes) + int(cur.nbytes),
                           budget=self._decode_budget, attrib=attrib)

    # -- speculative decode ------------------------------------------------------

    def _spec_budget(self, s: _Slot) -> int:
        """Draft tokens worth proposing for ``s`` this tick: capped by the
        remaining token budget (a tick emits at most budget + 1 tokens) and
        by the cache rows left for the draft block's writes."""
        return max(0, min(self.scfg.spec_k, s.max_new - len(s.emitted) - 1,
                          self.scfg.max_seq - 1 - s.cur))

    # The reference's verify tick declares 2 fetches (emit, then n_accept);
    # the port copies both in one (B, k+2) array, the same bytes.
    @tick_path(allowed_fetches=1)
    def _spec_tick(self) -> None:
        """One speculate/verify step: the drafter proposes up to ``spec_k``
        tokens per slot, one multi-token step scores all ``k + 1``
        positions, and each slot advances by its accepted prefix plus the
        bonus token.  The base position faults as in the plain tick; draft
        positions are best-effort — a slot never takes pages it cannot get,
        its draft shrinks to the pages that fit.  After acceptance the
        pages of rejected positions go back (``kv.truncate``).  A tick with
        no draft at all runs the plain tick instead."""
        k = self.scfg.spec_k
        if self.paged:
            self._fault_base_positions()
        act = self.active_slots
        if not act:
            return
        ot0 = self.obs.t()
        t0 = time.perf_counter()
        b = self.scfg.max_batch
        toks = np.zeros((b, k + 1), np.int32)
        cur = np.zeros((b,), np.int32)
        d_len = np.zeros((b,), np.int32)
        dt0 = self.obs.t()
        for s in act:
            toks[s.index, 0] = s.pending
            cur[s.index] = s.cur
            budget = self._spec_budget(s)
            draft = np.zeros(0, np.int32)
            if budget > 0:
                draft = np.asarray(self.drafter.propose(
                    np.concatenate([s.prompt, np.asarray(s.emitted, np.int32)]),
                    budget), np.int32)[:budget]
            if self.paged:
                have = draft.size
                for pos in range(s.cur + 1, s.cur + draft.size + 1):
                    if not self.kv.ensure_write(s.index, pos):
                        have = pos - s.cur - 1
                        break
                draft = draft[:have]
            if draft.size:
                toks[s.index, 1: 1 + draft.size] = draft
                d_len[s.index] = draft.size
                self.spec_proposed += int(draft.size)
        self.obs.add("decode", "spec_draft", dt0, proposed=int(d_len.sum()),
                     **(dict(uids=[s.uid for s in act], slot_ids=[s.index for s in act],
                             drafted=[int(d_len[s.index]) for s in act])
                        if self.obs.enabled else {}))
        if not int(d_len.sum()):
            # Every drafter came back empty: the (k+1)-wide verify step would
            # cost ~(k+1)x a plain tick with nothing to accept.
            self._plain_tick()
            return
        got = self._verify(**self._tick_inputs(act, toks, cur), d_len=d_len)
        self.decode_steps += 1
        self.spec_ticks += 1
        # The tick's one device-to-host copy: (B, k+1) emitted tokens and
        # (B,) acceptance counts side by side.
        got = host_fetch(got)
        t1 = time.perf_counter()
        rt0 = self.obs.t()
        new_tokens = 0
        attrib = (dict(uids=[s.uid for s in act], slot_ids=[s.index for s in act], toks=[])
                  if self.obs.enabled else None)
        for s in act:
            n = int(got[s.index, -1])
            self.spec_accepted += n
            new = got[s.index, : n + 1].tolist()
            new_tokens += n + 1
            s.cur += n + 1
            s.pending = new[-1]
            s.emitted.extend(new)
            self._emitted(s, n + 1, t1)
            if attrib is not None:
                attrib["toks"].append(n + 1)
            if self.paged:
                # Rollback: pages faulted for rejected draft positions go back.
                self.kv.truncate(s.index, s.cur)
            self._reap(s)
        if self.paged:
            self.obs.add("transfer", "spec_rollback", rt0, accepted=new_tokens - len(act),
                         **({"uids": attrib["uids"]} if attrib else {}))
        self._account_tick("spec_tick", ot0, t1 - t0, n_slots=len(act),
                           new_tokens=new_tokens, d2h_bytes=int(got.nbytes),
                           h2d_bytes=int(toks.nbytes) + int(cur.nbytes) + int(d_len.nbytes),
                           budget=self._verify_budget, attrib=attrib)

    # -- scheduling --------------------------------------------------------------

    @tick_path(allowed_fetches=0)
    def step(self) -> None:
        """One scheduling quantum: readmit page-pressure victims while their
        pages through the next write fit, admit queued requests into free
        slots while their pages fit (FIFO, no overtaking), else run one
        decode tick."""
        progressed = False
        if self.paged:
            # Gate on cur + 1: the next tick writes at position cur, so a
            # page-aligned cur needs one more page than the snapshot holds.
            # A registered prefix of the prompt is credited (re-mapped, not
            # allocated) and retained prefix pages are reclaimed when short;
            # the match -> reclaim -> match loop converges as the gate's.
            while self._preempted and any(s.free for s in self.slots):
                ev0 = self._preempted[0]
                full = self.kv.pages_for(ev0.cur + 1)
                fits = False
                for _ in range(3):
                    shared, _ = self._readmit_prefix(ev0)
                    if full - shared <= self.kv.free_pages:
                        fits = True
                        break
                    if not self.kv.reclaim_for(full - shared):
                        break
                if not fits:
                    break
                self.readmit(self._preempted.popleft())
                progressed = True
        free = [s for s in self.slots if s.free]
        while self.queue and free and (not self.paged
                                       or self._admission_fits(self.queue[0])):
            self._admit(self.queue.popleft(), free.pop(0))
            progressed = True
        if not progressed:
            self._decode_tick()

    def run(self) -> dict[int, np.ndarray]:
        """Drain the queue, the preempted requests and all active slots;
        returns uid -> tokens for the requests finished since the last
        ``run``."""
        while self.pending:
            before = (len(self.queue), len(self._preempted), self.decode_steps)
            self.step()
            if not self.active_slots and before == (
                    len(self.queue), len(self._preempted), self.decode_steps):
                raise RuntimeError(  # submit() rules this out; never spin
                    "a waiting request cannot be admitted into an idle pool")
        done, self.outputs = self.outputs, {}
        return done

    # -- eviction / readmission ----------------------------------------------------

    def evict(self, uid: int) -> EvictedRequest:
        """Pull request ``uid`` out of its slot with its cache rows and
        positions.  Paged: its pages are gathered into a b=1 cache (their
        contents travel with the request) and freed.  Contiguous: a copy of
        its slot rows."""
        slot = next((s for s in self.slots if s.uid == uid), None)
        if slot is None:
            raise KeyError(f"uid {uid} not active")
        et0 = self.obs.t()
        if self.paged:
            caches = self.kv.gather(slot.index, slot.cur)
            n_pages = self.kv.pages_for(slot.cur)
            self.kv.release(slot.index)
        else:
            caches = gather_slot_state(self.caches, slot.index)
            n_pages = 0
        self.obs.add("transfer", "evict", et0, uid=uid, pages=n_pages, cur=slot.cur,
                     slot=slot.index)
        ev = EvictedRequest(uid=uid, caches=caches, cur=slot.cur, pending=slot.pending,
                            emitted=list(slot.emitted), max_new=slot.max_new,
                            n_pages=n_pages, seq=slot.seq, prompt=slot.prompt,
                            ttft_s=slot.ttft_s, t_last=slot.t_last, itl_max=slot.itl_max,
                            evictions=slot.evictions + 1)
        slot.uid = None
        slot.emitted = []
        slot.prompt = None
        self._evicted_out += 1
        return ev

    def _readmit_prefix(self, ev: EvictedRequest) -> tuple[int, list[int]]:
        """The registered-prefix match of a readmission -> (n_pages,
        blocks).  Matched blocks are byte-checked against the prompt and
        immutable until a COW fork or a reclaim, so mapping them reproduces
        the evicted rows of the prefix exactly."""
        if not (self.paged and self.scfg.prefix_sharing
                and ev.prompt is not None and len(ev.prompt) > 1):
            return 0, []
        chunk = min(self.scfg.prefill_chunk, len(ev.prompt))
        return self.kv.lookup_prefix(ev.prompt, min_pages=self.scfg.prefix_min_pages,
                                     align_tokens=chunk, count=False)

    def readmit(self, ev: EvictedRequest) -> int:
        """Write an evicted request back into any free slot; its positions
        are kept, so decode resumes where it stopped.  Paged: a registered
        prefix of its prompt is re-mapped at refcount + 1 (its rows are not
        scattered), then pages through the next write (``cur + 1``) are
        allocated; ``RuntimeError`` when the pool is short.  Returns the
        slot index."""
        slot = next((s for s in self.slots if s.free), None)
        if slot is None:
            raise RuntimeError("no free slot to readmit into")
        rt0 = self.obs.t()
        shared_pages = 0
        if self.paged:
            shared_pages, blocks = self._readmit_prefix(ev)
            if shared_pages:
                self.kv.map_shared(slot.index, blocks)
            if not self.kv.alloc(slot.index, ev.cur + 1):
                self.kv.release(slot.index)  # drop a mapped prefix cleanly
                raise RuntimeError(
                    f"not enough free pages to readmit uid {ev.uid} (need "
                    f"{self.kv.pages_for(ev.cur + 1)}, free {self.kv.free_pages})")
            self.kv.scatter(slot.index, ev.caches, ev.cur, start_page=shared_pages)
            if shared_pages:
                self.readmit_prefix_hits += 1
                self.readmit_prefix_pages += shared_pages
        else:
            scatter_slot_state(self.caches, ev.caches, slot.index)
        self.obs.add("transfer", "readmit", rt0, uid=ev.uid, pages=ev.n_pages,
                     shared_pages=shared_pages, slot=slot.index)
        slot.uid = ev.uid
        slot.cur = ev.cur
        slot.pending = ev.pending
        slot.emitted = list(ev.emitted)
        slot.max_new = ev.max_new
        slot.prompt = ev.prompt
        slot.ttft_s = ev.ttft_s
        slot.t_last = ev.t_last  # the stall lands in the next tick's gap
        slot.itl_max = ev.itl_max
        slot.evictions = ev.evictions
        # The original admission order: a fresh seq would make every
        # readmitted request the youngest, the next victim (thrash).
        slot.seq = ev.seq
        self._evicted_out -= 1
        self.peak_active = max(self.peak_active, len(self.active_slots))
        return slot.index

    # -- policy ------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _time_step(self, step: StepGraph, inputs: dict) -> float:
        """Seconds of one warm run of ``step``: run until it would replay
        (on a card its first use is eager and its second captures), then
        time one run between two synchronizations."""
        step(**inputs)
        if step.graphs.capture is not None and step.graph is None:
            step(**inputs)
        self._sync()
        t0 = time.perf_counter()
        step(**inputs)
        self._sync()
        return time.perf_counter() - t0

    def measure_stage_times(self, prompt_len: int) -> rmetric.StageTimes:
        """Time one prefill chunk (h2d, the ingest stage) and one batched
        decode tick (kex, the compute stage), each warm, on synthetic
        inputs: the paper's stage-by-stage measurement (§3.3) that
        ``autotune`` plans from, kept in ``last_stage_times``.

        The chunk is the engine's first-chunk graph of ``min(prefill_chunk,
        prompt_len)`` zero tokens over the zeroed request cache, which only
        an admission in flight holds (whisper's gets ``probe_enc_out``).
        The tick is the engine's decode graph with every row padding; the
        step writes in place, so no live state may change: paged, every row
        of its table points at the trash page, and the per-slot state it
        writes all the same (SSM state, conv tails) is copied aside and
        back; contiguous, the whole slot cache is."""
        chunk = min(self.scfg.prefill_chunk, prompt_len)
        single = self.servable.single
        zero_cache(single.request_cache())
        inputs: dict[str, Any] = {"tokens": np.zeros((1, chunk), np.int32)}
        enc0 = self.servable.probe_enc_out()
        if enc0 is not None:
            inputs["enc_out"] = enc0
        t_chunk = self._time_step(single._prefill_chunk_fn(chunk, True, 0), inputs)

        b = self.scfg.max_batch
        inputs = {"toks": np.zeros((b, 1), np.int32), "cur": np.zeros((b,), np.int32)}
        if self.paged:
            inputs["page_table"] = np.full((b, self.kv.max_pages), TRASH_PAGE, np.int32)
            written = [leaf for c in self.kv.pools["blocks"].values()
                       for key, leaf in c.items() if key not in PAGED_LEAVES]
        else:
            written = [leaf for c in self.caches["blocks"].values() for leaf in c.values()]
        if self.scfg.temperature > 0.0:
            inputs["uids"] = inputs["steps"] = np.zeros((b,), np.int32)
        saved = [leaf.clone() for leaf in written]
        try:
            t_decode = self._time_step(self._decode, inputs)
        finally:
            for leaf, copy in zip(written, saved):
                leaf.copy_(copy)
        self.last_stage_times = rmetric.StageTimes(h2d=t_chunk, kex=t_decode)
        return self.last_stage_times

    def autotune(self, prompt_len: int) -> ServingPlan:
        """Measure the stage times and apply the planned chunk and
        interleave (the reference's rules); registered prefixes and state
        snapshots stranded off a new chunk grid are dropped.  The pool is
        rebuilt at the planned page size only when it is idle: no page in
        use, no evicted request out (its gathered rows are in old pages),
        nothing queued (validated against the old pool), the page size
        dividing ``max_seq``; a registry that alone holds pages is dropped
        first.  A rebuild drops every graph over the old pool (the tick
        graphs, the fused chunks) and builds them over the new one."""
        plan = plan_decode_policy(self.measure_stage_times(prompt_len),
                                  prompt_len=prompt_len, max_seq=self.scfg.max_seq)
        self.last_plan = plan
        chunk_changed = plan.prefill_chunk != self.scfg.prefill_chunk
        self.scfg.prefill_chunk = plan.prefill_chunk
        self.scfg.decode_interleave = plan.decode_interleave
        if chunk_changed and self.paged and self.scfg.prefix_sharing:
            self.kv.clear_stranded_prefixes(self.scfg.prefill_chunk)
        if chunk_changed and self.servable.snapshots is not None:
            self.servable.snapshots.clear()
        resize = self.paged and plan.block_size != self.scfg.block_size
        if (resize and not self.active_slots and self._evicted_out == 0
                and len(self.kv.registry)):
            self.kv.clear_prefixes()
        if (resize and self.kv.pages_in_use == 0 and self._evicted_out == 0
                and not self.queue and self.scfg.max_seq % plan.block_size == 0):
            if self.scfg.num_blocks is not None:
                # The explicit pool's row budget at the new page size, + trash.
                rows = self.kv.allocator.capacity * self.kv.block_size
                self.scfg.num_blocks = rows // plan.block_size + 1
            self.scfg.block_size = plan.block_size
            self._rebuild_pool()
        return plan

    def _rebuild_pool(self) -> None:
        """A new pool at ``scfg``'s page size.  Every graph that holds the
        old pool goes first (the tick graphs, the fused chunk graphs; the
        page moves go with the old pool object), so none replays over freed
        memory, and the old pool is freed before the new one is made."""
        self._decode = self._verify = None
        chunks = self.servable.single._chunk_jit
        for key in [k for k in chunks if k[0] == "fused"]:
            del chunks[key]
        self.kv = None
        self.kv = self.servable.make_kv_pool()
        self._build_ticks()

    def save_prefixes(self) -> int:
        """Write the prefix registry to ``scfg.prefix_store`` (the other half
        of the restore at construction); returns the entries written (0
        without a store or outside paged sharing)."""
        if not (self.paged and self.scfg.prefix_sharing and self.scfg.prefix_store):
            return 0
        return self.kv.save_prefixes(self.scfg.prefix_store)
