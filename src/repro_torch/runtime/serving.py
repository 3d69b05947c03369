"""Continuous-batching engine with chunked prefill (reference
``runtime/serving.py``): transformer serving over a contiguous slot cache
or a paged pool (fused prefill, or scatter-after-prefill), and mamba
serving over a contiguous slot cache or beside a paged pool.
``ServingEngine`` holds the b=1 streamed prefill of one admission and
``generate``, the b=1 greedy oracle.

* **Slots**: ``max_batch`` decode slots share the cache; each carries its
  own position ``cur``, so rope, the cache write and the attention cut are
  per row.  Free slots ride along as padding rows: their table rows point
  at the trash page, and their rows of the contiguous cache or slot state
  fill with garbage that the next admission's scatter overwrites whole.
* **Admission**: a request's prompt streams in ``prefill_chunk`` pieces;
  after each chunk is enqueued, ``decode_interleave`` batched decode ticks
  run for the active slots.  Paged: its pages are reserved through its
  first decode write and its table row is shielded until the prompt is in.
  Fused (paged transformers by default): each chunk's K/V are written
  straight into its pages (the host row carries the real pages for the
  chunks).  Otherwise the chunks run over a b=1 contiguous cache (mamba:
  optionally resumed from a restored state snapshot), which is scattered
  into the slot when the prompt is in (``kv.scatter`` into pages, or the
  slot's rows of the contiguous cache).
* **Decode tick**: fault in each active slot's write page, one batched
  greedy step on the device, and exactly one device-to-host copy — the
  ``(B,)`` int32 picks.
* **Speculative tick** (``spec_decode``): a drafter proposes up to
  ``spec_k`` tokens per slot, one multi-token verify step scores the
  pending token plus the draft, and each slot advances by its accepted
  prefix plus the bonus token; one device-to-host copy of ``(emit,
  n_accept)``.  Draft pages are faulted best-effort and rolled back
  (``kv.truncate``) past the accepted prefix.  Greedy output equals the
  plain ticks' by construction.
* **Quantized pages** (``kv_dtype`` "int8" / "fp8"): the pool stores codes
  and per-(page, kv head) scales; see ``kernels/quant``.
* **Backpressure and preemption** (paged): a request waits in the queue
  (FIFO) until the free list holds its pages.  When a tick cannot fault
  in a slot's write page, the youngest other slot is evicted (its pages
  gathered into a b=1 cache, then freed) and waits to be readmitted
  (scattered back) before any new admission; with no other victim the
  faulting slot evicts itself.  ``submit`` rejects a request that could
  not finish alone in the pool, so every request finishes.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import quant
from repro_torch.models import transformer as T
from repro_torch.runtime import spec
from repro_torch.runtime.kv_cache import gather_slot_state, scatter_slot_state

# Reference ServeConfig features outside the port so far: field -> (the value
# the port supports, the ROADMAP item that ports the rest).
_NOT_PORTED = {
    "temperature": (0.0, "temperature sampling (with or without spec_decode)"),
    "prefix_sharing": (False, "prefix sharing and COW"),
    "prefix_store": (None, "prefix sharing and COW (the prefix store)"),
}


@dataclasses.dataclass
class ServeConfig:
    max_seq: int = 1024
    prefill_chunk: int = 256  # task size for streamed prefill
    max_new_tokens: int = 32
    max_batch: int = 4  # decode slots
    decode_interleave: int = 1  # decode ticks per in-flight prefill chunk
    block_size: int = 16  # cache rows per page
    num_blocks: int | None = None  # pool size; None = every slot at max_seq + trash
    kv_dtype: str = "fp32"  # pool storage: "fp32" | "int8" | "fp8"
    # speculative decode: a drafter proposes spec_k tokens, one batched
    # verify step scores all k + 1 positions (greedy only)
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
    # Stamped by build_servable from the model ("transformer" | "mamba");
    # setting it up front validates arch-dependent flags early.
    arch_kind: str | None = None
    # Reference features not ported yet; any other value raises.
    temperature: float = 0.0
    prefix_sharing: bool = False
    prefix_store: str | None = None

    def __post_init__(self) -> None:
        for name, (ok, item) in _NOT_PORTED.items():
            if getattr(self, name) != ok:
                raise NotImplementedError(
                    f"ServeConfig.{name}={getattr(self, name)!r} is not ported "
                    f"yet (the port supports {ok!r}): ROADMAP, {item}")
        for name in ("max_seq", "prefill_chunk", "max_new_tokens", "max_batch",
                     "decode_interleave", "block_size", "spec_k", "spec_ngram"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, got {getattr(self, name)}")
        quant.validate_kv_dtype(self.kv_dtype)
        if quant.is_quantized(self.kv_dtype) and not self.paged:
            raise ValueError(
                "kv_dtype quantizes the paged KV pool; it requires paged=True (the "
                "contiguous cache stays full precision)")
        if self.fused_prefill and not self.paged:
            raise ValueError(
                "fused_prefill writes prefill K/V through the page table; it requires "
                "paged=True")
        if self.paged:
            if self.max_seq % self.block_size:
                raise ValueError(
                    f"max_seq {self.max_seq} must be a multiple of block_size "
                    f"{self.block_size} (pages tile the cache)")
            if self.num_blocks is not None and self.num_blocks < 2:
                raise ValueError(
                    f"num_blocks must be >= 2 (block 0 is the trash page), got "
                    f"{self.num_blocks}")
        self.validate_arch()

    def validate_arch(self) -> None:
        """Arch-dependent flag validation (the reference's rules and
        messages, plus the port's): a no-op until ``arch_kind`` is stamped,
        which ``build_servable`` does with the model in hand."""
        kind = self.arch_kind
        if kind is None:
            return
        if kind not in ("transformer", "mamba"):
            raise ValueError(f"unknown arch_kind {kind!r}; expected transformer | mamba")
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
            if quant.is_quantized(self.kv_dtype):
                raise NotImplementedError(
                    "quantized KV pages cover attention K/V pool blocks; "
                    f"arch_kind={kind!r} carries cache state (SSM rows) with no per-page "
                    "scale — serve it with kv_dtype='fp32'")
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
    ``ServingEngine.iter_prefill_chunks``) over a contiguous cache, and
    ``generate``, the one-request-at-a-time greedy decode after it."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg, *, device, unembed):
        self.cfg, self.params, self.scfg, self.device = cfg, params, scfg, device
        self.unembed = unembed

    def iter_prefill_chunks(self, tokens: torch.Tensor, *, caches=None, pos0: int = 0
                            ) -> Iterator[tuple[torch.Tensor, dict, int]]:
        """Yield (logits-so-far (1, 1, V), caches, position after the chunk)
        per prompt chunk.  ``caches``/``pos0`` continue a prefill whose first
        ``pos0`` tokens are already in the cache (a restored snapshot).  The
        chunk grid is anchored at position 0 (the chunk size is picked from
        the *full* length ``pos0 + s``), so a continued prefill dispatches
        the chunks a full prefill would."""
        cfg, params, unembed = self.cfg, self.params, self.unembed
        b, s = tokens.shape
        if caches is None:
            assert pos0 == 0, "a continued prefill needs its context cache"
            # The streamed prefill needs full-length caches (no SWA ring).
            caches = T.init_cache(cfg, b, self.scfg.max_seq, ring=False,
                                  device=self.device)
        chunk = min(self.scfg.prefill_chunk, pos0 + s)
        pos = pos0
        for lo in range(0, s, chunk):
            piece = tokens[:, lo: lo + chunk]
            with torch.inference_mode():
                logits, caches = T.prefill_chunk(cfg, params, piece, caches, pos,
                                                 unembed=unembed)
            pos += piece.shape[1]
            yield logits, caches, pos

    def generate(self, tokens) -> torch.Tensor:
        """Greedy decode of ``max_new_tokens`` after a streamed prefill of
        ``tokens`` (B, S) (reference ``ServingEngine.generate``, greedy):
        every row at one position, one decode step a token over the
        contiguous cache, the pick on the device.  Returns (B,
        max_new_tokens) int32 on the engine's device."""
        tokens = torch.as_tensor(np.asarray(tokens, np.int32)).to(self.device)
        logits = caches = None
        pos = 0
        for logits, caches, pos in self.iter_prefill_chunks(tokens):
            pass
        nxt = T.sample_tokens(logits[:, -1])
        out = [nxt]
        b = tokens.shape[0]
        with torch.inference_mode():
            for i in range(self.scfg.max_new_tokens - 1):
                cur = torch.full((b,), pos + i, dtype=torch.int32, device=self.device)
                nxt, caches = T.decode_and_sample(self.cfg, self.params, nxt[:, None],
                                                  caches, cur, unembed=self.unembed)
                out.append(nxt)
        return torch.stack(out, dim=1)


@dataclasses.dataclass
class Request:
    uid: int
    tokens: np.ndarray  # (prompt_len,) int32
    max_new_tokens: int


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
    ready to readmit into any free slot.  (The reference also carries the
    latency fields ``ttft_s``, ``t_last`` and ``itl_max``; they come with
    the observability wiring, ROADMAP A8.)"""

    uid: int
    caches: dict  # b=1 cache: max_seq rows (contiguous), or the gathered pages
    cur: int
    pending: int
    emitted: list[int]
    max_new: int
    n_pages: int = 0  # pages gathered (0 = contiguous eviction)
    seq: int = 0  # original admission order, restored on readmit
    prompt: np.ndarray | None = None  # the drafter's corpus
    evictions: int = 0


class StreamedBatchEngine:
    """Continuous-batching serving on ``device`` (CUDA unless the caller
    passes ``"cpu"``).  Greedy output per request equals the reference
    engine's.  With ``spec_decode``, ``drafter`` (anything with
    ``propose(context, k)``) replaces the default ``NGramDrafter``."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg: ServeConfig, *,
                 device=None, drafter: spec.Drafter | None = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        # Imported here: model_iface imports this module eagerly.
        from repro_torch.runtime.model_iface import build_servable
        self.servable = build_servable(cfg, params, scfg, device=self.device)
        self.paged = scfg.paged
        if self.paged:
            self.kv = self.servable.make_kv_pool()
            self.caches = None  # the state lives in self.kv.pools
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
        self._chunk = self.servable.chunk_fn() if scfg.fused_prefill else None
        self._decode = self.servable.decode_fn(paged=self.paged)
        self.decode_steps = 0  # batched decode ticks run (plain and verify)
        self.prefill_chunks = 0  # prompt chunks run
        self.admissions = 0
        self.preemptions = 0  # evictions for page pressure
        self.peak_active = 0  # most requests resident at once
        self.snapshot_hits = 0  # admissions that restored an SSM-state snapshot
        self.snapshot_tokens_reused = 0  # prompt tokens never re-prefilled
        self.spec_ticks = 0  # verify steps run
        self.spec_proposed = 0  # draft tokens scored by verify steps
        self.spec_accepted = 0  # draft tokens accepted (rate = accepted / proposed)
        self.drafter = None
        self._verify = None
        if scfg.spec_decode:
            self.drafter = (drafter if drafter is not None
                            else spec.NGramDrafter(max_n=scfg.spec_ngram))
            self._verify = self.servable.verify_fn(paged=self.paged)

    # -- queue -------------------------------------------------------------------

    def submit(self, tokens, max_new_tokens: int | None = None) -> int:
        """Queue one prompt; returns its uid."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError("prompt must contain at least one token")
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
        self.queue.append(Request(uid, tokens, max_new))
        return uid

    @property
    def active_slots(self) -> list[_Slot]:
        return [s for s in self.slots if not s.free]

    @property
    def pending(self) -> bool:
        return bool(self.queue) or bool(self.active_slots) or bool(self._preempted)

    # -- admission ---------------------------------------------------------------

    def _admission_fits(self, req: Request) -> bool:
        """Pages through the first decode write (len + 1) are free."""
        return self.kv.pages_for(len(req.tokens) + 1) <= self.kv.free_pages

    def _admit(self, req: Request, slot: _Slot) -> None:
        """Chunked prefill of ``req`` into ``slot``, with decode ticks for
        the active slots between chunks: fused into the slot's pages, or
        streamed over a b=1 cache and scattered into the slot."""
        if self.paged:
            ok = self.kv.alloc(slot.index, len(req.tokens) + 1)
            assert ok, "admission checked free pages before popping the queue"
            # Until the slot goes active it is a padding row of the
            # interleaved ticks: its writes must go to the trash page.
            self.kv.shield(slot.index)
        if self.scfg.fused_prefill:
            logits, pos = self._fused_prefill(req, slot)
        else:
            logits, pos = self._streamed_prefill(req, slot)
        if self.paged:
            self.kv.publish(slot.index)
        first = int(torch.argmax(logits[0, -1]).item())  # the admission's one fetch
        slot.uid = req.uid
        slot.prompt = req.tokens
        slot.cur = pos
        slot.pending = first
        slot.emitted = [first]
        slot.max_new = req.max_new_tokens
        slot.seq = self._admit_seq
        slot.evictions = 0
        self._admit_seq += 1
        self.admissions += 1
        self.peak_active = max(self.peak_active, len(self.active_slots))
        self._on_admit_logits(req.uid, logits[0, -1])
        self._reap(slot)

    def _interleave(self) -> None:
        """The decode ticks run after each dispatched prefill chunk."""
        for _ in range(self.scfg.decode_interleave):
            if self.active_slots:
                self._decode_tick()

    def _fused_prefill(self, req: Request, slot: _Slot) -> tuple[torch.Tensor, int]:
        """Each chunk's K/V written straight into ``slot``'s pages.  The
        device row stays shielded for the interleaved ticks; the chunks get
        a host row with the real pages, cut to the pages that cover the
        context so far.  Returns (last logits, prompt length)."""
        own = self.kv.slot_pages(slot.index)
        row = np.zeros((1, self.kv.max_pages), np.int32)
        row[0, : len(own)] = own
        tokens = torch.from_numpy(req.tokens[None]).to(self.device)
        s_total = tokens.shape[1]
        chunk = min(self.scfg.prefill_chunk, s_total)
        pos = 0
        logits = None
        for lo in range(0, s_total, chunk):
            piece = tokens[:, lo: lo + chunk]
            n_ctx = self.kv.pages_for(pos + piece.shape[1])
            pt = torch.from_numpy(row[:, :n_ctx].copy()).to(self.device)
            logits, self.kv.pools = self._chunk(self.kv.pools, pt, piece, pos)
            pos += piece.shape[1]
            self.prefill_chunks += 1
            self._interleave()
        return logits, pos

    def _streamed_prefill(self, req: Request, slot: _Slot) -> tuple[torch.Tensor, int]:
        """The b=1 streamed prefill (non-fused paths): restore the longest
        stored state snapshot of the prompt (if any, mamba) and stream the
        rest, offering each chunk boundary for a snapshot; then scatter the
        b=1 cache into the slot's pages, or overwrite its rows of the
        contiguous cache whole (padding ticks filled them with garbage).
        Returns (last logits, prompt length)."""
        shared_len, caches = self.servable.lookup_snapshot(req.tokens)
        if shared_len:
            self.snapshot_hits += 1
            self.snapshot_tokens_reused += shared_len
        tokens = torch.from_numpy(req.tokens[None, shared_len:].copy()).to(self.device)
        logits, pos = None, shared_len
        for logits, caches, pos in self.servable.iter_prefill_chunks(
                tokens, caches=caches, pos0=shared_len):
            self.servable.maybe_snapshot(req.tokens, caches, pos)
            self.prefill_chunks += 1
            self._interleave()
        if self.paged:
            self.kv.scatter(slot.index, caches, pos)
        else:
            scatter_slot_state(self.caches, caches, slot.index)
        return logits, pos

    def _on_admit_logits(self, uid: int, logits: torch.Tensor) -> None:
        """Hook for callers that check the admission step's logits (the
        chip smoke holds card against CPU on them); a no-op here."""

    def _reap(self, slot: _Slot) -> None:
        """Free a finished slot and its pages, record its output."""
        if slot.done:
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

    def _decode_tick(self) -> None:
        """One decode tick: speculative (draft + batched verify) when
        ``spec_decode`` is on, else one plain batched single-token step."""
        if self.scfg.spec_decode:
            self._spec_tick()
        else:
            self._plain_tick()

    def _plain_tick(self) -> None:
        """One batched greedy decode step for all slots (free ones pad);
        the only device-to-host copy is the (B,) int32 picks."""
        if self.paged:
            self._fault_base_positions()
        act = self.active_slots
        if not act:
            return
        b = self.scfg.max_batch
        toks = np.zeros((b, 1), np.int32)
        cur = np.zeros((b,), np.int32)
        for s in act:
            toks[s.index, 0] = s.pending
            cur[s.index] = s.cur
        toks_d = torch.from_numpy(toks).to(self.device)
        cur_d = torch.from_numpy(cur).to(self.device)
        if self.paged:
            nxt, self.kv.pools = self._decode(toks_d, self.kv.pools,
                                              self.kv.device_page_table(), cur_d)
        else:
            nxt, self.caches = self._decode(toks_d, self.caches, cur_d)
        self.decode_steps += 1
        picks = nxt.cpu().numpy()  # the tick's one device-to-host copy
        for s in act:
            s.cur += 1
            s.pending = int(picks[s.index])
            s.emitted.append(s.pending)
            self._reap(s)

    # -- speculative decode ------------------------------------------------------

    def _spec_budget(self, s: _Slot) -> int:
        """Draft tokens worth proposing for ``s`` this tick: capped by the
        remaining token budget (a tick emits at most budget + 1 tokens) and
        by the cache rows left for the draft block's writes."""
        return max(0, min(self.scfg.spec_k, s.max_new - len(s.emitted) - 1,
                          self.scfg.max_seq - 1 - s.cur))

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
        b = self.scfg.max_batch
        toks = np.zeros((b, k + 1), np.int32)
        cur = np.zeros((b,), np.int32)
        d_len = np.zeros((b,), np.int32)
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
        if not int(d_len.sum()):
            # Every drafter came back empty: the (k+1)-wide verify step would
            # cost ~(k+1)x a plain tick with nothing to accept.
            self._plain_tick()
            return
        dev = self.device
        toks_d, cur_d, d_len_d = (torch.from_numpy(a).to(dev) for a in (toks, cur, d_len))
        if self.paged:
            emit, n_accept, self.kv.pools = self._verify(
                toks_d, self.kv.pools, self.kv.device_page_table(), cur_d, d_len_d)
        else:
            emit, n_accept, self.caches = self._verify(toks_d, self.caches, cur_d, d_len_d)
        self.decode_steps += 1
        self.spec_ticks += 1
        # The tick's one device-to-host copy: (B, k+1) emitted tokens and
        # (B,) acceptance counts side by side.
        got = torch.cat([emit, n_accept[:, None]], dim=1).cpu().numpy()
        for s in act:
            n = int(got[s.index, -1])
            self.spec_accepted += n
            new = got[s.index, : n + 1].tolist()
            s.cur += n + 1
            s.pending = new[-1]
            s.emitted.extend(new)
            if self.paged:
                # Rollback: pages faulted for rejected draft positions go back.
                self.kv.truncate(s.index, s.cur)
            self._reap(s)

    # -- scheduling --------------------------------------------------------------

    def step(self) -> None:
        """One scheduling quantum: readmit page-pressure victims while their
        pages through the next write fit, admit queued requests into free
        slots while their pages fit (FIFO, no overtaking), else run one
        decode tick."""
        progressed = False
        if self.paged:
            # Gate on cur + 1: the next tick writes at position cur, so a
            # page-aligned cur needs one more page than the snapshot holds.
            while self._preempted and any(s.free for s in self.slots):
                if self.kv.pages_for(self._preempted[0].cur + 1) > self.kv.free_pages:
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
        if self.paged:
            caches = self.kv.gather(slot.index, slot.cur)
            n_pages = self.kv.pages_for(slot.cur)
            self.kv.release(slot.index)
        else:
            caches = gather_slot_state(self.caches, slot.index)
            n_pages = 0
        ev = EvictedRequest(uid=uid, caches=caches, cur=slot.cur, pending=slot.pending,
                            emitted=list(slot.emitted), max_new=slot.max_new,
                            n_pages=n_pages, seq=slot.seq, prompt=slot.prompt,
                            evictions=slot.evictions + 1)
        slot.uid = None
        slot.emitted = []
        slot.prompt = None
        return ev

    def readmit(self, ev: EvictedRequest) -> int:
        """Write an evicted request back into any free slot; its positions
        are kept, so decode resumes where it stopped.  Paged: pages through
        the next write (``cur + 1``) are allocated first; ``RuntimeError``
        when the pool is short.  Returns the slot index."""
        slot = next((s for s in self.slots if s.free), None)
        if slot is None:
            raise RuntimeError("no free slot to readmit into")
        if self.paged:
            if not self.kv.alloc(slot.index, ev.cur + 1):
                raise RuntimeError(
                    f"not enough free pages to readmit uid {ev.uid} (need "
                    f"{self.kv.pages_for(ev.cur + 1)}, free {self.kv.free_pages})")
            # The reference re-maps a registered prompt prefix here first
            # (prefix sharing, ROADMAP A3); without it every page is scattered.
            self.kv.scatter(slot.index, ev.caches, ev.cur, start_page=0)
        else:
            scatter_slot_state(self.caches, ev.caches, slot.index)
        slot.uid = ev.uid
        slot.cur = ev.cur
        slot.pending = ev.pending
        slot.emitted = list(ev.emitted)
        slot.max_new = ev.max_new
        slot.prompt = ev.prompt
        slot.evictions = ev.evictions
        # The original admission order: a fresh seq would make every
        # readmitted request the youngest, the next victim (thrash).
        slot.seq = ev.seq
        self.peak_active = max(self.peak_active, len(self.active_slots))
        return slot.index
