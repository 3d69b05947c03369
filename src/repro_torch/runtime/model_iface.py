"""The servable models behind ``StreamedBatchEngine`` (reference
``runtime/model_iface.py``).  A servable owns the architecture-specific
half of serving — the cache layout, the prefill chunks, the decode step
with its on-device pick, the speculative verify step and what is
shareable — so the engine never calls the model directly.

  ============  =====================  ===================================
  servable      prefill                decode / sharing
  ============  =====================  ===================================
  transformer   fused chunks written   one token or a draft block per
                straight into pages,   tick over the paged pool or the
                or b=1 streamed        contiguous slot cache; prefix
                chunks, then a scatter pages shared copy-on-write
  mamba         b=1 streamed chunks    one recurrence step per tick over
                over the O(1) SSM      slot state; sharing degrades to
                state, then a scatter  state snapshots at chunk boundaries
  ============  =====================  ===================================

whisper and prefix-LM configs are rejected until they are ported.

Import order: this module imports ``runtime.serving`` eagerly (for
``ServingEngine``); ``serving`` imports this module inside
``StreamedBatchEngine.__init__``, so the two never cycle at import time.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.runtime import serving, spec
from repro_torch.runtime.graphs import Graphs
from repro_torch.runtime.kv_cache import PagedKVCache, StateStore, copy_front


def arch_kind_of(cfg: ModelConfig) -> str:
    """The reference's serving taxonomy: "whisper" (encoder-decoder),
    "prefix_lm" (image prefix), "mamba" (any SSM mixer), else
    "transformer"."""
    if cfg.is_encoder_decoder:
        return "whisper"
    if cfg.prefix_len > 0:
        return "prefix_lm"
    if any(s.mixer == "mamba" for s in cfg.layer_unit):
        return "mamba"
    return "transformer"


def build_servable(cfg: ModelConfig, params: dict, scfg, *, device,
                   graphs: Graphs | None = None) -> ServableModel:
    """The servable for ``cfg``, or a clean rejection.  Stamps
    ``scfg.arch_kind`` and re-runs the arch-dependent flag validation, so a
    ``ServeConfig`` built before the model was known still fails fast."""
    kind = arch_kind_of(cfg)
    if kind in ("whisper", "prefix_lm"):
        raise NotImplementedError(
            f"{cfg.name}: serving {kind} configs is not ported yet: ROADMAP A7 "
            f"({'whisper' if kind == 'whisper' else 'paligemma'})")
    scfg.arch_kind = kind
    scfg.validate_arch()
    cls = {"transformer": TransformerServable, "mamba": MambaServable}[kind]
    return cls(cfg, params, scfg, device=device, graphs=graphs)


class ServableModel:
    """The base contract; subclasses override what their state changes."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg, *, device,
                 graphs: Graphs | None = None):
        T.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = device
        # One f32 output matrix for every step (a copy only for bf16 params).
        self.unembed = T.unembed_f32(cfg, params)
        # The b=1 prefill and the chunk-graph cache (on the engine's graphs).
        self.single = serving.ServingEngine(cfg, params, scfg, device=device,
                                            unembed=self.unembed, graphs=graphs)
        #: StateStore when the arch supports recurrent-state snapshots
        self.snapshots: StateStore | None = None

    def make_kv_pool(self) -> PagedKVCache:
        s = self.scfg
        return PagedKVCache(self.cfg, max_batch=s.max_batch, max_seq=s.max_seq,
                            block_size=s.block_size, num_blocks=s.num_blocks,
                            kv_dtype=s.kv_dtype, device=self.device,
                            jit_cache_cap=s.page_jit_cap, graphs=self.single.graphs,
                            staging=self.single.request_cache)

    def init_slot_caches(self, bsz: int) -> dict:
        """The contiguous slot cache of the batched engine: full-length
        rows (``ring=False``), since the b=1 prefill cache it receives is
        full length."""
        return T.init_cache(self.cfg, bsz, self.scfg.max_seq, ring=False,
                            device=self.device)

    def iter_prefill_chunks(self, tokens, *, caches=None, pos0: int = 0):
        """The streamed b=1 prefill of one admission (non-fused path): the
        chunk graphs over ``single.request_cache()``."""
        return self.single.iter_prefill_chunks(tokens, caches=caches, pos0=pos0)

    def decode_fn(self, *, paged: bool) -> Callable:
        """The batched decode step with its pick on the device (greedy, or
        at ``scfg.temperature`` each row from its request's stream); the
        tick fetches only its (B,) int32 picks.  Paged: ``fn(tokens (B, 1),
        pools, page_table, cur_len[, uids, steps])``; contiguous:
        ``fn(tokens, caches, cur_len[, uids, steps])``.  Both return
        (picks, caches)."""
        cfg, params, unembed = self.cfg, self.params, self.unembed
        temp = float(self.scfg.temperature)
        if paged:
            @torch.inference_mode()
            def fn(tokens, pools, page_table, cur_len, uids=None, steps=None):
                return T.decode_and_sample_paged(cfg, params, tokens, pools, page_table,
                                                 cur_len, unembed=unembed, temperature=temp,
                                                 uids=uids, steps=steps)
        else:
            @torch.inference_mode()
            def fn(tokens, caches, cur_len, uids=None, steps=None):
                return T.decode_and_sample(cfg, params, tokens, caches, cur_len,
                                           unembed=unembed, temperature=temp, uids=uids,
                                           steps=steps)
        return fn

    def lookup_snapshot(self, tokens: np.ndarray, *, into: dict | None = None
                        ) -> tuple[int, dict | None]:
        """Longest stored chunk-aligned proper-prefix state snapshot of
        ``tokens`` -> (n_tokens, device caches): copied into ``into`` (the
        request cache) when given, else a fresh device copy; (0, None) on a
        miss."""
        return 0, None

    def maybe_snapshot(self, tokens: np.ndarray, caches: dict, pos: int) -> None:
        """Offer the prefill state at absolute position ``pos`` (called once
        per dispatched chunk)."""


class TransformerServable(ServableModel):
    """Decoder-only transformer over the paged pool (fused prefill chunks,
    or a b=1 streamed prefill scattered into pages) or the contiguous slot
    cache, with speculative verify (KV writes roll back, so
    verify-and-truncate is safe)."""

    def verify_fn(self, *, paged: bool) -> Callable:
        """The speculative verify step on the device, greedy or rejection
        sampling at ``scfg.temperature`` (see ``spec.make_verifier`` for
        both forms); the tick fetches only ``emit`` and ``n_accept``."""
        return spec.make_verifier(self.cfg, self.params, paged=paged,
                                  unembed=self.unembed, temperature=self.scfg.temperature)


class MambaServable(ServableModel):
    """Pure SSM (mamba2) configs.  Per-slot state is O(1) recurrent (SSM
    state + conv tail), slot-indexed in the contiguous cache or beside the
    pages.  Page-granular prefix sharing is impossible (the state at
    position t summarizes all of [0, t)), so sharing degrades to **state
    snapshots**: admission restores the longest stored chunk-aligned proper
    prefix of the prompt and streams only the uncovered tail.  Snapshots
    are host copies, since the port updates caches in place."""

    def __init__(self, cfg: ModelConfig, params: dict, scfg, *, device,
                 graphs: Graphs | None = None):
        super().__init__(cfg, params, scfg, device=device, graphs=graphs)
        if scfg.state_snapshots:
            self.snapshots = StateStore()

    def lookup_snapshot(self, tokens: np.ndarray, *, into: dict | None = None
                        ) -> tuple[int, dict | None]:
        if self.snapshots is None:
            return 0, None
        n, snap = self.snapshots.lookup(np.asarray(tokens, np.int32),
                                        align_tokens=self.scfg.prefill_chunk)
        if not n:
            return 0, None
        if into is not None:  # the prefill continues in place on it
            copy_front(into, snap)
            return n, into
        return n, _tree_to(snap, self.device)

    def maybe_snapshot(self, tokens: np.ndarray, caches: dict, pos: int) -> None:
        if self.snapshots is None or caches is None:
            return
        # Proper chunk-aligned prefixes only: a full-prompt "prefix" can never
        # be looked up (admission needs >= 1 tail token), and an unaligned one
        # would break the chunk-grid argument.
        if 0 < pos < len(tokens) and pos % self.scfg.prefill_chunk == 0:
            self.snapshots.put(np.asarray(tokens[:pos], np.int32),
                               _tree_to(caches, torch.device("cpu")))


def _tree_to(tree: dict, device: torch.device) -> dict:
    """A copy of a cache tree on ``device`` (always a copy, even in place)."""
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device, copy=True)
            for k, v in tree.items()}
