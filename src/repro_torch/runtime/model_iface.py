"""The servable model behind ``StreamedBatchEngine`` (reference
``runtime/model_iface.py``): the decoder-only transformer over a paged
pool.  It owns the model-specific half of serving — the pool layout, the
fused prefill chunk, the greedy decode step and the speculative verify
step — so the engine never calls the transformer directly.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.runtime import spec
from repro_torch.runtime.kv_cache import PagedKVCache


class TransformerServable:
    def __init__(self, cfg: ModelConfig, params: dict, scfg, *, device):
        T.check_supported(cfg)
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = device
        # One f32 output matrix for every step (a copy only for bf16 params).
        self.unembed = T.unembed_f32(cfg, params)

    def make_kv_pool(self) -> PagedKVCache:
        s = self.scfg
        return PagedKVCache(self.cfg, max_batch=s.max_batch, max_seq=s.max_seq,
                            block_size=s.block_size, num_blocks=s.num_blocks,
                            kv_dtype=s.kv_dtype, device=self.device)

    def chunk_fn(self) -> Callable:
        """``fn(pools, page_table, tokens, pos0) -> (logits (1, 1, V),
        pools)``: one prompt chunk written straight into the pool through
        ``page_table`` (the pages covering the context so far)."""
        cfg, params, unembed = self.cfg, self.params, self.unembed

        @torch.inference_mode()
        def fn(pools, page_table, tokens, pos0):
            return T.prefill_chunk_paged(cfg, params, tokens, pools, page_table,
                                         pos0, unembed=unembed)
        return fn

    def decode_fn(self) -> Callable:
        """``fn(tokens (B, 1), pools, page_table, cur_len) -> (picks (B,)
        int32 on the device, pools)``: the batched greedy decode step; the
        tick fetches only ``picks``."""
        cfg, params, unembed = self.cfg, self.params, self.unembed

        @torch.inference_mode()
        def fn(tokens, pools, page_table, cur_len):
            return T.decode_and_sample_paged(cfg, params, tokens, pools, page_table,
                                             cur_len, unembed=unembed)
        return fn

    def verify_fn(self) -> Callable:
        """``fn(toks (B, T), pools, page_table, cur, d_len) -> (emit (B, T)
        int32, n_accept (B,) int32, pools)``: the greedy speculative verify
        step on the device; the tick fetches only ``emit`` and
        ``n_accept``."""
        return spec.make_verifier(self.cfg, self.params, unembed=self.unembed)
