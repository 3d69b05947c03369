"""Public kernel wrappers, with the reference ``kernels/ops.py`` argument
order, layouts and ``scale`` default (1 / sqrt(head_dim)).

The device of the tensors picks the path: the CUDA kernel on the card, its
plain PyTorch version on the CPU.  There is no switch to turn a kernel off.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """GQA attention of a query chunk at positions ``q_offset + i`` over
    keys ``0..Sk-1``; kv head ``h // g`` is indexed, never broadcast."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale, q_offset=q_offset)


def paged_attention(
    q: torch.Tensor,  # (B, H, hd) single-token queries
    k_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pages) int32
    cur_len: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention straight from the paged pool: each row attends its
    pages' positions ``<= cur_len``."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _pa.paged_attention(q, k_pool, v_pool, page_table, cur_len,
                               window=window, softcap=softcap, scale=scale)
