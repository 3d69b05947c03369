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
from repro_torch.kernels import ssd_chunk as _ssd


def _scale(q: torch.Tensor, scale: float | None) -> float:
    return scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])


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
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=_scale(q, scale), q_offset=q_offset)


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
    return _pa.paged_attention(q, k_pool, v_pool, page_table, cur_len,
                               window=window, softcap=softcap, scale=_scale(q, scale))


def paged_attention_multi(
    q: torch.Tensor,  # (B, T, H, hd): T-token draft block per row
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    cur_len: torch.Tensor,  # (B,) int32: position of token 0 per row
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """``q_len > 1`` paged decode (speculative verify): query t of row b
    sees pool positions ``<= cur_len[b] + t``, causal within the block."""
    return _pa.paged_attention_multi(q, k_pool, v_pool, page_table, cur_len,
                                     window=window, softcap=softcap, scale=_scale(q, scale))


def paged_attention_quant(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd) int8 / fp8 codes
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (num_blocks, Hkv) f32 per-page, per-kv-head scales
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention over a quantized pool, dequantized (``code *
    scale``) as each page is read."""
    return _pa.paged_attention_quant(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                     cur_len, window=window, softcap=softcap,
                                     scale=_scale(q, scale))


def paged_attention_multi_quant(
    q: torch.Tensor,  # (B, T, H, hd)
    k_pool: torch.Tensor,  # int8 / fp8 codes
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (num_blocks, Hkv) f32
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    cur_len: torch.Tensor,  # (B,) int32: position of token 0 per row
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """The quantized twin of :func:`paged_attention_multi`."""
    return _pa.paged_attention_multi_quant(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                           cur_len, window=window, softcap=softcap,
                                           scale=_scale(q, scale))


def ssd(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32, positive
    a: torch.Tensor,  # (H,) f32, negative
    b_: torch.Tensor,  # (B, S, N)
    c_: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
) -> torch.Tensor:
    """Mamba2 SSD scan from a zero state -> y (B, S, H, P) in x's type (the
    reference's ``ops.ssd``; any S, where the TPU kernel needs S % chunk ==
    0)."""
    return _ssd.ssd_chunked(x, dt, a, b_, c_, chunk=chunk)[0]
