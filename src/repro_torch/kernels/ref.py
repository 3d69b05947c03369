"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

They compute in float32 whatever the input type and return the query's
type, as the reference's ``kernels/ref.py`` oracles do.  The CPU path of
each kernel wrapper runs them; on the card they serve only as the yardstick
the kernels are held against.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return s if cap <= 0.0 else cap * torch.tanh(s / cap)


def paged_attention_ref(
    q: torch.Tensor,  # (B, H, hd) single-token queries (H = Hkv * g)
    k_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd)
    v_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd)
    page_table: torch.Tensor,  # (B, n_pages) int32
    cur_len: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Gather each row's pages into a contiguous view, then attention with
    the per-row cut ``pos <= cur_len`` (and the window).  Query head i
    attends kv head ``i // g``."""
    b, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    g = h // hkv
    n_pages = page_table.shape[1]
    s_log = n_pages * bs
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pt = page_table.long()
    k = k_pool[pt].reshape(b, s_log, hkv, hd).float()
    v = v_pool[pt].reshape(b, s_log, hkv, hd).float()
    qf = q.float().reshape(b, hkv, g, hd)
    s = torch.einsum("bngd,bknd->bngk", qf, k) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(s_log, device=q.device)[None, :]
    cl = cur_len.long()[:, None]
    ok = pos <= cl
    if window > 0:
        ok = ok & (cl - pos < window)
    s = s.masked_fill(~ok[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngk,bknd->bngd", p, v)
    return out.reshape(b, h, hd).to(q.dtype)


def paged_attention_multi_ref(
    q: torch.Tensor,  # (B, T, H, hd): a T-token draft block per row
    k_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd)
    v_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd)
    page_table: torch.Tensor,  # (B, n_pages) int32
    cur_len: torch.Tensor,  # (B,) int32: position of token 0 per row
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """The ``q_len > 1`` twin of :func:`paged_attention_ref`: query t of row
    b sits at position ``cur_len[b] + t`` and sees keys at positions
    ``<= cur_len[b] + t`` (causal within the block, and the window)."""
    b, t, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    g = h // hkv
    n_pages = page_table.shape[1]
    s_log = n_pages * bs
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pt = page_table.long()
    k = k_pool[pt].reshape(b, s_log, hkv, hd).float()
    v = v_pool[pt].reshape(b, s_log, hkv, hd).float()
    qf = q.float().reshape(b, t, hkv, g, hd)
    s = torch.einsum("btngd,bknd->bngtk", qf, k) * scale
    s = _softcap(s, softcap)
    pos = torch.arange(s_log, device=q.device)[None, None, :]
    qpos = cur_len.long()[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    ok = pos <= qpos  # (B, T, S)
    if window > 0:
        ok = ok & (qpos - pos < window)
    s = s.masked_fill(~ok[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngtk,bknd->btngd", p, v)
    return out.reshape(b, t, h, hd).to(q.dtype)


def _dequant_pool(pool: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(num_blocks, bs, hkv, hd) codes x (num_blocks, hkv) scales -> f32."""
    return pool.float() * scale[:, None, :, None]


def paged_attention_quant_ref(q, k_pool, v_pool, k_scale, v_scale, page_table, cur_len,
                              *, window: int = 0, softcap: float = 0.0,
                              scale: float | None = None) -> torch.Tensor:
    """Plain fused-dequant decode: dequantize the pools up front (exactly
    ``code * scale``, the value the kernel rebuilds per page), then
    :func:`paged_attention_ref`."""
    return paged_attention_ref(
        q, _dequant_pool(k_pool, k_scale), _dequant_pool(v_pool, v_scale),
        page_table, cur_len, window=window, softcap=softcap, scale=scale)


def paged_attention_multi_quant_ref(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                    cur_len, *, window: int = 0, softcap: float = 0.0,
                                    scale: float | None = None) -> torch.Tensor:
    """The ``q_len > 1`` twin of :func:`paged_attention_quant_ref`."""
    return paged_attention_multi_ref(
        q, _dequant_pool(k_pool, k_scale), _dequant_pool(v_pool, v_scale),
        page_table, cur_len, window=window, softcap=softcap, scale=scale)


def flash_attention_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Masked attention of a query chunk at absolute positions
    ``q_offset + i`` over keys at positions ``0..Sk-1`` (the semantics of
    the reference's ``flash_attention_ref`` without a prefix), GQA by
    indexing kv head ``h // g``.  Materializes the score matrix."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qf = q.float().reshape(b, sq, hkv, g, hd)
    s = torch.einsum("bqngd,bknd->bngqk", qf, k.float()) * scale
    s = _softcap(s, softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    ok = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        ok = qpos >= kpos
    if window > 0:
        ok = ok & (qpos - kpos < window)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)
