"""Attention layer of the serving slice: projections, qk-norm, rope, and the
two paged branches of the reference ``attention_apply``.

* **Paged decode** (reference ``attention.py:522-582``): write this step's
  K/V into the pool through the page table, then attend positions
  ``<= cur_len`` — which includes the token just written — with the paged
  decode kernel.
* **Fused prefill -> page write** (reference ``attention.py:608-680``):
  write the chunk's K/V into the pool through the page table, gather the
  context back through the table, slice it to ``q_offset + s`` positions
  and attend with the prefill kernel.

The pools are updated in place (the reference returns new arrays); the
caller's cache dict is returned for symmetry.  Positions past a row's page
table go to trash block 0.  Full-precision pools only.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers

Params = dict


def attention_init(
    gen: torch.Generator,
    *,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    dtype,
    qk_norm: bool = False,
) -> Params:
    p: Params = {
        "wq": layers.dense_init(gen, (d_model, n_heads * head_dim), dtype),
        "wk": layers.dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wv": layers.dense_init(gen, (d_model, n_kv_heads * head_dim), dtype),
        "wo": layers.dense_init(gen, (n_heads * head_dim, d_model), dtype),
    }
    if qk_norm:
        p["q_norm"] = layers.rmsnorm_init(head_dim, dtype, gen.device)
        p["k_norm"] = layers.rmsnorm_init(head_dim, dtype, gen.device)
    return p


def _paged_write(pool: torch.Tensor, rows: torch.Tensor, page: torch.Tensor,
                 off: torch.Tensor) -> None:
    """pool[page, off] = rows, in place (page/off broadcast to rows' lead)."""
    pool[page, off] = rows.to(pool.dtype)


def attention_apply(
    p: Params,
    x: torch.Tensor,  # (B, S, D)
    *,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    positions: torch.Tensor | None = None,  # (S,) or (B, S); None = no rope
    rope_theta: float = 1e4,
    causal: bool = True,
    window: int = 0,
    softcap_val: float = 0.0,
    scale: float | None = None,
    qk_norm: bool = False,
    cache: dict | None = None,  # {"k", "v"}: (num_blocks, bs, hkv, hd) pools
    cur_len: torch.Tensor | None = None,  # decode: (B,) int32 positions
    q_offset: int = 0,  # prefill: absolute position of the chunk's first token
    page_table: torch.Tensor | None = None,  # (B, n_pages) int32
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output (B, S, D), the cache, updated in place)."""
    if cache is None or page_table is None:
        raise NotImplementedError(
            "attention without a paged pool (the contiguous cache path) is not "
            "ported yet: ROADMAP A2/A4, the contiguous path")
    b, s, _ = x.shape
    q = (x @ p["wq"]).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"]).reshape(b, s, n_kv_heads, head_dim)
    v = (x @ p["wv"]).reshape(b, s, n_kv_heads, head_dim)
    if qk_norm:
        q = layers.rmsnorm(p["q_norm"], q)
        k = layers.rmsnorm(p["k_norm"], k)
    if positions is not None:
        sin, cos = layers.rope_angles(positions, head_dim, rope_theta)
        if positions.dim() == 1:  # shared positions: add the batch axis
            sin, cos = sin[None], cos[None]
        q = layers.apply_rope(q, sin, cos)
        k = layers.apply_rope(k, sin, cos)

    k_pool, v_pool = cache["k"], cache["v"]
    bs = k_pool.shape[1]
    n_pages = page_table.shape[1]
    if cur_len is not None:
        if s != 1:
            raise NotImplementedError(
                "multi-token paged decode belongs to speculative decode: "
                "ROADMAP A5 (kernel row 2)")
        # Write before read: this step's K/V land at position cur_len (trash
        # block 0 past the table), then attention covers pos <= cur_len.
        pos = cur_len.long()
        idx = pos // bs
        page = torch.where(
            idx < n_pages,
            page_table.gather(1, idx.clamp(max=n_pages - 1)[:, None])[:, 0].long(),
            torch.zeros_like(idx))
        off = pos % bs
        _paged_write(k_pool, k[:, 0], page, off)
        _paged_write(v_pool, v[:, 0], page, off)
        out = ops.paged_attention(
            q[:, 0].contiguous(), k_pool, v_pool, page_table, cur_len,
            window=window, softcap=softcap_val, scale=scale)[:, None]
    else:
        ctx_len = q_offset + s
        if n_pages * bs < ctx_len:
            raise ValueError(
                f"fused prefill needs pages for the full context: {n_pages} "
                f"pages x {bs} < {ctx_len}")
        pos = torch.arange(q_offset, ctx_len, device=x.device)
        page = page_table[:, (pos // bs).clamp(max=n_pages - 1)].long()  # (B, S)
        off = pos % bs  # (S,), broadcast against page
        _paged_write(k_pool, k, page, off)
        _paged_write(v_pool, v, page, off)
        pt = page_table.long()
        k_ctx = k_pool[pt].reshape(b, n_pages * bs, n_kv_heads, head_dim)
        v_ctx = v_pool[pt].reshape(b, n_pages * bs, n_kv_heads, head_dim)
        out = ops.flash_attention(
            q.contiguous(), k_ctx[:, :ctx_len].contiguous(),
            v_ctx[:, :ctx_len].contiguous(), causal=causal, window=window,
            softcap=softcap_val, scale=scale, q_offset=q_offset)
    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"], cache
