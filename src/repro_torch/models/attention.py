"""Attention layer of the serving slice: projections, qk-norm, rope, and the
two paged branches of the reference ``attention_apply``.

* **Paged decode** (reference ``attention.py:522-582``): write this step's
  ``s >= 1`` tokens' K/V into the pool through the page table at positions
  ``cur_len .. cur_len + s - 1``, then attend with the paged kernel: token
  t sees positions ``<= cur_len + t``, which includes itself.  ``s > 1`` is
  the speculative verify step (a pending token plus its draft).
* **Fused prefill -> page write** (reference ``attention.py:608-680``):
  write the chunk's K/V into the pool through the page table, gather the
  context back through the table, slice it to ``q_offset + s`` positions
  and attend with the prefill kernel.

Quantized pools (the cache carries ``k_scale``/``v_scale``) store int8 or
fp8 codes with one f32 scale per (page, kv head): decode writes rescale
the page on grow (:func:`_quant_paged_write`), prefill writes quantize
page by page, decode reads dequantize inside the paged kernel, and prefill
reads the context dequantized by torch ops into the prefill kernel.

The pools are updated in place (the reference returns new arrays); the
caller's cache dict is returned for symmetry.  Positions past a row's page
table go to trash block 0.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels import quant
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
    """pool[page, off] = rows, in place (page/off broadcast to rows' lead).
    Two rows meet at one (page, off) only in trash block 0, whose contents
    are unspecified."""
    pool[page, off] = rows.to(pool.dtype)


def _quant_paged_write(
    pool: torch.Tensor,  # (num_blocks, bs, hkv, hd) codes, written in place
    scale_pool: torch.Tensor,  # (num_blocks, hkv) f32 scales, written in place
    rows: torch.Tensor,  # (B, S, hkv, hd) new full-precision rows
    page: torch.Tensor,  # (B, S) physical block per row position
    off: torch.Tensor,  # (B, S) in-page offset per row position
    kv_dtype: str,
) -> None:
    """Decode write into quantized pages with rescale-on-grow (reference
    ``attention._quant_paged_write``).

    A written row may exceed its page's scale, so the page's scale grows
    to cover it (max of the old one and the row's absmax / QMAX) and the
    page's codes are requantized at the new scale (an identity when the
    scale does not change).  A page written from offset 0 is fresh: the
    scale its previous owner left is ignored.  Positions are written one
    after another, so two draft rows landing on one page compose.  With
    duplicate pages in one step — which only trash block 0 can have —
    ``pool[pg] = codes`` keeps one of the writers, which one unspecified;
    the trash page's contents are never read unmasked, so any finite
    garbage is fine there.
    """
    b, s = page.shape
    bidx = torch.arange(b, device=pool.device)
    for t in range(s):
        pg, ot = page[:, t], off[:, t]
        row = rows[:, t].float()  # (B, hkv, hd)
        old_s = scale_pool[pg]  # (B, hkv)
        old_eff = torch.where(ot[:, None] == 0, torch.zeros_like(old_s), old_s)
        new_s = torch.maximum(old_eff, row.abs().amax(dim=-1) / quant.qmax(kv_dtype))
        merged = quant.dequantize(pool[pg], old_eff)  # (B, bs, hkv, hd)
        merged[bidx, ot] = row
        pool[pg] = quant.quantize(merged, new_s, kv_dtype)
        scale_pool[pg] = new_s


def _quant_prefill_write(
    pool: torch.Tensor,  # (num_blocks, bs, hkv, hd) codes, written in place
    scale_pool: torch.Tensor,  # (num_blocks, hkv) f32, written in place
    rows: torch.Tensor,  # (B, S, hkv, hd) the chunk's rows, positions q_offset..
    page_table: torch.Tensor,  # (B, n_pages) int32
    q_offset: int,
    kv_dtype: str,
) -> None:
    """Prefill write into quantized pages, one logical page at a time
    (reference ``attention.py:628-661``).  A page the chunk starts at
    offset 0 is fresh (prefill appends from a page-aligned start), so its
    stale scale is ignored; only the chunk's first page can start mid-page,
    partly filled by the previous chunk, and merges by rescale-on-grow as
    the decode write does."""
    bs = pool.shape[1]
    n_pages = page_table.shape[1]
    s = rows.shape[1]
    first = min(q_offset // bs, n_pages - 1)
    last = min((q_offset + s - 1) // bs, n_pages - 1)
    for li in range(first, last + 1):
        lo = max(0, li * bs - q_offset)
        hi = min(s, (li + 1) * bs - q_offset)
        off_lo = (q_offset + lo) % bs
        pg = page_table[:, li].long()  # (B,)
        part = rows[:, lo:hi].float()
        old_s = scale_pool[pg]  # (B, hkv)
        old_eff = torch.zeros_like(old_s) if off_lo == 0 else old_s
        new_s = torch.maximum(old_eff, quant.scales_of(part, kv_dtype))
        merged = quant.dequantize(pool[pg], old_eff)
        merged[:, off_lo: off_lo + part.shape[1]] = part
        pool[pg] = quant.quantize(merged, new_s, kv_dtype)
        scale_pool[pg] = new_s


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
    cache: dict | None = None,  # {"k", "v"[, "k_scale", "v_scale"]} pools
    cur_len: torch.Tensor | None = None,  # decode: (B,) int32 position of token 0
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
    quantized = "k_scale" in cache
    kv_dtype = quant.kv_dtype_of(k_pool) if quantized else None
    bs = k_pool.shape[1]
    n_pages = page_table.shape[1]
    if cur_len is not None:
        # Write before read: token t's K/V land at position cur_len + t
        # (trash block 0 past the table), then token t attends positions
        # <= cur_len + t.
        pos = cur_len.long()[:, None] + torch.arange(s, device=x.device)[None, :]  # (B, S)
        idx = pos // bs
        page = torch.where(
            idx < n_pages,
            page_table.gather(1, idx.clamp(max=n_pages - 1)).long(),
            torch.zeros_like(idx))
        off = pos % bs
        kw = dict(window=window, softcap=softcap_val, scale=scale)
        if quantized:
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            _quant_paged_write(k_pool, k_scale, k, page, off, kv_dtype)
            _quant_paged_write(v_pool, v_scale, v, page, off, kv_dtype)
            if s == 1:
                out = ops.paged_attention_quant(
                    q[:, 0].contiguous(), k_pool, v_pool, k_scale, v_scale, page_table,
                    cur_len, **kw)[:, None]
            else:
                out = ops.paged_attention_multi_quant(
                    q.contiguous(), k_pool, v_pool, k_scale, v_scale, page_table, cur_len,
                    **kw)
        else:
            _paged_write(k_pool, k, page, off)
            _paged_write(v_pool, v, page, off)
            if s == 1:
                out = ops.paged_attention(q[:, 0].contiguous(), k_pool, v_pool, page_table,
                                          cur_len, **kw)[:, None]
            else:
                out = ops.paged_attention_multi(q.contiguous(), k_pool, v_pool, page_table,
                                                cur_len, **kw)
    else:
        ctx_len = q_offset + s
        if n_pages * bs < ctx_len:
            raise ValueError(
                f"fused prefill needs pages for the full context: {n_pages} "
                f"pages x {bs} < {ctx_len}")
        pt = page_table.long()
        if quantized:
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            _quant_prefill_write(k_pool, k_scale, k, page_table, q_offset, kv_dtype)
            _quant_prefill_write(v_pool, v_scale, v, page_table, q_offset, kv_dtype)
            # The context is read dequantized, in q's type, by torch ops.
            k_ctx = quant.dequantize(k_pool[pt], k_scale[pt]).to(q.dtype)
            v_ctx = quant.dequantize(v_pool[pt], v_scale[pt]).to(q.dtype)
        else:
            pos = torch.arange(q_offset, ctx_len, device=x.device)
            page = page_table[:, (pos // bs).clamp(max=n_pages - 1)].long()  # (B, S)
            off = pos % bs  # (S,), broadcast against page
            _paged_write(k_pool, k, page, off)
            _paged_write(v_pool, v, page, off)
            k_ctx, v_ctx = k_pool[pt], v_pool[pt]
        k_ctx = k_ctx.reshape(b, n_pages * bs, n_kv_heads, head_dim)
        v_ctx = v_ctx.reshape(b, n_pages * bs, n_kv_heads, head_dim)
        out = ops.flash_attention(
            q.contiguous(), k_ctx[:, :ctx_len].contiguous(),
            v_ctx[:, :ctx_len].contiguous(), causal=causal, window=window,
            softcap=softcap_val, scale=scale, q_offset=q_offset)
    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"], cache
