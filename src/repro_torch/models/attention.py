"""Attention layer of the serving slice: projections, qk-norm, rope, and
the cache branches of the reference ``attention_apply``.

* **Paged decode** (reference ``attention.py:522-582``): write this step's
  ``s >= 1`` tokens' K/V into the pool through the page table at positions
  ``cur_len .. cur_len + s - 1``, then attend with the paged kernel: token
  t sees positions ``<= cur_len + t``, which includes itself.  ``s > 1`` is
  the speculative verify step (a pending token plus its draft).
* **Contiguous decode** (reference ``attention.py:583-607``): write row i's
  ``s`` tokens at ``cur_len[i] + t`` of its contiguous ``(B, S, Hkv, hd)``
  cache (mod the window for an SWA ring; positions at or past ``S`` are
  dropped), then attend with :func:`decode_attention` (torch ops, as the
  reference's is jnp).
* **Fused prefill -> page write** (reference ``attention.py:608-680``):
  write the chunk's K/V into the pool through the page table, gather the
  context back through the table, slice it to ``q_offset + s`` positions
  and attend with the prefill kernel.
* **Streamed-prefill continuation** (reference ``attention.py:681-698``):
  write the chunk at ``q_offset`` of a contiguous cache, then attend over
  its first ``q_offset + s`` rows with the prefill kernel.
* **First chunk / no cache** (reference ``attention.py:699-716``): attend
  over the chunk's own K/V with the prefill kernel (through :func:`flash`:
  training's path), then (with a cache)
  store them; an SWA ring shorter than the chunk keeps the last
  ``window`` rows, rolled so position p lands in slot p % window.

Quantized pools (the cache carries ``k_scale``/``v_scale``) store int8 or
fp8 codes with one f32 scale per (page, kv head): decode writes rescale
the page on grow (:func:`_quant_paged_write`), prefill writes quantize
page by page, decode reads dequantize inside the paged kernel, and prefill
reads the context dequantized by torch ops into the prefill kernel.

Training (no cache, gradients wanted) reaches the prefill kernel through
:class:`FlashAttention`, an ``autograd.Function`` (the reference's flash
custom VJP, ``attention.py:118-309``): its forward is the kernel (the plain
version on the CPU) and returns the output with each row's logsumexp; its
backward, :func:`flash_backward`, is the twin of the reference's jnp
``_flash_bwd``: P recomputed per (q-chunk, k-chunk) pair from the lse, in
torch ops (the reference has no backward kernel either).  :func:`flash`
picks the Function only when a gradient is wanted, so serving launches
the kernel with a null lse, as before.

Every prefill branch passes ``causal`` and ``prefix_len`` (paligemma's
bidirectional image prefix) to the prefill kernel; ``causal=False`` is the
encoder's self-attention.  Caches are updated in place (the reference
returns new arrays); the caller's cache dict is returned for symmetry.
Positions past a row's page table go to trash block 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import quant
from repro_torch.models import layers

Params = dict
NEG_INF = -1e30  # the reference's mask value (a finite -inf keeps softmax NaN-free)


# ----------------------------------------------------------------------------
# Training: the prefill kernel with a backward
# ----------------------------------------------------------------------------


def _pick_chunk(s: int, chunk: int, *, at_least: int = 0) -> int:
    """Largest block size <= chunk dividing s (and >= the prefix if any):
    the reference's ``_pick_chunk``."""
    for c in range(min(chunk, s), 0, -1):
        if s % c == 0 and (at_least == 0 or c >= at_least):
            return c
    for c in range(max(1, at_least), s + 1):
        if s % c == 0:
            return c
    return s


def _visible(qpos, kpos, *, causal: bool, window: int, prefix_len: int):
    """Which keys each query sees, from query positions ``qpos`` (n, 1) and
    key positions ``kpos`` (1, m), numpy or torch integers alike: (n, m)
    booleans, or None where every key is seen."""
    m = None
    if causal:
        m = qpos >= kpos
        if prefix_len > 0:
            m = m | (kpos < prefix_len)
    if window > 0:
        w = qpos - kpos < window
        m = w if m is None else m & w
    return m


def _block_pairs(n_q: int, n_k: int, *, causal: bool, window: int, chunk_q: int,
                 chunk_k: int, q_offset: int = 0, prefix_len: int = 0
                 ) -> list[tuple[int, int, bool]]:
    """The (q-chunk, k-chunk) pairs that hold a visible entry (the
    reference's ``_block_pairs``), decided on the host, each with whether
    every entry of the pair is visible."""
    out = []
    oq, ok_ = np.arange(chunk_q)[:, None], np.arange(chunk_k)[None, :]
    for qi in range(n_q):
        for kj in range(n_k):
            q_lo = qi * chunk_q + q_offset
            q_hi = q_lo + chunk_q - 1
            k_lo = kj * chunk_k
            k_hi = k_lo + chunk_k - 1
            if causal and k_lo > q_hi and not (prefix_len > 0 and k_lo < prefix_len):
                continue
            if window > 0 and q_lo - k_hi >= window:
                continue
            m = _visible(q_lo + oq, k_lo + ok_, causal=causal, window=window,
                         prefix_len=prefix_len)
            if m is None or m.any():
                out.append((qi, kj, m is None or bool(m.all())))
    return out


def flash_backward(q, k, v, out, lse, dout, *, chunk: int, causal: bool, window: int,
                   softcap: float, scale: float, q_offset: int, prefix_len: int):
    """dq, dk, dv of the masked attention whose forward gave ``out`` and
    ``lse`` (B, Sq, H) f32: the reference's ``_flash_bwd`` in torch ops.
    Per (q-chunk, k-chunk) pair with a visible entry, P = exp(s - lse) is
    recomputed (zero where masked), ``dv += P^T dout`` with P rounded to
    v's type, ``dS = P (dout v^T - delta)`` with delta = rowsum(dout *
    out), times the softcap's derivative and the scale, rounded to q's
    type for ``dq += dS k`` and ``dk += dS^T q``; products of the inputs'
    types summed in f32, as the reference's ``preferred_element_type``.
    K/V are read per query head (kv head ``h // g``) and dk/dv summed over
    each group at the end, in f32."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    chunk_q = _pick_chunk(sq, chunk, at_least=prefix_len)
    chunk_k = _pick_chunk(sk, chunk)
    pairs = _block_pairs(sq // chunk_q, sk // chunk_k, causal=causal, window=window,
                         chunk_q=chunk_q, chunk_k=chunk_k, q_offset=q_offset,
                         prefix_len=prefix_len)
    # a partly visible pair's mask is built on the card (a host mask's copy
    # would wait for the stream)
    oq = torch.arange(chunk_q, device=q.device)[:, None]
    ok_ = torch.arange(chunk_k, device=q.device)[None, :]
    f32 = torch.float32
    kf = k.repeat_interleave(g, dim=2).float()  # (B, Sk, H, hd): head h reads kv head h // g
    vf = v.repeat_interleave(g, dim=2).float()
    qf, dof = q.float(), dout.to(q.dtype).float()
    delta = (dof * out.float()).sum(-1)  # (B, Sq, H)
    dq = torch.zeros((b, sq, h, hd), dtype=f32, device=q.device)
    dk = torch.zeros((b, sk, h, hd), dtype=f32, device=q.device)
    dv = torch.zeros((b, sk, h, hd), dtype=f32, device=q.device)
    for qi, kj, full in pairs:
        qs = slice(qi * chunk_q, (qi + 1) * chunk_q)
        ks = slice(kj * chunk_k, (kj + 1) * chunk_k)
        qc, kc, vc, do = qf[:, qs], kf[:, ks], vf[:, ks], dof[:, qs]
        s_cap = layers.softcap(torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale, softcap)
        p = torch.exp(s_cap - lse[:, qs].permute(0, 2, 1)[..., None])
        if not full:
            mask = _visible(oq + (qs.start + q_offset), ok_ + ks.start, causal=causal,
                            window=window, prefix_len=prefix_len)
            p = torch.where(mask, p, 0.0)
        dv[:, ks] += torch.einsum("bhqk,bqhd->bkhd", p.to(v.dtype).float(), do)
        dp = torch.einsum("bqhd,bkhd->bhqk", do, vc)
        ds = p * (dp - delta[:, qs].permute(0, 2, 1)[..., None])
        if softcap > 0.0:
            ds = ds * (1.0 - torch.square(s_cap / softcap))
        ds = (ds * scale).to(q.dtype).float()
        dq[:, qs] += torch.einsum("bhqk,bkhd->bqhd", ds, kc)
        dk[:, ks] += torch.einsum("bhqk,bqhd->bkhd", ds, qc)
    dk = dk.reshape(b, sk, hkv, g, hd).sum(3)
    dv = dv.reshape(b, sk, hkv, g, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """The prefill kernel with a backward: forward through
    ``ops.flash_attention_lse`` (the CUDA kernel on the card, the plain
    version on the CPU), returning the output and each row's lse (no
    gradient flows into the lse); it saves q, k, v, out and lse, and its
    backward is :func:`flash_backward` at ``chunk``."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, causal, window, softcap, scale, q_offset, prefix_len):
        scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
        out, lse = ops.flash_attention_lse(q, k, v, causal=causal, window=window,
                                           softcap=softcap, scale=scale, q_offset=q_offset,
                                           prefix_len=prefix_len)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(chunk=chunk, causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset, prefix_len=prefix_len)
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None, None, None


def flash(q, k, v, *, chunk: int = 512, causal: bool = True, window: int = 0,
          softcap: float = 0.0, scale: float | None = None, q_offset: int = 0,
          prefix_len: int = 0) -> torch.Tensor:
    """The prefill kernel's output, through :class:`FlashAttention` when a
    gradient is wanted (grad mode on and an input that requires one), else
    through ``ops.flash_attention`` (serving: no lse written)."""
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, chunk, causal, window, softcap, scale,
                                    q_offset, prefix_len)[0]
    return ops.flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                               scale=scale, q_offset=q_offset, prefix_len=prefix_len)


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
    prefix_len: int = 0,  # keys below it are seen by every query (prefix-LM)
    softcap_val: float = 0.0,
    scale: float | None = None,
    qk_norm: bool = False,
    chunk: int = 512,  # the backward's (q-chunk, k-chunk) block size (training)
    # {"k", "v"[, "k_scale", "v_scale"]}: page pools with a page_table, else a
    # contiguous (B, S_cache, Hkv, hd) cache
    cache: dict | None = None,
    cur_len: torch.Tensor | None = None,  # decode: (B,) int32 position of token 0
    q_offset: int = 0,  # prefill: absolute position of the chunk's first token
    page_table: torch.Tensor | None = None,  # (B, n_pages) int32
) -> tuple[torch.Tensor, dict | None]:
    """Returns (output (B, S, D), the cache, updated in place)."""
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

    if cache is not None and page_table is not None:
        out = _paged_attend(q, k, v, cache, page_table, cur_len=cur_len, q_offset=q_offset,
                            causal=causal, window=window, prefix_len=prefix_len,
                            softcap_val=softcap_val, scale=scale)
    elif cache is not None and cur_len is not None:
        # Contiguous decode: write, then attend (ring-buffered if SWA).
        k_cache, v_cache = cache["k"], cache["v"]
        ring = window > 0 and k_cache.shape[1] == window
        cl = cur_len.long()
        _contiguous_write(k_cache, k, cl, ring)
        _contiguous_write(v_cache, v, cl, ring)
        out = decode_attention(q, k_cache, v_cache, cur_len=cl, window=window,
                               softcap_val=softcap_val, scale=scale)
    elif cache is not None and q_offset > 0:
        # Streamed-prefill continuation: the chunk's K/V at the static
        # offset, then attention over the whole context so far.
        k_cache, v_cache = cache["k"], cache["v"]
        ctx_len = q_offset + s
        if k_cache.shape[1] < ctx_len:
            raise ValueError(
                f"streamed prefill needs a full cache: {k_cache.shape[1]} rows < {ctx_len}")
        k_cache[:, q_offset:ctx_len] = k.to(k_cache.dtype)
        v_cache[:, q_offset:ctx_len] = v.to(v_cache.dtype)
        out = ops.flash_attention(
            q.contiguous(), k_cache[:, :ctx_len].contiguous(),
            v_cache[:, :ctx_len].contiguous(), causal=causal, window=window,
            softcap=softcap_val, scale=scale, q_offset=q_offset, prefix_len=prefix_len)
    else:
        # First chunk (or no cache): attend over the chunk itself, then store
        # the rope'd K/V; a ring shorter than the chunk keeps the last rows,
        # rolled so that position p lands in slot p % s_cache.
        out = flash(q, k, v, chunk=chunk, causal=causal, window=window, softcap=softcap_val,
                    scale=scale, prefix_len=prefix_len)
        if cache is not None:
            s_cache = cache["k"].shape[1]
            for key, rows in (("k", k), ("v", v)):
                if s_cache < s:
                    rows = torch.roll(rows[:, -s_cache:], s % s_cache, dims=1)
                cache[key][:, : rows.shape[1]] = rows.to(cache[key].dtype)
    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"], cache


def decode_attention(
    q: torch.Tensor,  # (B, T, H, hd): T = 1 (plain decode) or a draft block
    k_cache: torch.Tensor,  # (B, S, Hkv, hd)
    v_cache: torch.Tensor,  # (B, S, Hkv, hd)
    *,
    cur_len: torch.Tensor,  # () or (B,) int: position of query 0 per row
    window: int = 0,
    softcap_val: float = 0.0,
    scale: float | None = None,
) -> torch.Tensor:
    """Decode attention against a contiguous (possibly ring-buffered) cache
    (reference ``attention.decode_attention``).  Query t of row b sits at
    position ``cur_len[b] + t`` and sees key slot p iff ``p <= cur_len[b] +
    t`` (and inside the window): causal inside the block.  With ``window >
    0 and S == window`` the cache is an SWA ring: slot p holds the newest
    position congruent to p, valid once written.  Scores, softmax and the
    P V sum run in f32; P is cast to the cache's type first, as in the
    reference.  Returns (B, T, H, hd) in q's type."""
    b, s, hkv, hd = k_cache.shape
    t, h = q.shape[1], q.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, t, hkv, g, hd).float()
    sc = torch.einsum("btkgd,bskd->bkgts", qg, k_cache.to(q.dtype).float()) * scale
    sc = layers.softcap(sc, softcap_val)
    slot = torch.arange(s, device=q.device)[None, None, :]  # (1, 1, S)
    cl = torch.as_tensor(cur_len, device=q.device).long().expand(b)
    qpos = cl[:, None, None] + torch.arange(t, device=q.device)[None, :, None]  # (B, T, 1)
    if window > 0 and s == window:
        ok = (slot <= qpos) | (qpos >= window)
    else:
        ok = slot <= qpos
        if window > 0:
            ok = ok & (qpos - slot < window)
    sc = sc.masked_fill(~ok[:, None, None], NEG_INF)  # (B, Hkv, g, T, S)
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, t, h, hd).to(q.dtype)


def _contiguous_write(cache: torch.Tensor, rows: torch.Tensor, cur_len: torch.Tensor,
                      ring: bool) -> None:
    """cache[i, cur_len[i] + t] = rows[i, t], in place (mod the cache length
    for a ring).  Positions at or past the cache length (a draft block's
    padding tail) are dropped, as the reference's ``mode="drop"``: such a
    row writes back what its clamped slot holds, one position at a time,
    so no two writes of a step meet and nothing is read back to the host."""
    b, s_cache = cache.shape[0], cache.shape[1]
    bidx = torch.arange(b, device=cache.device)
    rows = rows.to(cache.dtype)
    for t in range(rows.shape[1]):
        pos = cur_len + t
        if ring:
            cache[bidx, pos % s_cache] = rows[:, t]
            continue
        at = pos.clamp(max=s_cache - 1)
        keep = (pos < s_cache)[:, None, None]
        cache[bidx, at] = torch.where(keep, rows[:, t], cache[bidx, at])


def _paged_attend(q, k, v, cache: dict, page_table: torch.Tensor, *, cur_len, q_offset: int,
                  causal: bool, window: int, prefix_len: int, softcap_val: float,
                  scale: float | None) -> torch.Tensor:
    """The two paged branches: decode (``cur_len`` given) through the paged
    kernels, or the fused prefill chunk through the prefill kernel.  Writes
    the pools in place; returns (B, S, H, hd)."""
    b, s, n_kv_heads, head_dim = k.shape
    k_pool, v_pool = cache["k"], cache["v"]
    quantized = "k_scale" in cache
    kv_dtype = quant.kv_dtype_of(k_pool) if quantized else None
    bs = k_pool.shape[1]
    n_pages = page_table.shape[1]
    if cur_len is not None:
        # Write before read: token t's K/V land at position cur_len + t
        # (trash block 0 past the table), then token t attends positions
        # <= cur_len + t.
        pos = cur_len.long()[:, None] + torch.arange(s, device=q.device)[None, :]  # (B, S)
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
            pos = torch.arange(q_offset, ctx_len, device=q.device)
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
            softcap=softcap_val, scale=scale, q_offset=q_offset, prefix_len=prefix_len)
    return out

