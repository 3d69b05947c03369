"""Plain PyTorch versions of the port's kernels (the allclose ground truth):
the attention entries, the SSD chunk scan, and the paper kernels (matmul,
Walsh-Hadamard transform, Needleman-Wunsch tiles; numpy NW oracles); with
them, the plain emulations of the tensor-core bodies' arithmetic (the paged
split body, the prefill body, the 3xTF32 matmul) and the inputs on which the
paged body's precision over quantized pages shows.  The emulations serve
the tests only.

They compute in float32 whatever the input type and return the query's
type, as the reference's ``kernels/ref.py`` oracles do.  The CPU path of
each kernel wrapper runs them; on the card they serve only as the yardstick
the kernels are held against.
"""

from __future__ import annotations

import math

import numpy as np
import torch

NEG_INF = -1e30


def _wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in f32, or kept in f64 (the tests' near-exact emulations)."""
    return x if x.dtype == torch.float64 else x.float()


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
    ``<= cur_len[b] + t`` (causal within the block, and the window).  In
    f32, or in f64 for f64 inputs."""
    b, t, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    g = h // hkv
    n_pages = page_table.shape[1]
    s_log = n_pages * bs
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pt = page_table.long()
    k = _wide(k_pool[pt].reshape(b, s_log, hkv, hd))
    v = _wide(v_pool[pt].reshape(b, s_log, hkv, hd))
    qf = _wide(q).reshape(b, t, hkv, g, hd)
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


def _pv_operand(p: torch.Tensor, p_bits: str) -> torch.Tensor:
    """P as a product P V takes it: f32, rounded once to bf16, or split
    into a bf16 high part and a bf16 remainder (their sum is exact in f32)."""
    if p_bits == "f32":
        return p
    hi = p.to(torch.bfloat16).float()
    if p_bits == "bf16":
        return hi
    if p_bits == "bf16x2":
        return hi + (p - hi).to(torch.bfloat16).float()
    raise ValueError(f"p_bits must be f32, bf16 or bf16x2, got {p_bits!r}")


def paged_attention_multi_split_plain(q, k_pool, v_pool, page_table, cur_len, *,
                                      pages_per_split: int, window: int = 0,
                                      softcap: float = 0.0, scale: float | None = None,
                                      k_scale=None, v_scale=None,
                                      p_bits: str = "f32") -> torch.Tensor:
    """The split body's split-and-combine arithmetic in plain PyTorch, for
    the tests (the main path never calls it); q is (B, T, H, hd), T = 1 for
    a single-token call.  The page table is cut into splits of
    ``pages_per_split`` pages; each split keeps, per row, the max m of the
    scores it may see, l = sum exp(s - m) and acc = sum exp(s - m) v over
    those keys only (a split with none: m = NEG_INF, l = 0, acc = 0); the
    combine weighs split s by exp(m_s - max m) and divides the summed acc by
    the summed l (l == 0 -> 1).  With ``k_scale``/``v_scale`` the pools hold
    codes: K is dequantized as ``code * scale`` and each key's v scale is
    folded into P, which then meets the V codes, as in the kernel.
    ``p_bits`` is that P as P V takes it (see :func:`_pv_operand`): "f32",
    "bf16" (the kernel's tensor cores over bf16 pages) or "bf16x2" (over
    code pages).  Equal to :func:`paged_attention_multi_ref` up to rounding
    wherever every row sees some key, with ``p_bits`` "f32"; f64 inputs
    are computed in f64, as there."""
    b, t, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    g = h // hkv
    n_pages = page_table.shape[1]
    n_splits = -(-n_pages // pages_per_split)
    span = pages_per_split * bs
    s_pad = n_splits * span
    pad = s_pad - n_pages * bs  # the last split's missing pages: never seen
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pt = page_table.long()
    if k_scale is not None:
        k_pool = _dequant_pool(k_pool, k_scale)
        vs = v_scale[pt].repeat_interleave(bs, dim=1)  # (b, n_pages * bs, hkv): per key
        vs = torch.nn.functional.pad(vs, (0, 0, 0, pad)).permute(0, 2, 1)
    else:
        vs = torch.ones((b, hkv, s_pad), device=q.device)
    k = _wide(k_pool[pt].reshape(b, n_pages * bs, hkv, hd))
    v = _wide(v_pool[pt].reshape(b, n_pages * bs, hkv, hd))
    k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    qf = _wide(q).reshape(b, t, hkv, g, hd)
    s = _softcap(torch.einsum("btngd,bknd->bngtk", qf, k) * scale, softcap)
    pos = torch.arange(s_pad, device=q.device)[None, None, :]
    qpos = cur_len.long()[:, None, None] + torch.arange(t, device=q.device)[None, :, None]
    ok = (pos <= qpos) & (pos < n_pages * bs)
    if window > 0:
        ok = ok & (qpos - pos < window)
    ok = ok[:, None, None].expand_as(s).reshape(*s.shape[:-1], n_splits, span)
    s = s.reshape(ok.shape)
    m = torch.where(ok, s, torch.full_like(s, NEG_INF)).amax(-1)  # (b, n, g, t, splits)
    p = torch.where(ok, torch.exp(s - m[..., None]), torch.zeros_like(s))
    l = p.sum(-1)
    pv = _pv_operand(p * vs.reshape(b, hkv, 1, 1, n_splits, span), p_bits)
    acc = torch.einsum("bngtsk,bsknd->bngtsd", pv, v.reshape(b, n_splits, span, hkv, hd))
    w = torch.exp(m - m.amax(-1, keepdim=True))
    lsum = (w * l).sum(-1)
    out = (w[..., None] * acc).sum(-2) / torch.where(lsum == 0, 1.0, lsum)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, hd).to(q.dtype)


def cancelling_quant_case(seed: int, t: int, kv_dtype: str):
    """Inputs of the quantized entries on which the precision of P in P V
    shows, for the tests and the chip smoke (CPU tensors, from ``seed``
    with numpy), at the serving shape (B 4, H 32 / 8, hd 128, 9 pages of
    16): q (B, t, H, hd) f32 with bf16 values, int8 or fp8 (``kv_dtype``)
    K and V codes, their scales, table and lengths.

    Logical pages 2j and 2j + 1 of a row hold the same K codes under one k
    scale, so each key of one has the score of its partner in the other;
    their V codes are +96 and -32 (signs at random) under v scales s and
    3 s, so each pair's values cancel exactly, and page 8 holds V codes 0.
    Every row sees all of pages 0-7 (cur_len + t - 1 in 127..143), so the
    output is ~1e-7 while sum |p v| / l is ~2.5: rounding p v to bf16
    leaves errors of ~3e-3, P at f32 accuracy ~1e-5 or less."""
    b, hkv, g, hd, bs, n_pages = 4, 8, 4, 128, 16, 9
    rng = np.random.default_rng(seed)
    nb = 1 + b * n_pages
    q = torch.from_numpy(rng.standard_normal((b, t, hkv * g, hd)).astype(np.float32))
    pt = (rng.permutation(nb - 1)[: b * n_pages] + 1).reshape(b, n_pages).astype(np.int32)
    if kv_dtype == "int8":
        kc = rng.integers(-127, 128, (nb, bs, hkv, hd)).astype(np.float32)
        k_scale = 0.02
    else:
        normal = np.clip(64 * rng.standard_normal((nb, bs, hkv, hd)), -448, 448)
        kc = torch.from_numpy(normal.astype(np.float32)).to(torch.float8_e4m3fn).float().numpy()
        k_scale = 1 / 32
    vc = np.zeros((nb, bs, hkv, hd), np.float32)
    vs = rng.uniform(0.01, 0.03, (nb, hkv)).astype(np.float32)
    for i in range(b):
        for j in range(0, n_pages - 1, 2):
            a, c = pt[i, j], pt[i, j + 1]
            sign = rng.choice([-1.0, 1.0], size=(bs, hkv, hd))
            kc[c], vc[a], vc[c], vs[c] = kc[a], 96 * sign, -32 * sign, 3 * vs[a]
    code = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
    return (q.to(torch.bfloat16).float(), torch.from_numpy(kc).to(code),
            torch.from_numpy(vc).to(code), torch.full((nb, hkv), k_scale),
            torch.from_numpy(vs), torch.from_numpy(pt),
            torch.tensor([139, 133, 131, 127], dtype=torch.int32))


def _flash_scores(q, k, *, causal, window, softcap, scale, q_offset, prefix_len):
    """Masked, scaled (and softcapped) f32 scores (B, Hkv, g, Sq, Sk) of
    :func:`flash_attention_ref`."""
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
        ok = (qpos >= kpos) | (kpos < prefix_len)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    return s.masked_fill(~ok, NEG_INF)


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
    prefix_len: int = 0,
) -> torch.Tensor:
    """Masked attention of a query chunk at absolute positions
    ``q_offset + i`` over keys at positions ``0..Sk-1`` (the semantics of
    the reference's ``flash_attention_ref``), GQA by indexing kv head
    ``h // g``.  Causal: key j is seen by query i when ``j <= q_offset +
    i``, or when ``j < prefix_len`` (a bidirectional prefix, prefix-LM).
    Materializes the score matrix."""
    b, sq, h, hd = q.shape
    s = _flash_scores(q, k, causal=causal, window=window, softcap=softcap, scale=scale,
                      q_offset=q_offset, prefix_len=prefix_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_attention_lse_ref(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
    q_offset: int = 0,
    prefix_len: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention_ref`'s output and the natural-log logsumexp
    of each row's masked scores, (B, Sq, H) f32: the ``lse`` the
    reference's ``_flash_fwd_impl`` returns for its backward (a row that
    sees no key gets about NEG_INF, finite)."""
    b, sq, h, hd = q.shape
    s = _flash_scores(q, k, causal=causal, window=window, softcap=softcap, scale=scale,
                      q_offset=q_offset, prefix_len=prefix_len)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngqk,bknd->bqngd", p, v.float())
    lse = torch.logsumexp(s, dim=-1).permute(0, 3, 1, 2).reshape(b, sq, h)
    return out.reshape(b, sq, h, hd).to(q.dtype), lse


def flash_attention_tc_plain(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,  # (B, Sk, Hkv, hd)
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float | None = None,
    q_offset: int = 0,
    prefix_len: int = 0,
    key_tile: int = 16,
    key_splits: int = 1,
    contiguous: bool = False,
) -> torch.Tensor:
    """The prefill kernel's tensor-core bodies in plain PyTorch, for the
    tests (the main path never calls it): scores of the (bf16) q and k as
    exact products summed in f32, then an online softmax over key tiles of
    ``key_tile`` keys at multiples of it, P rounded to bf16 before P V per
    tile (l summed from the f32 P), f32 l and acc.  ``key_splits`` > 1: tile
    j goes to split j % key_splits (the tc body's warps: key_tile 16), or,
    ``contiguous``, to split j // ceil(tiles / key_splits) (the wgmma body's
    blocks: key_tile 128 or 64); each split keeps its own (m, l, acc) over
    its tiles in order, and the splits are combined with weights
    exp(m_s - max m) at the end.  The mask is
    :func:`flash_attention_ref`'s, ``prefix_len`` included.  Masked keys
    take no part (p = 0, not in the max); a row that sees no key gives 0.
    ``key_splits`` 1 is the reference's ``flash_attention_ref`` at chunk =
    ``key_tile`` up to f32 sums in another order."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    n_tiles = -(-sk // key_tile)
    pad = n_tiles * key_tile - sk
    qf = q.float().reshape(b, sq, hkv, g, hd)
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    s = _softcap(torch.einsum("bqngd,bknd->bngqk", qf, kf) * scale, softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(n_tiles * key_tile, device=q.device)[None, :]
    ok = kpos < sk
    if causal:
        ok = ok & ((kpos <= qpos) | (kpos < prefix_len))
    if window > 0:
        ok = ok & (qpos - kpos < window)
    ok = ok.expand(sq, -1)
    shape = s.shape[:-1]  # (b, hkv, g, sq)
    if contiguous:
        per = -(-n_tiles // key_splits)
        runs = [range(j, min(j + per, n_tiles)) for j in range(0, n_tiles, per)]
    else:
        runs = [range(split, n_tiles, key_splits) for split in range(key_splits)]
    m_s, l_s, acc_s = [], [], []
    for tiles in runs:
        m = torch.full(shape, NEG_INF, device=q.device)
        l = torch.zeros(shape, device=q.device)
        acc = torch.zeros((*shape, hd), device=q.device)
        for j in tiles:
            cols = slice(j * key_tile, (j + 1) * key_tile)
            st, okt = s[..., cols], ok[:, cols]
            m_new = torch.maximum(m, torch.where(okt, st, NEG_INF).amax(-1))
            p = torch.where(okt, torch.exp(st - m_new[..., None]), 0.0)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1)
            pv = torch.einsum("bngqk,bknd->bngqd", p.to(torch.bfloat16).float(), vf[:, cols])
            acc = alpha[..., None] * acc + pv
            m = m_new
        m_s.append(m)
        l_s.append(l)
        acc_s.append(acc)
    m_all = torch.stack(m_s)
    w = torch.exp(m_all - m_all.amax(0))
    lsum = (w * torch.stack(l_s)).sum(0)
    out = (w[..., None] * torch.stack(acc_s)).sum(0) / torch.where(lsum == 0, 1.0, lsum)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to
    the magnitude's bit pattern and clear them.  Inf and NaN stay."""
    bits = x.float().contiguous().view(torch.int32).to(torch.int64)
    finite = (bits & 0x7F800000) != 0x7F800000
    rounded = ((bits + 0x1000) & ~0x1FFF) & 0xFFFFFFFF
    rounded = torch.where(rounded >= 2**31, rounded - 2**32, rounded)
    out = torch.where(finite, rounded, bits).to(torch.int32).view(torch.float32)
    return out.reshape(x.shape)


def matmul_tf32_plain(x: torch.Tensor, y: torch.Tensor, *, products: int = 3) -> torch.Tensor:
    """The matmul kernel's tensor-core arithmetic in plain PyTorch, for the
    tests (the main path never calls it), in ``result_type(x, y)``: each
    f32 operand a split into big = tf32(a) and small = tf32(a - big) (a
    bf16 operand is exact in TF32: small = 0), and with ``products`` 3 the
    sum x_small y_big + x_big y_small + x_big y_big in f32 (3xTF32); with
    ``products`` 1 the single TF32 product x_big y_big.  The sums are f32
    matmuls, rounded: the tensor cores' truncating accumulation, which the
    kernel bounds by summing each 32-deep k stage apart, is not modelled."""
    def split(a):
        big = tf32_round(a.float()) if a.dtype == torch.float32 else a.float()
        return big, tf32_round(a.float() - big)

    (xb, xs), (yb, ys) = split(x), split(y)
    out = xb @ yb
    if products == 3:
        out = xs @ yb + xb @ ys + out
    elif products != 1:
        raise ValueError(f"products must be 1 or 3, got {products}")
    return out.to(torch.result_type(x, y))


def ssd_chunked_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) positive (softplus applied)
    a: torch.Tensor,  # (H,) negative
    b_: torch.Tensor,  # (B, S, N), one group shared by every head
    c_: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,  # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (the reference's ``models/mamba.ssd_chunked``):
    returns (y (B, S, H, P) in x's type, final state (B, H, P, N) f32).
    The chunk grid is the reference's: chunks of ``min(chunk, S)``, then one
    short tail chunk when they do not tile ``S``.  A Python loop over
    chunks takes the place of ``lax.scan``."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    chunk = min(chunk, s)
    if s % chunk:
        main = (s // chunk) * chunk
        y_head, state = ssd_chunked_ref(
            x[:, :main], dt[:, :main], a, b_[:, :main], c_[:, :main],
            chunk=chunk, init_state=init_state)
        y_tail, state = ssd_chunked_ref(
            x[:, main:], dt[:, main:], a, b_[:, main:], c_[:, main:],
            chunk=s - main, init_state=state)
        return torch.cat([y_head, y_tail], dim=1), state
    t = s // chunk
    xd = x.float() * dt.float()[..., None]  # dt-discretized input, f32
    adt = dt.float() * a.float()[None, None, :]  # (B, S, H) negative
    xc = xd.reshape(bsz, t, chunk, h, p)
    ac = adt.reshape(bsz, t, chunk, h)
    bc = b_.float().reshape(bsz, t, chunk, n)
    cc = c_.float().reshape(bsz, t, chunk, n)
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # (1, Q, Q, 1)
    ys = []
    for i in range(t):
        xq, aq, bq, cq = xc[:, i], ac[:, i], bc[:, i], cc[:, i]
        a_cs = torch.cumsum(aq, dim=1)  # (B, Q, H) cumulative log-decay
        # L[i, j] = exp(cs_i - cs_j) for i >= j, masked BEFORE the exp: the
        # upper triangle's positive log-decays would overflow.
        ldiff = a_cs[:, :, None, :] - a_cs[:, None, :, :]  # (B, Q, Q, H)
        l = torch.exp(torch.where(tri, ldiff, float("-inf")))
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        y_diag = torch.einsum("bqk,bqkh,bkhp->bqhp", scores, l, xq)
        y_off = torch.einsum("bqn,bhpn,bqh->bqhp", cq, state, torch.exp(a_cs))
        decay_to_end = torch.exp(a_cs[:, -1:, :] - a_cs)  # (B, Q, H)
        chunk_state = torch.einsum("bqn,bqh,bqhp->bhpn", bq, decay_to_end, xq)
        state = state * torch.exp(a_cs[:, -1, :])[:, :, None, None] + chunk_state
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(bsz, s, h, p)
    return y.to(x.dtype), state


def ssd_chunked_tc_plain(
    x: torch.Tensor,  # (B, S, H, P) bf16
    dt: torch.Tensor,  # (B, S, H) f32
    a: torch.Tensor,  # (H,) f32
    b_: torch.Tensor,  # (B, S, N) bf16
    c_: torch.Tensor,  # (B, S, N) bf16
    *,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,  # (B, H, P, N) f32
    split: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of the SSD tensor-core body (``csrc/ssd_chunk.cu``,
    ``ssd_tc_kernel``) on the CPU: per chunk (the reference's grid) S = C
    B^T from the bf16 inputs in f32; A_y = bf16(S_ij exp(cs_i - cs_j) dt_j)
    masked to j <= i; y = bf16(A_y x + exp(cs_i) C bf16(state)^T); and the
    state update exp(cs_last) state + (w o x)^T B with w_j = exp(cs_last -
    cs_j) dt_j, the operand w o x split into bf16 hi + lo (``split``, the
    kernel's), or rounded once to bf16 (``split=False``).  Products of bf16
    values are exact in f32, as on the tensor cores; sums are f32 in
    another order.  Returns (y in x's type, final state f32)."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    chunk = min(chunk, s)
    rb = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    xf, bf, cf = x.float(), b_.float(), c_.float()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32) if init_state is None
             else init_state.float().clone())
    ys = []
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        xq, bq, cq = xf[:, t0:t0 + q], bf[:, t0:t0 + q], cf[:, t0:t0 + q]
        dq = dt[:, t0:t0 + q].float()  # (B, Q, H)
        cs = torch.cumsum(dq * a.float()[None, None, :], dim=1)
        idx = torch.arange(q)
        tri = (idx[:, None] >= idx[None, :])[None, :, :, None]  # (1, Q, Q, 1)
        scores = torch.einsum("bqn,bkn->bqk", cq, bq)
        ldiff = torch.where(tri, cs[:, :, None, :] - cs[:, None, :, :], float("-inf"))
        v = scores[..., None] * torch.exp(ldiff) * dq[:, None, :, :]  # (B, Q, Q, H)
        y_diag = torch.einsum("bqkh,bkhp->bqhp", rb(torch.where(tri, v, 0.0)), xq)
        y_off = torch.einsum("bqn,bhpn->bqhp", cq, rb(state))
        ys.append(y_diag + torch.exp(cs)[..., None] * y_off)
        w = torch.exp(cs[:, -1:, :] - cs) * dq  # (B, Q, H)
        wx = w[..., None] * xq
        hi = rb(wx)
        op = hi + rb(wx - hi) if split else hi
        state = (torch.exp(cs[:, -1, :])[:, :, None, None] * state
                 + torch.einsum("bqhp,bqn->bhpn", op, bq))
    return torch.cat(ys, dim=1).to(x.dtype), state


def ssd_ref(
    x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b_: torch.Tensor,
    c_: torch.Tensor, *, init_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token recurrence (the reference's ``models/mamba.ssd_ref``):
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t, y_t = C_t h_t."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for i in range(s):
        state, y = ssd_step_ref(state, x[:, i], dt[:, i], a, b_[:, i], c_[:, i])
        ys.append(y)
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_step_ref(state, x_t, dt_t, a, b_t, c_t) -> tuple[torch.Tensor, torch.Tensor]:
    """One token of the recurrence in f32: (new state (B, H, P, N), y
    (B, H, P) f32)."""
    f32 = torch.float32
    decay = torch.exp(dt_t.to(f32) * a.to(f32)[None])  # (B, H)
    inp = torch.einsum("bn,bhp,bh->bhpn", b_t.to(f32), x_t.to(f32), dt_t.to(f32))
    state = state * decay[..., None, None] + inp
    return state, torch.einsum("bn,bhpn->bhp", c_t.to(f32), state)


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with an f32 accumulator, in ``result_type(x, y)``."""
    return (x.float() @ y.float()).to(torch.result_type(x, y))


def fwt_ref(x: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform over the last axis: log2(n)
    butterfly stages in f32, the result in x's type."""
    n = x.shape[-1]
    if n & (n - 1):
        raise ValueError(f"fwt: length {n} is not a power of two")
    lead = tuple(x.shape[:-1])
    out = x.float()
    h = 1
    while h < n:
        out = out.reshape(*lead, n // (2 * h), 2, h)
        a, b = out[..., 0, :], out[..., 1, :]
        out = torch.stack([a + b, a - b], dim=-2).reshape(*lead, n)
        h *= 2
    return out.to(x.dtype)


def fwt_columns_plain(y: torch.Tensor) -> torch.Tensor:
    """Unnormalized Walsh-Hadamard transform over the first axis of ``y
    (b1, b2)``: ``fwt_ref`` over axis 0 (log2(b1) stages in f32, h = 1, 2,
    4, ... over the rows), the result in y's type and layout."""
    return fwt_ref(y.movedim(0, -1)).movedim(-1, 0).contiguous()


NW_NEG = -1e9  # the shift-max ladder's fill (the reference's NEG)


def _nw_rows(prev_row: torch.Tensor, prev_west: torch.Tensor, west: torch.Tensor,
             sub: torch.Tensor, gap: float) -> torch.Tensor:
    """Row i of a batch of NW tiles: prev_row (T, B) = H[i-1] (the north
    row for i = 0), prev_west (T,) = west[i-1] (the corner for i = 0),
    west (T,) = west[i], sub (T, B) = sub[i].  ``max(diag + sub, up - gap)``
    with the west neighbour folded into column 0, then the left-to-right
    chain ``H[j] = max_{j'<=j}(tmp[j'] - (j - j') gap)`` as a log-step
    shift-max ladder."""
    t, b = sub.shape
    diag = torch.cat([prev_west[:, None], prev_row[:, :-1]], dim=1)
    tmp = torch.maximum(diag + sub, prev_row - gap)
    tmp = torch.cat([torch.maximum(tmp[:, :1], west[:, None] - gap), tmp[:, 1:]], dim=1)
    h, shift = tmp, 1
    while shift < b:
        fill = torch.full((t, shift), NW_NEG, dtype=h.dtype, device=h.device)
        h = torch.maximum(h, torch.cat([fill, h[:, :-shift] - gap * shift], dim=1))
        shift *= 2
    return h


def nw_tiles_ref(north: torch.Tensor, west: torch.Tensor, corner: torch.Tensor,
                 sub: torch.Tensor, *, gap: float = 1.0) -> torch.Tensor:
    """A batch of NW DP tiles: north / west (T, B), corner (T,), sub (T, B, B)
    -> (T, B, B) f32.  The reference kernel's algorithm: rows in order
    (:func:`_nw_rows`)."""
    b = sub.shape[-1]
    north, west, sub = north.float(), west.float(), sub.float()
    prev_row, prev_west = north, corner.float()
    rows = []
    for i in range(b):
        prev_row = _nw_rows(prev_row, prev_west, west[:, i], sub[:, i], gap)
        rows.append(prev_row)
        prev_west = west[:, i]
    return torch.stack(rows, dim=1)


def nw_strips_plain(state, scores: torch.Tensor, d0: int, d1: int, *, gap: float = 1.0,
                    blocks: int, i0: int = 0, i1: int | None = None
                    ) -> list[tuple[int, int, int, int]]:
    """The tiles (i, j) with d0 <= i + j < d1 and i0 <= i < i1 of an NW
    wavefront (``core/wavefront.WavefrontState``, earlier diagonals done) in
    the strip kernel's order (``csrc/nw_tile.cu``): ``blocks`` blocks take
    strips (tile columns, the run's first one first) from a ticket and walk
    them row after row, top to bottom; a row's west value comes from the
    strip on the left, which publishes each row, when the run computes that
    tile (j >= 1 and i + j - 1 >= d0), else from the state.  The blocks step
    in turn, one row each.  Raises ``AssertionError`` unless every input a
    row takes outside its own strip was written before the run (north and
    corner at the strip's first row, west values not published by the run)
    or published by it, and ``RuntimeError`` if a step stalls every block.
    Returns the (block, i, j, row) steps in order."""
    rows, cols, b = state.south.shape[0] - 1, state.south.shape[1] - 1, state.south.shape[2]
    i1 = rows if i1 is None else i1
    j_lo, j_hi = max(0, d0 - (i1 - 1)), min(cols - 1, d1 - 1 - i0)
    before = lambda i, j: i < 0 or j < 0 or i + j < d0  # noqa: E731  tile done before the run
    published: dict[tuple[int, int], torch.Tensor] = {}  # (strip, global row) -> east value
    held: list[dict | None] = [None] * blocks
    ticket, order = 0, []
    while ticket <= j_hi - j_lo or any(h is not None for h in held):
        moved = False
        for k in range(blocks):
            if held[k] is None:
                if ticket > j_hi - j_lo:
                    continue
                j = j_lo + ticket
                ticket += 1
                i_beg, i_end = max(i0, d0 - j), min(i1, d1 - j)
                if not (before(i_beg - 1, j) and before(i_beg - 1, j - 1)):
                    raise AssertionError(f"nw strips: strip {j} starts at tile {i_beg} "
                                         f"before its north or corner tile is done")
                held[k] = dict(j=j, g=i_beg * b, g_end=i_end * b, east=[],
                               up=state.south[i_beg, j + 1].float(),
                               west=state.corners[i_beg, j].float())
                moved = True
                continue
            h = held[k]
            j, g = h["j"], h["g"]
            i, r = divmod(g, b)
            if j >= 1 and i + j - 1 >= d0:
                if (j - 1, g) not in published:
                    continue  # the kernel polls the left strip's link word
                w = published[(j - 1, g)]
            else:
                if not before(i, j - 1):
                    raise AssertionError(f"nw strips: tile ({i}, {j}) reads a west column "
                                         f"this run has not computed")
                w = state.east[i + 1, j, r].float()
            row = _nw_rows(h["up"][None], h["west"][None], w[None],
                           scores[g, j * b:(j + 1) * b].float()[None], gap)[0]
            state.tiles[i, j, r] = row
            published[(j, g)] = row[-1]
            h["east"].append(row[-1])
            h["up"], h["west"] = row, w
            if r == b - 1:  # the tile's boundary out
                state.south[i + 1, j + 1] = row
                state.east[i + 1, j + 1] = torch.stack(h["east"])
                state.corners[i + 1, j + 1] = row[-1]
                h["east"] = []
            h["g"] = g + 1
            if h["g"] == h["g_end"]:
                held[k] = None
            order.append((k, i, j, r))
            moved = True
        if not moved:
            raise RuntimeError(f"nw strips: every block waits (held {held}, ticket {ticket})")
    return order


def nw_ref(north: np.ndarray, west: np.ndarray, corner: float, sub: np.ndarray, *,
           gap: float = 1.0) -> np.ndarray:
    """Sequential double-loop NW tile (numpy oracle)."""
    b = sub.shape[0]
    h = np.zeros((b + 1, b + 1), np.float32)
    h[0, 0] = corner
    h[0, 1:] = np.asarray(north, np.float32)
    h[1:, 0] = np.asarray(west, np.float32)
    for i in range(1, b + 1):
        for j in range(1, b + 1):
            h[i, j] = max(
                h[i - 1, j - 1] + sub[i - 1, j - 1],
                h[i - 1, j] - gap,
                h[i, j - 1] - gap,
            )
    return h[1:, 1:]


def nw_full_ref(seq_scores: np.ndarray, *, gap: float = 1.0) -> np.ndarray:
    """Full NW matrix for an (n, m) substitution score matrix with the
    boundary initialized to -i*gap / -j*gap (standard global alignment)."""
    n, m = seq_scores.shape
    h = np.zeros((n + 1, m + 1), np.float32)
    h[0, :] = -gap * np.arange(m + 1)
    h[:, 0] = -gap * np.arange(n + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            h[i, j] = max(
                h[i - 1, j - 1] + seq_scores[i - 1, j - 1],
                h[i - 1, j] - gap,
                h[i, j - 1] - gap,
            )
    return h[1:, 1:]
