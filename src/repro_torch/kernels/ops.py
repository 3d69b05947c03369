"""Public kernel wrappers, with the reference ``kernels/ops.py`` argument
order, layouts and ``scale`` default (1 / sqrt(head_dim)).

The device of the tensors picks the path: the CUDA kernel on the card, its
plain PyTorch version on the CPU.  There is no switch to turn a kernel off.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import wavefront as _wf
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fwt as _fwt
from repro_torch.kernels import nw_tile as _nw
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ssd_chunk as _ssd
from repro_torch.kernels import streamed_matmul as _mm


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x @ y`` with an f32 accumulator, in ``result_type(x, y)`` (the
    reference's ``ops.matmul``; any shape, so no block arguments)."""
    return _mm.matmul(x, y)


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


def fwt(x: torch.Tensor, *, block: int | None = None) -> torch.Tensor:
    """Walsh-Hadamard transform of a flat (n,) or batched (r, n) input.

    Kronecker-streamed, as the reference's ``ops.fwt``: WHT(N) = (WHT(B1) x
    I)(I x WHT(B2)), N = B1 * B2 -- pass 1 over the rows of (B1, B2), pass
    2 over its columns, in place (where the reference transposes, runs the
    row pass and transposes back).  Two launches; a bf16 input is rounded
    to bf16 between them, as the reference's is.  A batched input is one
    pass over its rows.
    """
    if x.dim() != 1:
        return _fwt.fwt_block(x)
    n = x.shape[0]
    if n < 1 or n & (n - 1):
        raise ValueError(f"fwt: length {n} is not a power of two")
    b2 = block or min(n, 1024)
    b1 = n // b2
    if b1 == 1:
        return _fwt.fwt_block(x[None, :])[0]
    y = _fwt.fwt_block(x.reshape(b1, b2))  # pass 1: in-block stages
    return _fwt.fwt_columns(y, out=y).reshape(n)  # pass 2: cross-block stages


def nw_tile(north: torch.Tensor, west: torch.Tensor, corner: torch.Tensor | float,
            sub: torch.Tensor, *, gap: float = 1.0) -> torch.Tensor:
    """One (B, B) Needleman-Wunsch tile from its north row (B,), west column
    (B,), corner and substitution scores (B, B): the diagonal kernel over a
    1 x 1 grid.  Returns the tile, f32."""
    block = sub.shape[-1]
    if sub.shape != (block, block) or north.shape != (block,) or west.shape != (block,):
        raise ValueError(f"nw_tile: want north/west (B,) and sub (B, B), got "
                         f"{tuple(north.shape)}, {tuple(west.shape)}, {tuple(sub.shape)}")
    dev = sub.device
    if north.device != dev or west.device != dev:
        raise ValueError(f"nw_tile: north, west and sub must share one device, got "
                         f"{north.device}, {west.device}, {dev}")
    corners = torch.zeros((2, 2), dtype=torch.float32, device=dev)
    corners[0, 0] = torch.as_tensor(corner, dtype=torch.float32)
    out = torch.empty((block, block), dtype=torch.float32, device=dev)
    state = _wf.WavefrontState.create(
        rows=1, cols=1, block=block, north_init=north.float()[None],
        west_init=west.float()[None], corner_init=corners,
        tiles=out.view(1, block, 1, block).permute(0, 2, 1, 3))
    _nw.nw_diagonal(state, sub.float().contiguous(), [(0, 0)], gap=gap)
    return out


def nw_wavefront(seq_scores: torch.Tensor, *, block: int, gap: float = 1.0) -> torch.Tensor:
    """The full (n, m) NW DP matrix of the paper's Fig. 8 pipeline: on the
    card one launch of the tile kernel walks the whole (n / block, m /
    block) tile grid, strip by strip; on the CPU the plain tile runs one
    anti-diagonal at a time through the wavefront scheduler."""
    return _nw.nw_wavefront(seq_scores, block=block, gap=gap)
