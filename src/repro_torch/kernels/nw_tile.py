"""Needleman-Wunsch DP tiles: wrapper of ``csrc/nw_tile.cu``.

Replaces the TPU kernel ``repro/kernels/nw_tile.py::nw_tile`` (body
``_nw_kernel``, ladder ``_row_chain_max``): one (B, B) tile of the DP
matrix from its north row, west column and corner, rows in order, each
row's left-to-right chain a shift-max ladder.  The CUDA kernel runs every
tile of one anti-diagonal of the tile grid in one launch, reading and
writing the wavefront's boundary state (``core/wavefront.WavefrontState``)
on the card and the substitution scores in place.  The drivers are
``ops.nw_tile`` (one tile) and ``ops.nw_wavefront`` (the whole matrix, one
launch per diagonal).  The kernel's design and bound are in the CUDA
source's header.

On CPU tensors :func:`nw_diagonal` runs the plain version
(:func:`nw_diagonal_plain`, the batched tile of ``kernels/ref.py``); on
CUDA tensors it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import wavefront
from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import nw_tiles_ref

MAX_BLOCK = 1024  # one thread per column

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("nw_tile.cu", "nw_diagonal",
                    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P])


def _grid(state: wavefront.WavefrontState, scores: torch.Tensor) -> tuple[int, int, int]:
    """(rows, cols, B) of the tile grid; raise ``ValueError`` unless the
    state, the (n, m) scores and ``state.tiles`` (a (rows, cols, B, B) view
    of a contiguous (n, m) matrix) fit, are f32 and share one device."""
    rows1, cols1, block = state.south.shape
    rows, cols = rows1 - 1, cols1 - 1
    n, m = rows * block, cols * block
    ts = (state.south, state.east, state.corners, state.tiles, scores)
    if any(t.device != scores.device for t in ts) or scores.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nw: all tensors must be on one cpu or cuda device, got "
                         f"{[str(t.device) for t in ts]}")
    if any(t.dtype != torch.float32 for t in ts):
        raise ValueError(f"nw: tensors must be float32, got {[t.dtype for t in ts]}")
    if (block < 1 or block > MAX_BLOCK or block & (block - 1) or rows < 1 or cols < 1
            or state.east.shape != state.south.shape
            or tuple(state.corners.shape) != (rows1, cols1)
            or tuple(scores.shape) != (n, m)
            or tuple(state.tiles.shape) != (rows, cols, block, block)):
        raise ValueError(
            f"nw: state south {tuple(state.south.shape)}, east {tuple(state.east.shape)}, "
            f"corners {tuple(state.corners.shape)}, tiles {tuple(state.tiles.shape)} and "
            f"scores {tuple(scores.shape)} do not fit a grid of (B, B) tiles, B a power "
            f"of two <= {MAX_BLOCK}")
    return rows, cols, block


def nw_diagonal_plain(state: wavefront.WavefrontState, scores: torch.Tensor,
                      diag: list[tuple[int, int]], *, gap: float = 1.0) -> None:
    """The tiles ``diag`` of one diagonal, as one batch of the plain tile."""
    rows, cols, block = _grid(state, scores)
    sub_tiles = scores.view(rows, block, cols, block)

    def tile_fn(north, west, corner, row_in, col_in, ii, jj):
        tile = nw_tiles_ref(north, west, corner, sub_tiles[ii, :, jj, :], gap=gap)
        return tile, tile[:, -1, :], tile[:, :, -1], tile[:, -1, -1]

    wavefront.tile_step(tile_fn)(state, diag)


def nw_diagonal(state: wavefront.WavefrontState, scores: torch.Tensor,
                diag: list[tuple[int, int]], *, gap: float = 1.0) -> None:
    """Compute the tiles ``diag`` (one anti-diagonal: (i0, d - i0), (i0 + 1,
    d - i0 - 1), ...) of an NW wavefront from ``state`` and write their
    outputs into it; ``scores`` is the (n, m) substitution matrix."""
    rows, cols, block = _grid(state, scores)
    if scores.device.type == "cpu":
        nw_diagonal_plain(state, scores, diag, gap=gap)
        return
    m = cols * block
    if (state.tiles.stride() != (block * m, block, m, 1) or state.tiles.storage_offset()
            or not all(t.is_contiguous() for t in (state.south, state.east, state.corners,
                                                   scores))):
        raise ValueError("nw kernel: state tensors and scores must be contiguous and "
                         "state.tiles a (rows, cols, B, B) view of a contiguous (n, m) matrix")
    i0, d = diag[0][0], diag[0][0] + diag[0][1]
    if any(i != i0 + t or j != d - i for t, (i, j) in enumerate(diag)):
        raise ValueError(f"nw kernel: {diag} is not a run of one anti-diagonal")
    KERNEL.launch(ptr(scores), ptr(state.tiles), ptr(state.south), ptr(state.east),
                  ptr(state.corners), m, cols, block, i0, len(diag), d, float(gap),
                  ctypes.c_void_p(stream_of(scores)))


def boundary(rows: int, cols: int, block: int, *, gap: float = 1.0,
             device: torch.device | str | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference's initial boundary of a (rows, cols) grid of (B, B)
    tiles: (north (cols, B) = -gap (j + 1), west (rows, B) = -gap (i + 1),
    fringe corners (rows + 1, cols + 1) = -gap B k)."""
    f32 = dict(dtype=torch.float32, device=device)
    north = (-gap * (torch.arange(cols * block, **f32) + 1)).reshape(cols, block)
    west = (-gap * (torch.arange(rows * block, **f32) + 1)).reshape(rows, block)
    corner = torch.zeros((rows + 1, cols + 1), **f32)
    corner[0, :] = -gap * block * torch.arange(cols + 1, **f32)
    corner[:, 0] = -gap * block * torch.arange(rows + 1, **f32)
    return north, west, corner


def _wavefront(seq_scores: torch.Tensor, *, block: int, gap: float, diagonal) -> torch.Tensor:
    n, m = seq_scores.shape
    if n % block or m % block:
        raise ValueError(f"nw_wavefront: ({n}, {m}) does not tile by block {block}")
    rows, cols = n // block, m // block
    scores = seq_scores.float().contiguous()
    north, west, corner = boundary(rows, cols, block, gap=gap, device=scores.device)
    out = torch.empty((n, m), dtype=torch.float32, device=scores.device)
    wavefront.wavefront_scan(
        lambda state, diag: diagonal(state, scores, diag, gap=gap),
        rows=rows, cols=cols, block=block, north_init=north, west_init=west,
        corner_init=corner, tiles=out.view(rows, block, cols, block).permute(0, 2, 1, 3))
    return out


def nw_wavefront(seq_scores: torch.Tensor, *, block: int, gap: float = 1.0) -> torch.Tensor:
    """The (n, m) NW matrix of an (n, m) substitution score matrix, one
    :func:`nw_diagonal` per anti-diagonal of the tile grid."""
    return _wavefront(seq_scores, block=block, gap=gap, diagonal=nw_diagonal)


def nw_wavefront_plain(seq_scores: torch.Tensor, *, block: int, gap: float = 1.0
                       ) -> torch.Tensor:
    """:func:`nw_wavefront` with the plain diagonal on any device."""
    return _wavefront(seq_scores, block=block, gap=gap, diagonal=nw_diagonal_plain)
