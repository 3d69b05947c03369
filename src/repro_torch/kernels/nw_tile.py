"""Needleman-Wunsch DP tiles: wrapper of ``csrc/nw_tile.cu``.

Replaces the TPU kernel ``repro/kernels/nw_tile.py::nw_tile`` (body
``_nw_kernel``, ladder ``_row_chain_max``): one (B, B) tile of the DP
matrix from its north row, west column and corner, rows in order, each
row's left-to-right chain a shift-max ladder.  The CUDA kernel runs a run
of anti-diagonals of the tile grid in one launch: a block walks one tile
column (a strip) top to bottom, row after row, and takes each row's west
value from the strip on its left through a tagged link word on the card
(:func:`plan_strips`).  It reads and writes the wavefront's boundary state
(``core/wavefront.WavefrontState``) on the card and the substitution
scores in place.  The entries: :func:`nw_wavefront` (``ops.nw_wavefront``;
one launch a call, the whole grid), :func:`nw_run` (diagonals [d0, d1)),
:func:`nw_diagonal` (a run of one diagonal's tiles) and ``ops.nw_tile`` (a
1 x 1 grid).  The kernel's design and bound are in the CUDA source's
header.

On CPU tensors the entries run the plain versions: :func:`nw_diagonal_plain`
(the batched tile of ``kernels/ref.py``), diagonal by diagonal through
``core/wavefront.wavefront_scan``, and for :func:`nw_run` the plain rows in
the kernel's strip order (``ref.nw_strips_plain``); on CUDA tensors they
launch the kernel or raise — they never fall back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import wavefront
from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import nw_strips_plain, nw_tiles_ref

MAX_BLOCK = 1024  # one thread per column

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("nw_tile.cu", "nw_run",
                    [_P] * 7 + [_I] * 8 + [ctypes.c_float, _P])


@dataclasses.dataclass(frozen=True)
class StripPlan:
    """The strips of a run: tile columns ``j_lo`` .. ``j_lo + n_strips - 1``
    hold its tiles.  The kernel's grid is ``n_strips`` blocks, capped by
    what the card holds."""

    j_lo: int
    n_strips: int


def plan_strips(rows: int, cols: int, d0: int, d1: int, i0: int = 0,
                i1: int | None = None) -> StripPlan:
    """The strips of the tiles (i, j) with d0 <= i + j < d1 and i0 <= i < i1
    of a (rows, cols) tile grid; a row range narrower than the grid is only
    for a run of one diagonal.  Raises ``ValueError`` on a bad run."""
    i1 = rows if i1 is None else i1
    if (not 0 <= d0 < d1 <= rows + cols - 1 or not 0 <= i0 < i1 <= rows
            or ((i0 > 0 or i1 < rows) and d1 != d0 + 1)):
        raise ValueError(f"nw: diagonals [{d0}, {d1}) rows [{i0}, {i1}) are not a run of "
                         f"a ({rows}, {cols}) tile grid (a row range only for one diagonal)")
    j_lo, j_hi = max(0, d0 - (i1 - 1)), min(cols - 1, d1 - 1 - i0)
    if j_hi < j_lo:
        raise ValueError(f"nw: diagonals [{d0}, {d1}) rows [{i0}, {i1}) hold no tile")
    return StripPlan(j_lo, j_hi - j_lo + 1)


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


def _launch(state: wavefront.WavefrontState, scores: torch.Tensor, d0: int, d1: int,
            i0: int, i1: int, gap: float) -> None:
    """One kernel launch over the run.  The strips' link words (cols x n,
    used only by a run of several diagonals) and the ticket (the last word)
    are one zeroed int64 tensor."""
    rows, cols, block = _grid(state, scores)
    plan_strips(rows, cols, d0, d1, i0, i1)
    m = cols * block
    if (state.tiles.stride() != (block * m, block, m, 1) or state.tiles.storage_offset()
            or not all(t.is_contiguous() for t in (state.south, state.east, state.corners,
                                                   scores))):
        raise ValueError("nw kernel: state tensors and scores must be contiguous and "
                         "state.tiles a (rows, cols, B, B) view of a contiguous (n, m) matrix")
    words = cols * rows * block if d1 > d0 + 1 else 0
    link = torch.zeros(words + 1, dtype=torch.int64, device=scores.device)
    KERNEL.launch(ptr(scores), ptr(state.tiles), ptr(state.south), ptr(state.east),
                  ptr(state.corners), ptr(link), ptr(link[-1:]), m, rows, cols, block, d0,
                  d1, i0, i1, float(gap), ctypes.c_void_p(stream_of(scores)))


def nw_diagonal_plain(state: wavefront.WavefrontState, scores: torch.Tensor,
                      diag: list[tuple[int, int]], *, gap: float = 1.0) -> None:
    """The tiles ``diag`` of one diagonal, as one batch of the plain tile."""
    rows, cols, block = _grid(state, scores)
    sub_tiles = scores.view(rows, block, cols, block)

    def tile_fn(north, west, corner, row_in, col_in, ii, jj):
        tile = nw_tiles_ref(north, west, corner, sub_tiles[ii, :, jj, :], gap=gap)
        return tile, tile[:, -1, :], tile[:, :, -1], tile[:, -1, -1]

    wavefront.tile_step(tile_fn)(state, diag)


def nw_run(state: wavefront.WavefrontState, scores: torch.Tensor, d0: int, d1: int, *,
           gap: float = 1.0) -> None:
    """Compute every tile of the anti-diagonals [d0, d1) of an NW wavefront
    from ``state`` (earlier diagonals done) and write their outputs into it;
    ``scores`` is the (n, m) substitution matrix.  On the card, one launch."""
    rows, cols, _ = _grid(state, scores)
    if scores.device.type == "cpu":
        nw_strips_plain(state, scores, d0, d1, gap=gap,
                        blocks=plan_strips(rows, cols, d0, d1).n_strips)
        return
    _launch(state, scores, d0, d1, 0, rows, gap)


def nw_diagonal(state: wavefront.WavefrontState, scores: torch.Tensor,
                diag: list[tuple[int, int]], *, gap: float = 1.0) -> None:
    """Compute the tiles ``diag`` (a run of one anti-diagonal: (i0, d - i0),
    (i0 + 1, d - i0 - 1), ...) of an NW wavefront from ``state`` and write
    their outputs into it; ``scores`` is the (n, m) substitution matrix.  On
    the card, one launch; no tile of the run waits."""
    _grid(state, scores)
    if scores.device.type == "cpu":
        nw_diagonal_plain(state, scores, diag, gap=gap)
        return
    i0, d = diag[0][0], diag[0][0] + diag[0][1]
    if any(i != i0 + t or j != d - i for t, (i, j) in enumerate(diag)):
        raise ValueError(f"nw kernel: {diag} is not a run of one anti-diagonal")
    _launch(state, scores, d, d + 1, i0, i0 + len(diag), gap)


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


def initial_state(seq_scores: torch.Tensor, block: int, *, gap: float = 1.0
                  ) -> tuple[wavefront.WavefrontState, torch.Tensor, torch.Tensor]:
    """(state, f32 contiguous scores, out) of an (n, m) score matrix: the
    reference's boundary, and state.tiles a view of the (n, m) output."""
    n, m = seq_scores.shape
    if n % block or m % block:
        raise ValueError(f"nw_wavefront: ({n}, {m}) does not tile by block {block}")
    rows, cols = n // block, m // block
    scores = seq_scores.float().contiguous()
    north, west, corner = boundary(rows, cols, block, gap=gap, device=scores.device)
    out = torch.empty((n, m), dtype=torch.float32, device=scores.device)
    state = wavefront.WavefrontState.create(
        rows=rows, cols=cols, block=block, north_init=north, west_init=west,
        corner_init=corner, tiles=out.view(rows, block, cols, block).permute(0, 2, 1, 3))
    return state, scores, out


def nw_wavefront(seq_scores: torch.Tensor, *, block: int, gap: float = 1.0) -> torch.Tensor:
    """The (n, m) NW matrix of an (n, m) substitution score matrix: on the
    card one launch over the whole tile grid, on the CPU the plain diagonal
    per anti-diagonal."""
    if seq_scores.device.type == "cpu":
        return nw_wavefront_plain(seq_scores, block=block, gap=gap)
    state, scores, out = initial_state(seq_scores, block, gap=gap)
    rows, cols = state.corners.shape[0] - 1, state.corners.shape[1] - 1
    nw_run(state, scores, 0, rows + cols - 1, gap=gap)
    return out


def nw_wavefront_plain(seq_scores: torch.Tensor, *, block: int, gap: float = 1.0
                       ) -> torch.Tensor:
    """:func:`nw_wavefront` with the plain diagonal on any device, one
    diagonal a step of ``core/wavefront.wavefront_scan``."""
    n, m = seq_scores.shape
    if n % block or m % block:
        raise ValueError(f"nw_wavefront: ({n}, {m}) does not tile by block {block}")
    rows, cols = n // block, m // block
    scores = seq_scores.float().contiguous()
    north, west, corner = boundary(rows, cols, block, gap=gap, device=scores.device)
    out = torch.empty((n, m), dtype=torch.float32, device=scores.device)
    wavefront.wavefront_scan(
        lambda state, diag: nw_diagonal_plain(state, scores, diag, gap=gap),
        rows=rows, cols=cols, block=block, north_init=north, west_init=west,
        corner_init=corner, tiles=out.view(rows, block, cols, block).permute(0, 2, 1, 3))
    return out
