"""True-dependent streaming: wavefront scheduling (paper S4.2, NW).

The paper streams RAW-dependent codes (Needleman-Wunsch) by tiling the DP
matrix, executing anti-diagonals in order, and running the tiles *within* a
diagonal concurrently -- "the number of streams changes on different
diagonals".

The port's copy of the reference ``core/wavefront.py``.  Its
``wavefront_scan`` is a host loop over the ``rows + cols - 1`` diagonals.
The boundary handoff (south row, east column, corner scalar of every tile)
lives in a :class:`WavefrontState` on the tensors' device, and one call of
``step`` runs every tile of a diagonal as one batch: the counterpart of the
reference's masked ``vmap`` lanes.  On the card the NW tile kernel
(``kernels/nw_tile.py``) takes the state as its boundary I/O and walks a
whole run of diagonals in one launch instead.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.core.tree import tree_map


def diagonal_tiles(rows: int, cols: int) -> list[list[tuple[int, int]]]:
    """Tiles grouped by anti-diagonal."""
    out: list[list[tuple[int, int]]] = []
    for d in range(rows + cols - 1):
        diag = [
            (i, d - i)
            for i in range(max(0, d - cols + 1), min(rows - 1, d) + 1)
        ]
        out.append(diag)
    return out


def streams_per_diagonal(rows: int, cols: int) -> list[int]:
    """Concurrent-task count per diagonal (the paper's variable stream count)."""
    return [len(d) for d in diagonal_tiles(rows, cols)]


@dataclasses.dataclass(frozen=True)
class WavefrontResult:
    """Outputs of a wavefront execution over a (rows, cols) tile grid."""

    tiles: torch.Tensor  # (rows, cols, B, B) per-tile outputs
    south_rows: torch.Tensor  # (rows, cols, B) bottom boundary of each tile
    east_cols: torch.Tensor  # (rows, cols, B) right boundary of each tile
    corners: torch.Tensor  # (rows, cols) bottom-right scalar of each tile


@dataclasses.dataclass
class WavefrontState:
    """Boundary state with a one-tile fringe, so reads never branch: state
    indices are tile indices + 1, and fringe row / column 0 hold the
    initial boundaries.  Tile (i, j) reads its north row ``south[i, j+1]``,
    west column ``east[i+1, j]`` and corner ``corners[i, j]``, and writes
    ``south[i+1, j+1]``, ``east[i+1, j+1]``, ``corners[i+1, j+1]`` and
    ``tiles[i, j]``."""

    south: torch.Tensor  # (rows + 1, cols + 1, B), contiguous
    east: torch.Tensor  # (rows + 1, cols + 1, B), contiguous
    corners: torch.Tensor  # (rows + 1, cols + 1), contiguous
    tiles: torch.Tensor  # (rows, cols, B, B), possibly a view of a larger matrix

    @classmethod
    def create(cls, *, rows: int, cols: int, block: int, north_init: torch.Tensor,
               west_init: torch.Tensor, corner_init: torch.Tensor,
               dtype=torch.float32, tiles: torch.Tensor | None = None
               ) -> "WavefrontState":
        """The state on ``north_init``'s device; ``tiles``, if given, is the
        (rows, cols, B, B) tensor (or view) the tiles are written into."""
        dev = north_init.device
        south = torch.zeros((rows + 1, cols + 1, block), dtype=dtype, device=dev)
        south[0, 1:] = north_init
        east = torch.zeros((rows + 1, cols + 1, block), dtype=dtype, device=dev)
        east[1:, 0] = west_init
        corners = corner_init.to(device=dev, dtype=dtype).clone().contiguous()
        if tiles is None:
            tiles = torch.zeros((rows, cols, block, block), dtype=dtype, device=dev)
        return cls(south, east, corners, tiles)

    def result(self) -> WavefrontResult:
        return WavefrontResult(tiles=self.tiles, south_rows=self.south[1:, 1:],
                               east_cols=self.east[1:, 1:], corners=self.corners[1:, 1:])


def tile_step(tile_fn: Callable[..., tuple[torch.Tensor, ...]],
              row_inputs: Any = None, col_inputs: Any = None
              ) -> Callable[[WavefrontState, list[tuple[int, int]]], None]:
    """A diagonal step from a batched tile function with the reference's
    arguments: ``tile_fn(north (w, B), west (w, B), corner (w,), row_in,
    col_in, i (w,), j (w,)) -> (tile (w, B, B), south (w, B), east (w, B),
    se_corner (w,))`` for the w tiles of one diagonal.  ``row_inputs[i]`` /
    ``col_inputs[j]`` (tensors, or dicts / tuples of them, with a leading
    rows / cols axis) are gathered for the diagonal's tiles; None passes
    None."""

    def step(state: WavefrontState, diag: list[tuple[int, int]]) -> None:
        dev = state.south.device
        ii = torch.tensor([i for i, _ in diag], device=dev)
        jj = torch.tensor([j for _, j in diag], device=dev)
        row_in = None if row_inputs is None else tree_map(lambda a: a[ii], row_inputs)
        col_in = None if col_inputs is None else tree_map(lambda a: a[jj], col_inputs)
        tile, s_row, e_col, se = tile_fn(state.south[ii, jj + 1], state.east[ii + 1, jj],
                                         state.corners[ii, jj], row_in, col_in, ii, jj)
        state.south[ii + 1, jj + 1] = s_row.to(state.south.dtype)
        state.east[ii + 1, jj + 1] = e_col.to(state.east.dtype)
        state.corners[ii + 1, jj + 1] = se.to(state.corners.dtype)
        state.tiles[ii, jj] = tile.to(state.tiles.dtype)

    return step


def wavefront_scan(
    step: Callable[[WavefrontState, list[tuple[int, int]]], None],
    *,
    rows: int,
    cols: int,
    block: int,
    north_init: torch.Tensor,  # (cols, B) northern boundary of the top tile row
    west_init: torch.Tensor,  # (rows, B) western boundary of the left tile col
    corner_init: torch.Tensor,  # (rows+1, cols+1) corner scalars for the fringe
    dtype=torch.float32,
    tiles: torch.Tensor | None = None,
) -> WavefrontResult:
    """Run every tile of a (rows, cols) grid in wavefront order.

    ``step(state, diag)`` computes all tiles ``diag`` (a list of (i, j)) of
    one anti-diagonal from ``state`` and writes their outputs into it (see
    :class:`WavefrontState`); tiles of one diagonal read only boundaries
    written by earlier diagonals, so they may run in any order or all at
    once.  :func:`tile_step` builds a step from a batched tile function with
    the reference's ``tile_fn`` arguments.  ``tiles`` is where the tiles go
    (default: a new (rows, cols, B, B) tensor).
    """
    state = WavefrontState.create(rows=rows, cols=cols, block=block, north_init=north_init,
                                  west_init=west_init, corner_init=corner_init,
                                  dtype=dtype, tiles=tiles)
    for diag in diagonal_tiles(rows, cols):
        step(state, diag)
    return state.result()


# ----------------------------------------------------------------------------
# Pipeline-model accounting for wavefront streaming (paper S5: nw +52%).
# ----------------------------------------------------------------------------


def wavefront_speedup_model(
    rows: int, cols: int, *, h2d: float, kex: float, max_streams: int
) -> tuple[float, float]:
    """(single-stream time, wavefront multi-stream time) for a tile grid.

    Single-stream: every tile pays h2d + kex serially.  Wavefront: within a
    diagonal of width k, min(k, max_streams) streams overlap transfers with
    compute; across diagonals the RAW chain serializes compute but hides
    transfer behind the previous diagonal's compute (steady state).
    """
    n_tiles = rows * cols
    t_single = n_tiles * (h2d + kex)

    t_multi = 0.0
    for width in streams_per_diagonal(rows, cols):
        s = min(max(1, max_streams), width)
        # Tiles in the diagonal execute in ceil(width/s) rounds; each round
        # costs max(h2d, kex) steady-state + the smaller stage once (fill).
        rounds = -(-width // s)
        t_multi += rounds * max(h2d, kex) + min(h2d, kex)
    return t_single, t_multi
