"""False-dependent streaming: redundant boundary (halo) transfer (paper S4.2).

The paper's FWT example: tasks share read-only neighbours, so the RAR
dependency is eliminated by transferring boundary elements redundantly with
each block (Fig. 7).  The cost is extra bytes on the wire; the paper's
lavaMD negative result (S5) shows streaming loses once halo bytes ~=
payload bytes.

The port's copy of the reference ``core/halo.py``: ``halo_partition`` is
one gather per tensor, over a tensor, a dict, a list or a tuple of them.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.core.tree import tree_map


def halo_indices(n: int, num_chunks: int, halo: int,
                 device: torch.device | str | None = None) -> torch.Tensor:
    """Index matrix (num_chunks, chunk + 2*halo) with edge clamping.

    Chunk i covers the core region [i*c, (i+1)*c) plus ``halo`` elements on
    each side, clamped at the array edges (the paper drops out-of-range
    neighbours; clamping keeps the shape static and kernels mask).
    """
    if n % num_chunks != 0:
        raise ValueError(f"n={n} not divisible by num_chunks={num_chunks}")
    core = n // num_chunks
    starts = torch.arange(num_chunks, device=device) * core - halo
    offs = torch.arange(core + 2 * halo, device=device)
    return (starts[:, None] + offs[None, :]).clamp(0, n - 1)


def halo_partition(xs: Any, num_chunks: int, halo: int) -> Any:
    """Partition every tensor along axis 0 into overlapping (haloed) chunks
    of shape (num_chunks, chunk + 2*halo, ...): the redundant rows are the
    paper's "boundary elements transferred with each block"."""

    def _one(x: torch.Tensor) -> torch.Tensor:
        return x[halo_indices(x.shape[0], num_chunks, halo, x.device)]

    return tree_map(_one, xs)


def strip_halo(ys: Any, halo: int) -> Any:
    """Drop the halo rows from per-chunk outputs (axis 1)."""
    if halo == 0:
        return ys
    return tree_map(lambda y: y[:, halo:-halo], ys)


# ----------------------------------------------------------------------------
# Profitability model (paper S5, FWT vs lavaMD).
# ----------------------------------------------------------------------------

#: Above this halo/task byte ratio, redundant transfer erases the pipeline
#: gain.  Calibrated on the paper's cases: FWT halo/task = 254/1048576
#: (~0.0002, streams profitably at +39%); lavaMD halo/task = 222/250 (~0.9,
#: streamed time 0.7242s vs 0.6856s single-stream -- a loss).  0.5 is a
#: conservative default between the two.
DEFAULT_HALO_BREAK_EVEN = 0.5


def halo_overhead_ratio(halo_elements: int, task_elements: int) -> float:
    """Redundant bytes as a fraction of the per-task payload."""
    if task_elements <= 0:
        return float("inf")
    return halo_elements / task_elements


def halo_streaming_profitable(
    halo_elements: int,
    task_elements: int,
    *,
    break_even: float = DEFAULT_HALO_BREAK_EVEN,
) -> bool:
    """The lavaMD rule: stream only if halo overhead is below break-even."""
    return halo_overhead_ratio(halo_elements, task_elements) < break_even


def streamed_time_with_halo(
    h2d: float, kex: float, num_streams: int, halo_ratio: float
) -> float:
    """Pipeline-model time when each task's H2D grows by ``halo_ratio``:
    ``max(H2D*(1+r), KEX)`` plus fill/drain of the smaller stage."""
    h2d_eff = h2d * (1.0 + halo_ratio)
    m = max(h2d_eff, kex)
    s = h2d_eff + kex
    return m + (s - m) / max(1, num_streams)
