"""Needleman-Wunsch via wavefront streaming: the paper's True-Dependent case
study (Fig. 8), end to end (reference ``examples/nw_wavefront.py``).

Aligns two random DNA sequences: tiles the DP matrix and runs its
anti-diagonals in order, a variable number of streams per diagonal.  On the
card one launch of the NW tile kernel walks the whole tile grid; on the CPU
the plain tile runs one anti-diagonal at a time.

    PYTHONPATH=src python -m repro_torch.examples.nw_wavefront --n 256 --m 192 \\
        --block 32 [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import wavefront
from repro_torch.device import resolve_device
from repro_torch.examples import wall
from repro_torch.kernels import ops, ref


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=128)
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--block", type=int, default=32)
    ap.add_argument("--gap", type=float, default=1.0)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(0)
    a = rng.integers(0, 4, args.n)  # DNA sequences
    b = rng.integers(0, 4, args.m)
    scores = np.where(a[:, None] == b[None, :], 1.0, -1.0).astype(np.float32)

    rows, cols = args.n // args.block, args.m // args.block
    widths = wavefront.streams_per_diagonal(rows, cols)
    print(f"[nw] {args.n}x{args.m} DP matrix, {rows}x{cols} tiles of "
          f"{args.block}; streams per diagonal: {widths}")

    h, t_wave = wall(dev, lambda: ops.nw_wavefront(torch.from_numpy(scores).to(dev),
                                                   block=args.block, gap=args.gap))
    h = h.cpu().numpy()

    t0 = time.perf_counter()
    want = ref.nw_full_ref(scores, gap=args.gap)
    t_seq = time.perf_counter() - t0

    err = np.abs(h - want).max()
    print(f"[nw] wavefront vs sequential: max err {err:.2e} "
          f"(score={h[-1, -1]:.0f})")
    print(f"[nw] walltime: wavefront {t_wave:.3f}s, python-sequential {t_seq:.3f}s")

    # the paper's model for this grid (nw: ~52% improvement reported)
    t1, tm = wavefront.wavefront_speedup_model(
        rows, cols, h2d=0.5, kex=0.5, max_streams=min(rows, cols))
    print(f"[nw] pipeline model: single-stream {t1:.1f} units, wavefront "
          f"{tm:.1f} units -> improvement {(t1 / tm - 1) * 100:.0f}% "
          f"(paper measured 52% for nw)")
    assert err < 1e-3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
