"""The reference's five examples on the port (``examples/*.py`` of the
JAX package), one module each, run as ``python -m
repro_torch.examples.<name> [--device cpu]``:

  * ``quickstart``: train a smoke model for a few steps, then generate.
  * ``serve_streamed``: streamed vs one-shot prefill, ``generate``,
    continuous batching, paged, snapshots, prefix sharing, speculative
    decode, quantized pages and the measured tuner.
  * ``overlap_demo``: the paper's Fig. 9 tasks over CUDA streams, the
    training loop's prefetch, the paper-number and lavaMD checks.
  * ``nw_wavefront``: Needleman-Wunsch through the wavefront kernel against
    the sequential DP.
  * ``train_e2e``: a small LM through ``Trainer`` with accumulation,
    prefetch and checkpoints.

Each has the reference's flags and defaults plus ``--device`` (the card
unless ``cpu``; without a card and without ``--device cpu`` it raises),
prints the reference's lines and checks its asserts, and exposes
``main(argv=None) -> int`` (0 on success).
"""

from __future__ import annotations

import time

import torch


def wall(dev: torch.device, fn):
    """(fn(), its seconds), the card's queue drained before and after."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, time.perf_counter() - t0
