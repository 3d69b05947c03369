"""Micro-benchmark harness: measured stage times on the engine's device.

The analytic planner (``serving.plan_decode_policy``) feeds the paper's
generic flow with *one-shot* stage estimates; this module replaces them
with calibrated measurements (the paper's stage-by-stage methodology, §3.3,
applied at tuner granularity):

  * ``profile_engine``   — times one real prefill chunk, one batched decode
    tick, the page scatter/gather that admission and eviction pay, and the
    raw H2D/D2H staging of a chunk's tokens / a tick's sampled ids, each
    warmed and repeated (median), returning a ``StageProfile`` whose
    ``stage_times()`` is the calibrated ``StageTimes`` triple.
  * ``measure_workload`` — runs a whole synthetic workload through a fresh
    engine (warmup first, so first runs and graph captures stay out of the
    timing) and reports end-to-end tokens/s, mean admission latency and the
    greedy outputs (the search's parity check rides along for free).

The port's copy of the reference ``tuning/profiler.py``.  Where the
reference blocks on a JAX array, a probe here ends in a synchronization
of the engine's device (``StreamedBatchEngine._sync``, as its own
``_time_step``): host wall time between synchronizations on a card, plain
wall time on the CPU.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import rmetric
from repro_torch.obs import stage_times_from_trace
from repro_torch.runtime.kv_cache import zero_cache
from repro_torch.tuning.workload import WorkloadDescriptor, synth_prompts

_REPEATS = 3  # median-of-N per probe; the harness is a tuner, not a bench

#: Most warmup runs ``measure_workload`` makes on a card while a run still
#: meets steps for the first time (an LRU cap that evicts keeps doing so).
_MAX_WARMUP_RUNS = 4


def _timed(fn, *, repeats: int = _REPEATS) -> float:
    """Median wall-clock of ``fn`` (already warmed) over ``repeats`` runs."""
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return float(np.median(samples))


@dataclasses.dataclass(frozen=True)
class StageProfile:
    """Measured per-stage seconds on the engine's device.

    ``chunk_s``/``decode_s`` are the paper's ingest/compute stages;
    ``h2d_s``/``d2h_s`` the host-link staging either side of them;
    ``scatter_s``/``gather_s`` the paged admission/evict page moves
    (0.0 on the contiguous path).
    """

    chunk_s: float  # one prefill-chunk task (dispatch + compute)
    decode_s: float  # one batched decode tick
    h2d_s: float = 0.0  # host -> device staging of one chunk's tokens
    d2h_s: float = 0.0  # device -> host of one tick's sampled ids
    scatter_s: float = 0.0  # one page scatter (paged admission)
    gather_s: float = 0.0  # one page gather (paged evict)

    def stage_times(self) -> rmetric.StageTimes:
        """The calibrated triple for the paper's formulas: the ingest stage
        is a chunk plus its token staging, compute is the decode tick, the
        drain stage is the tick's D2H."""
        return rmetric.StageTimes(
            h2d=self.chunk_s + self.h2d_s, kex=self.decode_s, d2h=self.d2h_s)


def profile_engine(
    eng: Any, prompt_len: int, *, repeats: int = _REPEATS,
) -> StageProfile:
    """Measure the serving stages on a live (idle) ``StreamedBatchEngine``.

    Chunk and decode come from the engine's recorded trace when tracing is
    on and has seen real traffic (``repro_torch.obs.stage_times_from_trace``
    — production ticks beat synthetic probes, and reading the ring buffer
    costs the live engine nothing); otherwise from the engine's own warmed
    probe (``measure_stage_times``, medianized here).  On a card the two
    differ: a chunk span is its dispatch (the next tick's fetch pays its
    device time), the probe synchronizes around it.  The H2D/D2H staging
    and the page scatter/gather are always measured directly.  The engine
    must be idle: the paged probes borrow a free slot and the engine's
    request cache (zeroed, as ``measure_stage_times`` uses it) and release
    the slot after.
    """
    chunk = min(eng.scfg.prefill_chunk, prompt_len)
    traced = None
    obs = getattr(eng, "obs", None)
    if obs is not None and obs.enabled:
        traced = stage_times_from_trace(obs.spans())
    if traced is not None:
        chunk_s, decode_s = traced.h2d, traced.kex
    else:
        st = [eng.measure_stage_times(prompt_len) for _ in range(repeats)]
        chunk_s = float(np.median([t.h2d for t in st]))
        decode_s = float(np.median([t.kex for t in st]))

    # Host-link staging: the chunk's token buffer up (pinned host staging
    # into a preallocated device buffer, as a step graph's inputs are
    # filled), the tick's ids down.
    dev, sync = eng.device, eng._sync
    host = torch.zeros((1, chunk), dtype=torch.int32, pin_memory=dev.type == "cuda")
    staged = torch.empty((1, chunk), dtype=torch.int32, device=dev)

    def h2d():
        staged.copy_(host, non_blocking=True)
        sync()
    h2d()  # warm the copy path
    h2d_s = _timed(h2d, repeats=repeats)
    # D2H sees a *fresh* device buffer each repeat, as each tick fetches
    # its own picks: one ``.cpu()`` of a (max_batch,) int32.
    base = torch.zeros((eng.scfg.max_batch,), dtype=torch.int32, device=dev)
    (base + 0).cpu()  # warm the transfer path
    samples = []
    for i in range(repeats):
        fresh = base + (i + 1)
        sync()
        t0 = time.perf_counter()
        fresh.cpu()
        samples.append(time.perf_counter() - t0)
    d2h_s = float(np.median(samples))

    scatter_s = gather_s = 0.0
    if eng.paged:
        slot = next((s.index for s in eng.slots if s.free), None)
        if slot is not None and eng.kv.alloc(slot, eng.kv.block_size):
            rows = eng.kv.block_size
            src = zero_cache(eng.servable.single.request_cache())

            def scatter():
                eng.kv.scatter(slot, src, rows)
                sync()

            def gather():
                eng.kv.gather(slot, rows)
                sync()
            try:
                # Each move's first use runs eagerly, its second captures
                # (on a card): time the replays.
                for move in (scatter, scatter, gather, gather):
                    move()
                scatter_s = _timed(scatter, repeats=repeats)
                gather_s = _timed(gather, repeats=repeats)
            finally:
                eng.kv.release(slot)
    return StageProfile(
        chunk_s=chunk_s, decode_s=decode_s, h2d_s=h2d_s, d2h_s=d2h_s,
        scatter_s=scatter_s, gather_s=gather_s)


@dataclasses.dataclass(frozen=True)
class WorkloadMeasurement:
    """One measured end-to-end run of a candidate configuration."""

    tokens_per_s: float
    admit_ms: float  # mean queue-pop -> first-token latency
    wall_s: float
    decode_steps: int
    preemptions: int
    outputs: dict[int, np.ndarray]  # submit-order index -> greedy tokens

    def score(self, *, admit_weight: float = 0.0) -> float:
        """Higher is better.  ``admit_weight`` (tokens/s per ms) converts
        admission latency into the throughput currency — open-arrival
        workloads care, closed batches set it to 0."""
        return self.tokens_per_s - admit_weight * self.admit_ms


def measure_workload(
    make_engine, desc: WorkloadDescriptor, *, vocab_size: int,
    seed: int = 0, warmup: bool = True, timed_runs: int = 3,
) -> WorkloadMeasurement:
    """Run ``desc``'s synthetic workload through a fresh engine and measure.

    ``make_engine`` is a zero-arg factory (the search builds one engine per
    candidate config — graph caches and pool geometry must not leak
    between candidates); the engine is dropped before this returns.  With
    ``warmup`` a first full run builds every chunk/scatter/decode step; on
    a card, where a step's first use runs eagerly and its second captures
    its graph, warmup runs repeat until one meets no step for the first
    time, so the timed runs replay graphs only.  The workload is then timed
    ``timed_runs`` times (between synchronizations of the device) and the
    *median* run reported — single timed runs on a loaded host are noisy
    enough to send coordinate descent chasing scheduler jitter instead of
    real knob effects.
    """
    eng = make_engine()
    prompts = synth_prompts(desc, vocab_size=vocab_size, seed=seed)

    def serve() -> tuple[list[int], dict[int, np.ndarray]]:
        uids = [eng.submit(p, max_new_tokens=desc.max_new_tokens)
                for p in prompts]
        return uids, eng.run()
    if warmup:
        for _ in range(_MAX_WARMUP_RUNS):
            first = eng.graphs.first_runs
            serve()
            if eng.graphs.capture is None or eng.graphs.first_runs == first:
                break
        # a shared-prefix warmup registered real prefixes; keeping them *is*
        # the steady state such a workload runs in
    walls, admits, outputs = [], [], None
    steps = preempts = 0
    for _ in range(max(1, timed_runs)):
        eng.admit_seconds = 0.0
        eng.admissions = 0
        eng.decode_steps = 0
        eng.preemptions = 0
        eng._sync()
        t0 = time.perf_counter()
        uids, out = serve()
        eng._sync()
        walls.append(time.perf_counter() - t0)
        admits.append(eng.admit_seconds / eng.admissions * 1e3
                      if eng.admissions else 0.0)
        steps, preempts = eng.decode_steps, eng.preemptions
        run_out = {i: out[u] for i, u in enumerate(uids)}
        # (sampling streams are keyed by the uid, which advances between
        # runs, so run-to-run determinism is only a greedy-mode invariant)
        assert (outputs is None or eng.scfg.temperature > 0.0 or all(
            np.array_equal(run_out[i], outputs[i]) for i in run_out)), \
            "greedy decode must be run-to-run deterministic"
        outputs = run_out
    # The next candidate's engine is built only after this one (its pool,
    # graphs and graph memory) is gone.
    del eng
    gc.collect()
    wall = float(np.median(walls))
    total = sum(len(v) for v in outputs.values())
    return WorkloadMeasurement(
        tokens_per_s=total / wall if wall > 0 else 0.0,
        admit_ms=float(np.median(admits)), wall_s=wall, decode_steps=steps,
        preemptions=preempts, outputs=outputs)
