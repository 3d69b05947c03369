"""Multiple-stream execution engine (paper S4.2) on CUDA streams.

The paper's streaming flow: partition the workload into tasks, spawn
streams, and overlap the H2D stage of one task with the KEX stage of
another.  On the H100 that flow exists as the paper ran it: a PCIe link,
copy engines beside the SMs, and ``torch.cuda.Stream``s, the counterpart of
the hStreams streams the paper used.

  * ``stream_map`` / ``stream_scan`` partition the leading axis into tasks
    and run them as a chunk loop (the reference's ``lax.map`` /
    ``lax.scan`` task grids).
  * ``HostStreamExecutor`` runs the H2D, KEX and D2H stages of a task set
    stage by stage (one stream) or pipelined over ``num_streams`` CUDA
    streams, timing every stage with CUDA events; ``measure_r`` returns the
    paper's R.
  * ``plan_streaming`` is the paper's generic flow (S6): R, the dependency
    category, the halo rule, the stream count.

Dependency handling follows the paper's taxonomy (``core.dependency``):
INDEPENDENT -> plain chunked map; FALSE_DEPENDENT -> chunks with redundant
halo transfer (``core.halo``); TRUE_DEPENDENT -> a carried-state chain or a
wavefront (``core.wavefront``).

The port's copy of the reference ``core/streams.py`` (it imports nothing of
it).
"""

from __future__ import annotations

import concurrent.futures as _futures
import dataclasses
import time
from typing import Any, Callable, Sequence

import torch

from repro_torch.core import dependency as dep
from repro_torch.core import halo as halo_lib
from repro_torch.core import rmetric
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.device import resolve_device

# ----------------------------------------------------------------------------
# Task-grid streaming over a leading axis.
# ----------------------------------------------------------------------------


def _split_leading(tree: Any, num_streams: int) -> Any:
    """Reshape every leaf (n, ...) -> (num_streams, n // num_streams, ...)."""

    def _reshape(x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % num_streams != 0:
            raise ValueError(
                f"leading axis {n} not divisible by num_streams={num_streams}"
            )
        return x.reshape((num_streams, n // num_streams) + tuple(x.shape[1:]))

    return tree_map(_reshape, tree)


def _run_chunks(fn: Callable[[Any], Any], chunks: Any, n: int) -> Any:
    """``fn`` on chunk 0..n-1 in order, outputs concatenated along axis 0."""
    outs = [fn(tree_map(lambda x, i=i: x[i], chunks)) for i in range(n)]
    return tree_map(lambda *ys: torch.cat(ys, dim=0), *outs)


def stream_map(
    fn: Callable[[Any], Any],
    xs: Any,
    *,
    num_streams: int,
    category: dep.Category = dep.Category.INDEPENDENT,
    halo: int = 0,
) -> Any:
    """Partition ``xs`` along axis 0 into ``num_streams`` tasks and run them
    in order.

    INDEPENDENT: ``fn`` maps a chunk ``(n/num_streams, ...)`` to outputs.
    FALSE_DEPENDENT: each chunk is extended by ``halo`` elements on both
      sides (redundant boundary transfer, paper Fig. 7); ``fn`` receives the
      haloed chunk and must return outputs for the *core* region.
    TRUE_DEPENDENT: use ``stream_scan`` instead (carried state).
    """
    if category is dep.Category.TRUE_DEPENDENT:
        raise ValueError("true-dependent workloads need stream_scan (carried state)")
    if not category.streamable:
        raise ValueError(f"category {category} is not streamable (paper S4.1)")
    if category is dep.Category.FALSE_DEPENDENT and halo > 0:
        chunks = halo_lib.halo_partition(xs, num_streams, halo)
    else:
        chunks = _split_leading(xs, num_streams)
    return _run_chunks(fn, chunks, num_streams)


def batch_schedule(
    costs: Sequence[float], num_streams: int
) -> list[list[int]]:
    """Assign tasks to ``num_streams`` balanced batches (greedy LPT):
    sort tasks by descending cost, place each on the least-loaded stream.
    Returns one list of task indices per stream."""
    if num_streams < 1:
        raise ValueError(f"num_streams must be >= 1, got {num_streams}")
    lanes: list[list[int]] = [[] for _ in range(num_streams)]
    loads = [0.0] * num_streams
    for i in sorted(range(len(costs)), key=lambda i: -costs[i]):
        j = min(range(num_streams), key=loads.__getitem__)
        lanes[j].append(i)
        loads[j] += costs[i]
    return lanes


def stream_scan(
    fn: Callable[[Any, Any], tuple[Any, Any]],
    init: Any,
    xs: Any,
    *,
    num_streams: int,
) -> tuple[Any, Any]:
    """True-dependent streaming: tasks form a RAW chain (paper S4.2).
    ``fn(carry, chunk) -> (carry, out_chunk)``; the carried state serializes
    the compute stages."""
    chunks = _split_leading(xs, num_streams)
    carry, outs = init, []
    for i in range(num_streams):
        carry, y = fn(carry, tree_map(lambda x, i=i: x[i], chunks))
        outs.append(y)
    return carry, tree_map(lambda *ys: torch.cat(ys, dim=0), *outs)


# ----------------------------------------------------------------------------
# Host-level streaming: H2D / KEX / D2H over CUDA streams.
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class StreamStats:
    """Measured stage times for one run (seconds).  On a CUDA device
    ``intervals`` holds, per task, its stream and the (start, end) seconds
    of its H2D, KEX and D2H stages from one start event."""

    h2d: float = 0.0
    kex: float = 0.0
    d2h: float = 0.0
    wall: float = 0.0
    intervals: list[dict] = dataclasses.field(default_factory=list)

    def stage_times(self) -> rmetric.StageTimes:
        return rmetric.StageTimes(h2d=self.h2d, kex=self.kex, d2h=self.d2h)

    def h2d_kex_overlap(self) -> float:
        """Seconds during which one task's H2D ran beside another task's
        KEX (the union over tasks of each H2D interval's intersection with
        the other tasks' KEX intervals); 0 without intervals."""
        total = 0.0
        for a in self.intervals:
            cuts = []
            for b in self.intervals:
                if b is a:
                    continue
                lo, hi = max(a["h2d"][0], b["kex"][0]), min(a["h2d"][1], b["kex"][1])
                if hi > lo:
                    cuts.append((lo, hi))
            end = float("-inf")
            for lo, hi in sorted(cuts):
                lo = max(lo, end)
                if hi > lo:
                    total += hi - lo
                    end = hi
        return total


class HostStreamExecutor:
    """Execute (H2D -> KEX -> D2H) tasks with ``num_streams`` pipelines.

    A task is a tensor, or a dict / list / tuple of tensors, on the host;
    ``fn`` maps the task on the device to its output (same kinds).

    On a CUDA device (the default) the executor owns ``num_streams``
    ``torch.cuda.Stream``s, never the default stream.  H2D is a
    ``non_blocking`` copy, which overlaps anything only from pinned host
    memory: the tasks must be pinned (``pin_memory()``), and an unpinned
    task raises.  KEX is ``fn`` run inside ``torch.cuda.stream(s)``, so the
    port's kernels launch on ``s``.  D2H copies into pinned host buffers
    allocated before the clock starts (from the output shapes of an earlier
    run; the first run allocates them as it goes).  Stage times come from
    CUDA events.  ``link_bw`` raises on a CUDA device: the link is real.

    On the CPU (``device="cpu"``) the executor keeps the reference's
    methodology: worker threads, and with ``link_bw`` (bytes/s) a sleep of
    ``bytes / link_bw`` in each transfer stage to emulate a link.
    """

    def __init__(self, fn: Callable[[Any], Any], *, num_streams: int = 2,
                 device: str | torch.device | None = None, link_bw: float | None = None):
        self.fn = fn
        self.num_streams = max(1, int(num_streams))
        self.device = resolve_device(device)
        self.cuda = self.device.type == "cuda"
        if self.cuda and link_bw is not None:
            raise ValueError(
                "HostStreamExecutor: link_bw emulates a link on the CPU only; on a "
                "CUDA device the H2D / D2H copies cross the real PCIe link")
        self.link_bw = link_bw
        self.streams = ([torch.cuda.Stream(self.device) for _ in range(self.num_streams)]
                        if self.cuda else [])
        self._out_like: Any = None  # one task's output, to preallocate D2H buffers

    # -- stage helpers ------------------------------------------------------

    @staticmethod
    def _nbytes(task: Any) -> int:
        return sum(t.numel() * t.element_size() for t in tree_leaves(task))

    def _link_delay(self, task: Any) -> None:
        if self.link_bw:
            time.sleep(self._nbytes(task) / self.link_bw)

    def _h2d(self, host_task: Any) -> Any:
        if self.cuda:
            return tree_map(lambda t: t.to(self.device, non_blocking=True), host_task)
        self._link_delay(host_task)
        return tree_map(lambda t: t.clone(), host_task)

    def _kex(self, dev_task: Any) -> Any:
        return self.fn(dev_task)

    def _d2h(self, dev_out: Any, host_buf: Any = None) -> Any:
        if self.cuda:
            if host_buf is None:
                host_buf = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                                          pin_memory=True), dev_out)
            tree_map(lambda h, d: h.copy_(d, non_blocking=True), host_buf, dev_out)
            return host_buf
        out = tree_map(lambda t: t.detach().clone(), dev_out)
        self._link_delay(out)
        return out

    def _check_pinned(self, host_tasks: Sequence[Any]) -> None:
        if self.cuda and not all(t.is_pinned() for task in host_tasks
                                 for t in tree_leaves(task)):
            raise ValueError(
                "HostStreamExecutor: host tasks must be pinned (tensor.pin_memory()); "
                "a copy from pageable memory is synchronous and overlaps nothing")

    def _out_buffers(self, n: int) -> list[Any]:
        """Pinned D2H buffers for ``n`` tasks, shaped like an earlier run's
        output (None each before any run)."""
        if self._out_like is None:
            return [None] * n
        return [tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, pin_memory=True),
                         self._out_like) for _ in range(n)]

    # -- execution modes ----------------------------------------------------

    def single_stream_run(self, host_tasks: Sequence[Any]) -> tuple[list[Any], StreamStats]:
        """Strictly stage by stage (paper S3.3): every H2D, then every KEX,
        then every D2H, each stage complete before the next starts."""
        if self.cuda:
            return self._single_cuda(host_tasks)
        stats = StreamStats()
        t0 = time.perf_counter()

        t = time.perf_counter()
        dev_tasks = [self._h2d(task) for task in host_tasks]
        stats.h2d = time.perf_counter() - t

        t = time.perf_counter()
        dev_outs = [self._kex(d) for d in dev_tasks]
        stats.kex = time.perf_counter() - t

        t = time.perf_counter()
        outs = [self._d2h(o) for o in dev_outs]
        stats.d2h = time.perf_counter() - t

        stats.wall = time.perf_counter() - t0
        return outs, stats

    def _single_cuda(self, host_tasks: Sequence[Any]) -> tuple[list[Any], StreamStats]:
        self._check_pinned(host_tasks)
        bufs = self._out_buffers(len(host_tasks))
        s = self.streams[0]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.cuda.stream(s):
            ev[0].record()
            dev_tasks = [self._h2d(task) for task in host_tasks]
            ev[1].record()
            torch.cuda.synchronize(self.device)
            ev[2].record()
            dev_outs = [self._kex(d) for d in dev_tasks]
            ev[3].record()
            torch.cuda.synchronize(self.device)
            ev[4].record()
            outs = [self._d2h(o, b) for o, b in zip(dev_outs, bufs)]
            ev[5].record()
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if dev_outs:
            self._out_like = dev_outs[0]
        stats = StreamStats(h2d=ev[0].elapsed_time(ev[1]) / 1e3,
                            kex=ev[2].elapsed_time(ev[3]) / 1e3,
                            d2h=ev[4].elapsed_time(ev[5]) / 1e3, wall=wall)
        return outs, stats

    def multi_stream_run(self, host_tasks: Sequence[Any]) -> tuple[list[Any], StreamStats]:
        """Pipelined execution: task i+1's H2D overlaps task i's KEX/D2H.

        Per-stage fields of the returned stats are busy times summed over
        tasks; because the stages overlap, their sum normally exceeds
        ``wall`` -- that excess is the hidden (overlapped) time the paper's
        pipeline buys.  On a CUDA device the tasks are dealt round-robin
        over the streams from this one host thread, each task's H2D issued
        one task ahead.
        """
        if self.cuda:
            return self._multi_cuda(host_tasks)
        stats = StreamStats()
        results: list[Any] = [None] * len(host_tasks)
        stages = [(0.0, 0.0, 0.0)] * len(host_tasks)
        t0 = time.perf_counter()

        def run_task(i: int, task: Any) -> None:
            s0 = time.perf_counter()
            dev = self._h2d(task)
            s1 = time.perf_counter()
            out = self._kex(dev)
            s2 = time.perf_counter()
            results[i] = self._d2h(out)
            stages[i] = (s1 - s0, s2 - s1, time.perf_counter() - s2)

        with _futures.ThreadPoolExecutor(max_workers=self.num_streams) as pool:
            futs = [pool.submit(run_task, i, t) for i, t in enumerate(host_tasks)]
            for f in futs:
                f.result()

        stats.h2d = sum(s[0] for s in stages)
        stats.kex = sum(s[1] for s in stages)
        stats.d2h = sum(s[2] for s in stages)
        stats.wall = time.perf_counter() - t0
        return results, stats

    def _multi_cuda(self, host_tasks: Sequence[Any]) -> tuple[list[Any], StreamStats]:
        """Task i runs on stream i % num_streams.  The host issues task
        i+1's H2D before task i's KEX, so the copy engine moves the next
        task while the SMs run this one even when issuing a KEX takes the
        host longer than running it."""
        self._check_pinned(host_tasks)
        n = len(host_tasks)
        bufs = self._out_buffers(n)
        start = torch.cuda.Event(enable_timing=True)
        # per task: H2D start, H2D end, KEX start, KEX end (= D2H start), D2H end
        events = [[torch.cuda.Event(enable_timing=True) for _ in range(5)] for _ in range(n)]
        stream = [self.streams[i % self.num_streams] for i in range(n)]
        dev: list[Any] = [None] * n
        outs, dev_outs = [], []

        def h2d(i: int) -> None:
            with torch.cuda.stream(stream[i]):
                events[i][0].record()
                dev[i] = self._h2d(host_tasks[i])
                events[i][1].record()

        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        start.record(self.streams[0])
        for s in self.streams[1:]:
            s.wait_event(start)
        if n:
            h2d(0)
        for i in range(n):
            if i + 1 < n:
                h2d(i + 1)
            with torch.cuda.stream(stream[i]):
                events[i][2].record()
                out = self._kex(dev[i])
                events[i][3].record()
                outs.append(self._d2h(out, bufs[i]))
                events[i][4].record()
            dev[i] = None
            dev_outs.append(out)
        torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        if dev_outs:
            self._out_like = dev_outs[0]
        stats = StreamStats(wall=wall)
        for i, ev in enumerate(events):
            at = [start.elapsed_time(e) / 1e3 for e in ev]
            stats.h2d += at[1] - at[0]
            stats.kex += at[3] - at[2]
            stats.d2h += at[4] - at[3]
            stats.intervals.append({"stream": i % self.num_streams, "h2d": (at[0], at[1]),
                                    "kex": (at[2], at[3]), "d2h": (at[3], at[4])})
        return outs, stats

    def measure_r(self, host_tasks: Sequence[Any]) -> tuple[float, StreamStats]:
        """Run stage by stage and return the paper's R (S3.3 methodology)."""
        _, stats = self.single_stream_run(host_tasks)
        return stats.stage_times().ratio(), stats


# ----------------------------------------------------------------------------
# Streaming plan: ties the decision flow together (paper S6's generic flow).
# ----------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """Output of the generic flow: decision + strategy + stream count."""

    category: dep.Category
    decision: str
    num_streams: int
    notes: str = ""


def plan_streaming(
    workload: dep.Workload,
    stage_times: rmetric.StageTimes,
    *,
    max_streams: int = 16,
    halo_elements: int = 0,
    task_elements: int = 1,
) -> StreamPlan:
    """The paper's generic flow (S6): R -> streamable? -> strategy.

    1. Compute R from stage-by-stage times; gate on the necessity band.
    2. Classify the task graph.
    3. For FALSE_DEPENDENT, apply the lavaMD halo-overhead check (S5).
    4. Pick the stream count from the pipeline model.
    """
    decision = rmetric.streaming_decision(stage_times)
    category = dep.classify(workload)

    if decision is not rmetric.StreamDecision.STREAM:
        return StreamPlan(category, decision.value, 1, "R outside the worthwhile band")
    if not category.streamable:
        return StreamPlan(category, "non-streamable", 1, f"{category.value} pattern")

    if category is dep.Category.FALSE_DEPENDENT and halo_elements > 0:
        overhead = halo_lib.halo_overhead_ratio(halo_elements, task_elements)
        if not halo_lib.halo_streaming_profitable(halo_elements, task_elements):
            return StreamPlan(
                category,
                "not-worthwhile",
                1,
                f"halo/task ratio {overhead:.2f} too large (lavaMD case)",
            )

    n = rmetric.optimal_streams(stage_times, max_streams=max_streams)
    return StreamPlan(category, "stream", n, "")
