"""Compiled ticks: the serving engine's steps as CUDA graphs, kept in small
LRU caches keyed as the reference keys its ``jax.jit`` functions
(``runtime/kv_cache._lru_jit``, ``serving._prefill_chunk_fn``).

A :class:`StepGraph` owns one step's static inputs: device tensors of a
fixed shape that the step function reads, filled before each run by
``copy_`` from pinned host staging (the host writes, then the H2D copy, in
stream order).  The state a step updates (page pools, the contiguous slot
cache, the b=1 request cache) is engine-owned and updated in place, never
replaced, so the addresses a graph captured stay valid.  On a CUDA device:

* the first run of a key is eager: the warm-up and the real work at once
  (it builds the kernels and initializes cuBLAS outside any capture);
* the second captures the step with ``torch.cuda.graph`` on the engine's
  one memory pool, then replays it (a capture executes nothing, so no side
  effect of the step runs twice);
* every later run replays.

A capture that fails raises: nothing falls back to eager on the card.  On
the CPU (no capture backend) the step runs eagerly over the same static
buffers, every time.

The graphs of one engine share its pool, so one graph's temporaries may
lie under another's outputs: an output is good until the engine's next
replay, and a caller that keeps one longer clones it.

Launch accounting: a kernel wrapper counts host calls
(``CudaKernel.launches``), so a capture would count launches that did not
run and a replay none.  A capture records each kernel's count difference
across it (the launches the graph holds), by part too
(``CudaKernel.parts``), takes those calls back out, and every replay adds
them again.
"""

from __future__ import annotations

import collections
import time
from typing import Any, Callable

import torch

from repro_torch.analysis.budget import sanctioned_sync
from repro_torch.kernels import _build

# The reference's caps: per-(len, first, pos0) prefill chunk functions
# (serving.py) and per-page-count scatter / gather / load functions
# (kv_cache.py).
_CHUNK_JIT_CAP = 32
_JIT_CACHE_CAP = 16


def lru_get(cache: collections.OrderedDict, key, make: Callable[[], Any], *,
            cap: int = _JIT_CACHE_CAP):
    """Fetch-or-build an entry of a small LRU cache (the reference's
    ``_lru_jit``): a hit moves ``key`` to the end, a miss builds it with
    ``make`` and drops the oldest entry past ``cap``."""
    if key in cache:  # an entry may be None: a step with nothing to capture
        cache.move_to_end(key)
        return cache[key]
    fn = make()
    cache[key] = fn
    if len(cache) > cap:
        cache.popitem(last=False)
    return fn


class CudaCapture:
    """The capture backend on a card: ``torch.cuda.graph`` on one memory
    pool shared by every graph of an engine."""

    def __init__(self, device: torch.device):
        self.device = device
        with torch.cuda.device(device):
            self.pool = torch.cuda.graph_pool_handle()

    def __call__(self, fn: Callable[[], Any]) -> tuple[Any, Any]:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph, pool=self.pool):
            out = fn()
        return graph, out


class Graphs:
    """An engine's graph state: its capture backend (a :class:`CudaCapture`
    on a card, none on the CPU, or a stand-in a test injects) and the counts
    of first runs (a step's eager first use), graphs captured, replays and
    seconds spent capturing."""

    def __init__(self, device: torch.device, capture: Callable | None = None):
        self.device = torch.device(device)
        if capture is None and self.device.type == "cuda":
            capture = CudaCapture(self.device)
        self.capture = capture
        self.first_runs = 0
        self.captured = 0
        self.replays = 0
        self.capture_s = 0.0


class StepGraph:
    """One step over static inputs: ``fn(**inputs)`` returns the step's
    outputs (a tensor, a tree of them, or None).  ``inputs`` maps each name
    to its (shape, dtype); calling the step with ``name=host array`` (or a
    tensor already on the device, copied on the device: whisper's encoder
    output) fills those buffers first, then runs, captures or replays as
    the module docstring says."""

    def __init__(self, graphs: Graphs, fn: Callable[..., Any],
                 inputs: dict[str, tuple[tuple[int, ...], torch.dtype]]):
        self.graphs = graphs
        self.fn = fn
        dev = graphs.device
        self.inputs = {n: torch.zeros(shape, dtype=dt, device=dev)
                       for n, (shape, dt) in inputs.items()}
        pinned = dev.type == "cuda"
        self._host = ({n: torch.zeros(t.shape, dtype=t.dtype, pin_memory=True)
                       for n, t in self.inputs.items()} if pinned else self.inputs)
        self._copied = torch.cuda.Event() if pinned else None
        self.uses = 0
        self.graph = None
        self.outputs = None
        self.launches: dict[_build.CudaKernel, int] = {}  # per replay
        self.parts: dict[_build.CudaKernel, dict[str, int]] = {}  # per replay, by part

    def _fill(self, values: dict[str, Any]) -> None:
        if self._copied is not None:
            # The staging may still feed the last run's copies.
            self._copied.synchronize()
        for name, v in values.items():
            if isinstance(v, torch.Tensor):  # on the device: no host staging
                self.inputs[name].copy_(v)
                continue
            self._host[name].numpy()[...] = v
            if self._copied is not None:
                self.inputs[name].copy_(self._host[name], non_blocking=True)
        if self._copied is not None:
            self._copied.record()

    def __call__(self, **values: Any) -> Any:
        self._fill(values)
        self.uses += 1
        if self.uses == 1:
            self.graphs.first_runs += 1
        if self.graphs.capture is None or self.uses == 1:
            return self.fn(**self.inputs)
        if self.graph is None:
            self._capture()
        self.graph.replay()
        for kernel, n in self.launches.items():
            kernel.launches += n
        for kernel, parts in self.parts.items():
            for part, n in parts.items():
                kernel.parts[part] = kernel.parts.get(part, 0) + n
        self.graphs.replays += 1
        return self.outputs

    def _capture(self) -> None:
        before = {k: k.launches for k in _build.KERNELS}
        parts_before = {k: dict(k.parts) for k in _build.KERNELS}
        t0 = time.perf_counter()
        # A capture synchronizes the device once (torch.cuda.graph's entry):
        # the live sync audit counts it as sanctioned.
        with sanctioned_sync("capture"):
            self.graph, self.outputs = self.graphs.capture(lambda: self.fn(**self.inputs))
        self.graphs.capture_s += time.perf_counter() - t0
        self.graphs.captured += 1
        for kernel, n in before.items():
            if kernel.launches != n:  # recorded, not run: taken back out
                self.launches[kernel] = kernel.launches - n
                kernel.launches = n
                was = parts_before[kernel]
                self.parts[kernel] = {p: c - was.get(p, 0) for p, c in kernel.parts.items()
                                      if c != was.get(p, 0)}
                kernel.parts = was
