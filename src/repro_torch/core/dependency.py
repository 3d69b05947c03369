"""Task-dependency categorization (paper S4.1, Table 2).

The paper classifies heterogeneous codes by analysing H2D -> KEX dependency
pairs between the *tasks* obtained from input/output partitioning:

  Non-streamable:
    SYNC       -- one H2D transfer is read by *all* tasks; the whole transfer
                  must finish before any kernel starts.
    ITERATIVE  -- the kernel re-runs many times on device-resident data; only
                  the first iteration's transfer could overlap, which is
                  negligible amortized over iterations.

  Streamable:
    INDEPENDENT     -- tasks share no data (paper: "embarrassingly
                       independent", e.g. nn).
    FALSE_DEPENDENT -- tasks share *read-only* inputs (RAR), e.g. FWT halos;
                       streamed by redundantly transferring boundaries.
    TRUE_DEPENDENT  -- task outputs feed other tasks (RAW), e.g. NW; streamed
                       by wavefront ordering.

Here a workload declares its tasks' read/write sets over named data regions
and the classifier reproduces the paper's analysis.  The port's copy of the
reference ``core/dependency.py`` (it imports nothing of it): the stream
engine (``repro_torch.core.streams``) uses it to pick a streaming strategy,
and ``classify_paper_suite`` re-derives the paper's categorization from
task graphs modeled on the benchmarks' access patterns.
:func:`step_footprint` is the analyzer's bridge into this vocabulary: the
reference's reads a jaxpr, the port's runs the eager step once and follows
its data by storage.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Any, Callable, Iterable, Sequence


class Category(enum.Enum):
    SYNC = "sync"
    ITERATIVE = "iterative"
    INDEPENDENT = "independent"
    FALSE_DEPENDENT = "false-dependent"
    TRUE_DEPENDENT = "true-dependent"

    @property
    def streamable(self) -> bool:
        return self in (
            Category.INDEPENDENT,
            Category.FALSE_DEPENDENT,
            Category.TRUE_DEPENDENT,
        )


@dataclasses.dataclass(frozen=True)
class Task:
    """One task: the unit mapped to a stream (H2D + KEX [+ D2H]).

    ``reads``/``writes`` are sets of region names.  A region represents a
    partition element of an input/output array (e.g. ``"x[0:4]"``) or a whole
    array (e.g. ``"weights"``).
    """

    name: str
    reads: frozenset[str]
    writes: frozenset[str]

    @staticmethod
    def make(name: str, reads: Iterable[str], writes: Iterable[str] = ()) -> "Task":
        return Task(name, frozenset(reads), frozenset(writes))


@dataclasses.dataclass(frozen=True)
class Workload:
    """A partitioned heterogeneous code.

    ``kernel_iterations`` models the paper's Iterative pattern: the number of
    times KEX re-runs on device-resident data per H2D.  ``sequential_kernel``
    models myocyte (a kernel that cannot be partitioned into >1 concurrent
    tasks at all).
    """

    name: str
    tasks: Sequence[Task]
    kernel_iterations: int = 1
    sequential_kernel: bool = False

    # Threshold above which overlapping only the first iteration is useless
    # (paper argues "a large number of iterations" kills the benefit).
    ITERATIVE_THRESHOLD: int = 8


def _shared_read_by_all(workload: Workload) -> frozenset[str]:
    """Regions read by every task (the SYNC pattern's shared H2D)."""
    if not workload.tasks:
        return frozenset()
    shared = set(workload.tasks[0].reads)
    for t in workload.tasks[1:]:
        shared &= t.reads
    return frozenset(shared)


def classify(workload: Workload) -> Category:
    """Reproduce the paper's categorization for one workload."""
    tasks = list(workload.tasks)

    # myocyte-style: kernel cannot be split into concurrent tasks.
    if workload.sequential_kernel or len(tasks) <= 1:
        return Category.SYNC

    # Iterative: KEX re-invoked many times once data is resident (S4.1).
    if workload.kernel_iterations >= workload.ITERATIVE_THRESHOLD:
        return Category.ITERATIVE

    # True dependence: some task reads a region another task writes (RAW).
    writers: dict[str, str] = {}
    for t in tasks:
        for region in t.writes:
            writers[region] = t.name
    for t in tasks:
        for region in t.reads:
            w = writers.get(region)
            if w is not None and w != t.name:
                return Category.TRUE_DEPENDENT

    # SYNC: a whole input is shared by ALL tasks -- its transfer must complete
    # before any task can start, so H2D cannot overlap per-task KEX.
    if _shared_read_by_all(workload):
        return Category.SYNC

    # False dependence: read-only sharing (RAR) between *some* (not all)
    # tasks -- halos can be transferred redundantly.
    read_count: dict[str, int] = defaultdict(int)
    for t in tasks:
        for region in t.reads:
            read_count[region] += 1
    if any(c > 1 for c in read_count.values()):
        return Category.FALSE_DEPENDENT

    return Category.INDEPENDENT


# ----------------------------------------------------------------------------
# Step footprints (the stream-safety analyzer's bridge into this vocabulary).
# ----------------------------------------------------------------------------


def step_footprint(
    fn: Callable[..., Any], labels: Sequence[tuple[str, Any]],
    out_regions: Sequence[str], kwargs: dict[str, Any] | None = None,
) -> tuple[frozenset[str], frozenset[str]]:
    """Region read/write sets of one engine step, from one run of it.

    The port's steps are eager functions that update engine-owned state in
    place (the page pools, the slot cache), so the footprint follows data,
    not a graph: ``fn(**kwargs)`` runs once under a dispatch mode that
    taints tensors by region.  ``labels`` pairs a region (``"params"``,
    ``"kv"``, ``"prompt"``, ...) with a tensor or a nested dict / sequence
    of them: the step's inputs and the engine state it closes over.  Taint
    lives on each tensor's untyped storage, so a write through a view
    (``leaf[:, pages] = ...``, ``index_copy_``) lands on its base.  Every
    op taints its outputs with the union of its inputs' taints; an op that
    mutates an argument (the aten schema's write alias) taints that
    argument's storage the same way.

    * **reads**: the regions whose taint reaches a returned tensor or an
      in-place write (the written tensor counts: a partial write keeps the
      rest of it).  A labelled input no output depends on drops out, as
      the reference's dead-code elimination drops an unused jaxpr input.
    * **writes**: ``out_regions`` (one region per returned value; the
      reference's outputs) plus every labelled region an op mutated.

    Returns ``(reads, writes)``, the vocabulary :class:`Task` uses.  Run it
    on throwaway state: the step's writes really happen.
    """
    import torch  # lazy: the stream engine imports this module
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    taint: dict[int, tuple[Any, set[str]]] = {}  # storage -> (kept alive, regions)
    owner: dict[int, set[str]] = {}  # labelled storage -> its regions
    reads: set[str] = set()
    writes: set[str] = set(out_regions)

    def tensors(tree) -> list:
        if isinstance(tree, dict):
            tree = list(tree.values())
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]

    def key(t) -> int:
        return t.untyped_storage()._cdata

    def regions(t) -> set[str]:
        hit = taint.get(key(t))
        return hit[1] if hit is not None else set()

    def add(t, src: set[str]) -> None:
        k = key(t)
        if k not in taint:
            taint[k] = (t.untyped_storage(), set())
        taint[k][1].update(src)

    for region, tree in labels:
        for t in tensors(tree):
            add(t, {region})
            owner.setdefault(key(t), set()).add(region)

    class _Taint(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            ins = tensors((args, kwargs))
            src = set().union(*(regions(t) for t in ins)) if ins else set()
            for i, arg in enumerate(func._schema.arguments):
                if arg.alias_info is None or not arg.alias_info.is_write:
                    continue
                value = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in tensors([value]):
                    reads.update(src)
                    writes.update(owner.get(key(t), ()))
                    add(t, src)
            for t in tensors([out]):
                add(t, src)
            return out

    with _Taint():
        out = fn(**(kwargs or {}))
    for t in tensors([out]):
        reads.update(regions(t))
    return frozenset(reads), frozenset(writes)


def unroll_stream(
    name: str,
    *,
    per_task_reads: Sequence[str],
    writes: Sequence[str] = ("out",),
    carrier: str | None = None,
    shared_reads: Sequence[str] = (),
    n_tasks: int = 4,
    kernel_iterations: int = 1,
    head: tuple[str, Sequence[str], Sequence[str]] | None = None,
    sequential_kernel: bool = False,
) -> Workload:
    """Unroll one step's footprint into the task stream the engine runs.

    A step's footprint is repeated: task ``t`` reads its own slice
    of each region in ``per_task_reads`` plus every ``shared_reads`` region
    whole; with ``carrier`` set (the RAW handoff — KV pages, SSM state)
    task ``t`` additionally reads the carrier slice task ``t-1`` wrote and
    writes its own, otherwise it writes its own slice of each region in
    ``writes``.  ``head`` prepends a one-shot stage task ``(name, reads,
    writes)`` (whisper's encode).
    """
    tasks: list[Task] = []
    if head is not None:
        hname, hreads, hwrites = head
        tasks.append(Task.make(hname, hreads, hwrites))
    for t in range(n_tasks):
        reads = {f"{r}[{t}]" for r in per_task_reads}
        reads.update(shared_reads)
        if carrier is not None:
            if t > 0:
                reads.add(f"{carrier}[{t - 1}]")
            task_writes = {f"{carrier}[{t}]"}
        else:
            task_writes = {f"{w}[{t}]" for w in writes}
        tasks.append(Task.make(f"t{t}", reads, task_writes))
    return Workload(name, tasks, kernel_iterations=kernel_iterations,
                    sequential_kernel=sequential_kernel)


# ----------------------------------------------------------------------------
# Model task graphs for the paper's benchmarks (Table 2 reproduction).
# ----------------------------------------------------------------------------


def _independent(name: str, n: int = 4) -> Workload:
    return Workload(
        name,
        [Task.make(f"t{i}", reads=[f"in[{i}]"], writes=[f"out[{i}]"]) for i in range(n)],
    )


def _false_dependent(name: str, n: int = 4) -> Workload:
    # Each task reads its block plus its neighbours' boundary (read-only).
    tasks = []
    for i in range(n):
        reads = {f"in[{i}]"}
        if i > 0:
            reads.add(f"in[{i - 1}]")  # halo
        if i < n - 1:
            reads.add(f"in[{i + 1}]")
        tasks.append(Task.make(f"t{i}", reads=reads, writes=[f"out[{i}]"]))
    return Workload(name, tasks)


def _true_dependent(name: str, n: int = 4) -> Workload:
    # Wavefront: task i reads the outputs of task i-1 (RAW chain).
    tasks = [Task.make("t0", reads=["in[0]"], writes=["out[0]"])]
    for i in range(1, n):
        tasks.append(
            Task.make(f"t{i}", reads=[f"in[{i}]", f"out[{i - 1}]"], writes=[f"out[{i}]"])
        )
    return Workload(name, tasks)


def _sync(name: str, n: int = 4) -> Workload:
    # All tasks read the full shared input (e.g. kmeans centroids broadcast).
    tasks = [
        Task.make(f"t{i}", reads=["shared", f"in[{i}]"], writes=[f"out[{i}]"])
        for i in range(n)
    ]
    return Workload(name, tasks)


def _iterative(name: str, iters: int = 100) -> Workload:
    return Workload(
        name,
        [Task.make(f"t{i}", reads=[f"in[{i}]"], writes=[f"out[{i}]"]) for i in range(4)],
        kernel_iterations=iters,
    )


#: Paper Table 2, as model task graphs.  (Representative subset of each cell;
#: streamcluster appears in two categories in the paper -- we model its two
#: H2D-KEX pairs separately.)
PAPER_TABLE2: dict[str, tuple[Workload, Category]] = {
    # Streamable / independent
    "nn": (_independent("nn"), Category.INDEPENDENT),
    "backprop": (_independent("backprop"), Category.INDEPENDENT),
    "kmeans-points": (_independent("kmeans-points"), Category.INDEPENDENT),
    "sgemm": (_independent("sgemm"), Category.INDEPENDENT),
    "VectorAdd": (_independent("VectorAdd"), Category.INDEPENDENT),
    "DotProduct": (_independent("DotProduct"), Category.INDEPENDENT),
    "Transpose": (_independent("Transpose"), Category.INDEPENDENT),
    "BlackScholes": (_independent("BlackScholes"), Category.INDEPENDENT),
    "Reduction": (_independent("Reduction"), Category.INDEPENDENT),
    "Histogram": (_independent("Histogram"), Category.INDEPENDENT),
    "PrefixSum": (_independent("PrefixSum"), Category.INDEPENDENT),
    "BinomialOption": (_independent("BinomialOption"), Category.INDEPENDENT),
    "MonteCarloAsian": (_independent("MonteCarloAsian"), Category.INDEPENDENT),
    # Streamable / false dependent (halo sharing, read-only)
    "FastWalshTransform": (_false_dependent("FastWalshTransform"), Category.FALSE_DEPENDENT),
    "ConvolutionSeparable": (_false_dependent("ConvolutionSeparable"), Category.FALSE_DEPENDENT),
    "ConvolutionFFT2D": (_false_dependent("ConvolutionFFT2D"), Category.FALSE_DEPENDENT),
    "lavaMD": (_false_dependent("lavaMD"), Category.FALSE_DEPENDENT),
    "stencil": (_false_dependent("stencil"), Category.FALSE_DEPENDENT),
    "BoxFilter": (_false_dependent("BoxFilter"), Category.FALSE_DEPENDENT),
    "RecursiveGaussian": (_false_dependent("RecursiveGaussian"), Category.FALSE_DEPENDENT),
    "MatrixMul": (_false_dependent("MatrixMul"), Category.FALSE_DEPENDENT),
    "MatVecMul": (_false_dependent("MatVecMul"), Category.FALSE_DEPENDENT),
    # Streamable / true dependent (RAW)
    "nw": (_true_dependent("nw"), Category.TRUE_DEPENDENT),
    "pathfinder": (_true_dependent("pathfinder"), Category.TRUE_DEPENDENT),
    "FDTD3d": (_true_dependent("FDTD3d"), Category.TRUE_DEPENDENT),
    "Tridiagonal": (_true_dependent("Tridiagonal"), Category.TRUE_DEPENDENT),
    "ScanLargeArrays": (_true_dependent("ScanLargeArrays"), Category.TRUE_DEPENDENT),
    "FloydWarshall": (_true_dependent("FloydWarshall"), Category.TRUE_DEPENDENT),
    # Non-streamable / SYNC
    "kmeans-centroids": (_sync("kmeans-centroids"), Category.SYNC),
    "bfs": (_sync("bfs"), Category.SYNC),
    "spmv": (_sync("spmv"), Category.SYNC),
    "tpacf": (_sync("tpacf"), Category.SYNC),
    "mri-q": (_sync("mri-q"), Category.SYNC),
    "cutcp": (_sync("cutcp"), Category.SYNC),
    "StringSearch": (_sync("StringSearch"), Category.SYNC),
    "myocyte": (
        Workload("myocyte", [Task.make("t0", reads=["in"], writes=["out"])],
                 sequential_kernel=True),
        Category.SYNC,
    ),
    # Non-streamable / Iterative
    "hotspot": (_iterative("hotspot"), Category.ITERATIVE),
    "srad": (_iterative("srad"), Category.ITERATIVE),
    "lud": (_iterative("lud"), Category.ITERATIVE),
    "gaussian": (_iterative("gaussian"), Category.ITERATIVE),
    "streamcluster-iter": (_iterative("streamcluster-iter"), Category.ITERATIVE),
    "lbm": (_iterative("lbm"), Category.ITERATIVE),
    "BitonicSort": (_iterative("BitonicSort"), Category.ITERATIVE),
    "RadixSort": (_iterative("RadixSort"), Category.ITERATIVE),
    "DwtHaar1D": (_iterative("DwtHaar1D"), Category.ITERATIVE),
}


def classify_paper_suite() -> dict[str, tuple[Category, Category, bool]]:
    """Classify every modeled benchmark: (predicted, expected, match)."""
    out = {}
    for name, (workload, expected) in PAPER_TABLE2.items():
        got = classify(workload)
        out[name] = (got, expected, got == expected)
    return out
