"""Cost analysis of a traced step: the port's twin of the reference's
``core/hloanalysis.py`` walker and of rmetric's HLO readers.

The port compiles no HLO.  What it has is the stream of ATen ops a step
dispatches, so :class:`CostCounter` (a ``TorchDispatchMode``) counts them
as they run, on real, fake (``FakeTensorMode``) or meta tensors, and
returns the reference's :class:`CostTotals`:

  * **flops**: torch's own formula for each op it knows
    (``torch.utils.flop_counter``: 2 x m x k x n a product, the attention
    and convolution ops), on the shapes each rank computes with (a
    DTensor's local shard); a loop of n repeats counts n times because
    it dispatches n times, which is what the reference recovers from
    ``while`` trip counts.
  * **bytes**: each op that moves data reads its inputs and writes its
    outputs once (views, ``wait_tensor`` and metadata ops are free), as
    the reference counts each top-level HLO instruction once.  Eager ops
    are not fused, so this counts more traffic than the fused program
    the reference reads.
  * **collective_bytes** / **collective_by_op**, keyed by the reference's
    names: all-gather, all-to-all and collective-permute count output
    bytes, all-reduce 2x (ring = reduce-scatter + all-gather),
    reduce-scatter its (larger) input.  The ``_c10d_functional`` ops (what
    DTensor and ``models.meshutil`` issue) are counted by the mode;
    point-to-point hops go through the process group, where no mode sees
    them, so ``core.overlap.ring_hop`` reports each one through
    :func:`note_collective` as a collective-permute.
  * **kernels**: a hand-written kernel's call (the prefill and SSD
    kernels' wrappers) goes through :func:`as_kernel`, which counts the
    kernel's own flops and bytes and none of the ops that run it -- on the
    CPU its plain version, whose score matrices and other temporaries the
    kernel keeps on chip.

It also follows the bytes of the tensors that ops create and that are
still alive (``peak_live_bytes``): the dry run's stand-in for
``memory_analysis()``'s temporaries.
"""

from __future__ import annotations

import dataclasses
import threading
import weakref
from typing import Any, Mapping, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: Dispatcher collectives -> (reference name, what the wire carries).
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": ("all-gather", "out"),
    "all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "all_reduce": ("all-reduce", "2out"),
    "all_reduce_coalesced": ("all-reduce", "2out"),
    "reduce_scatter_tensor": ("reduce-scatter", "in"),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", "in"),
    "all_to_all_single": ("all-to-all", "out"),
    "allgather_": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "out"),
    "allreduce_": ("all-reduce", "2out"),
    "reduce_scatter_": ("reduce-scatter", "in"),
    "_reduce_scatter_base_": ("reduce-scatter", "in"),
    "alltoall_base_": ("all-to-all", "out"),
}

#: Ops that move no data.
_FREE = {"wait_tensor", "detach", "alias", "lift_fresh", "_to_copy_meta", "empty",
         "empty_strided", "empty_like", "new_empty", "new_empty_strided", "sym_size",
         "sym_stride", "sym_numel", "sym_storage_offset", "_local_scalar_dense",
         "set_", "resize_", "record_stream"}


@dataclasses.dataclass
class CostTotals:
    """A rank's totals (the reference's ``CostTotals`` fields)."""

    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_op: dict[str, float] = dataclasses.field(
        default_factory=lambda: {op: 0.0 for op in COLLECTIVES})


def _local(t):
    """A DTensor's local shard (what this rank moves); else ``t``."""
    inner = getattr(t, "_local_tensor", None)
    return inner if inner is not None else t


def _nbytes(t) -> int:
    t = _local(t)
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(tree, out=None) -> list[torch.Tensor]:
    """Every tensor in nested lists / tuples / dicts (a DTensor's local
    shard in its place)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(_local(tree))
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


_active = threading.local()


def note_collective(op: str, nbytes: float) -> None:
    """Report a collective that no dispatch mode sees (a point-to-point
    hop) to every :class:`CostCounter` active on this thread."""
    if op not in COLLECTIVES:
        raise ValueError(f"unknown collective {op!r}")
    for counter in getattr(_active, "stack", ()):
        counter.totals.collective_bytes += nbytes
        counter.totals.collective_by_op[op] += nbytes
        counter.totals.bytes += 2 * nbytes


def as_kernel(fn, cost):
    """``fn()``, one call of a hand-written kernel by whichever route its
    tensors pick.  Every :class:`CostCounter` active on this thread counts
    it as the kernel: one op of ``cost()`` = (flops, bytes), and the
    outputs as live; the ops ``fn`` dispatches are not counted and their
    temporaries never live.  Without a counter it is ``fn()``."""
    stack = getattr(_active, "stack", None)
    if not stack:
        return fn()
    for counter in stack:
        counter._muted += 1
    try:
        out = fn()
    finally:
        for counter in stack:
            counter._muted -= 1
    flops, nbytes = cost()
    for counter in stack:
        counter.ops += 1
        counter.totals.flops += flops
        counter.totals.bytes += nbytes
        for t in _tensors(out):
            counter._track(t)
    return out


class CostCounter(TorchDispatchMode):
    """``with CostCounter() as c: step(...)``; then ``c.totals``
    (:class:`CostTotals`), ``c.ops`` (ops dispatched) and
    ``c.peak_live_bytes`` (the most bytes held at once by tensors that
    ops under the counter created, views not double-counted)."""

    def __init__(self):
        super().__init__()
        self.totals = CostTotals()
        self.ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._refs: dict[int, int] = {}  # storage key -> live tensors seen on it
        self._muted = 0  # inside an as_kernel call

    def __enter__(self):
        stack = getattr(_active, "stack", None)
        if stack is None:
            stack = _active.stack = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _active.stack.remove(self)
        return super().__exit__(*exc)

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key not in self._refs:
            self._refs[key] = 0
            self.live_bytes += st.nbytes()
            self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key, st.nbytes())

    def _release(self, key: int, nbytes: int) -> None:
        n = self._refs.get(key, 0) - 1
        if n > 0:
            self._refs[key] = n
            return
        self._refs.pop(key, None)
        self.live_bytes -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._muted:
            return out
        self.ops += 1
        name = func._overloadpacket.__name__
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        for t in outs:
            self._track(t)
        if name in _COLLECTIVE_OPS:
            op, carried = _COLLECTIVE_OPS[name]
            in_b, out_b = sum(map(_nbytes, ins)), sum(map(_nbytes, outs))
            wire = {"out": out_b, "2out": 2.0 * out_b, "in": in_b}[carried]
            self.totals.collective_bytes += wire
            self.totals.collective_by_op[op] += wire
            self.totals.bytes += in_b + out_b
            return out
        if name in _FREE or func.is_view:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            local_args = tuple(_local(a) for a in args)
            self.totals.flops += flop_registry[packet](*local_args, **kwargs, out_val=out)
        self.totals.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out


def analyse(fn, *args, **kwargs) -> tuple[Any, CostTotals]:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter`: (its
    result, the totals)."""
    with CostCounter() as c:
        out = fn(*args, **kwargs)
    return out, c.totals


# ----------------------------------------------------------------------------
# The reference's rmetric readers, over CostTotals
# ----------------------------------------------------------------------------


def collective_bytes_from_hlo(cost: CostTotals) -> dict[str, float]:
    """The reference's ``rmetric.collective_bytes_from_hlo`` (bytes of every
    collective by kind, plus "total"), read from a :class:`CostTotals` --
    the port has no HLO text; the name is kept for its callers."""
    out = dict(cost.collective_by_op)
    out["total"] = sum(cost.collective_by_op.values())
    return out


def cost_analysis_scalars(cost: CostTotals | Mapping[str, float]
                          | Sequence[Mapping[str, float]]) -> tuple[float, float]:
    """(flops, bytes accessed): the reference's
    ``rmetric.cost_analysis_scalars``, reading a :class:`CostTotals` (or
    the reference's dict / list-of-dict form of ``cost_analysis()``)."""
    if isinstance(cost, CostTotals):
        return float(cost.flops), float(cost.bytes)
    if isinstance(cost, Sequence) and not isinstance(cost, (str, bytes)):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    nbytes = float(cost.get("bytes accessed", 0.0))
    if nbytes == 0.0:
        nbytes = sum(float(v) for k, v in cost.items()
                     if isinstance(k, str) and k.startswith("bytes accessed"))
    return flops, nbytes
