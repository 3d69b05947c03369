"""The mesh as the model code sees it (reference ``models/meshutil.py``),
and the collectives of a sharded step.

``with use_mesh(mesh, batch_axes=...):`` installs a mesh for the code
inside (torch has no ``with mesh:``); :func:`current_mesh` reads it.
``batch_axes`` names the mesh axes that this step's batch rows are
sharded over (each rank holds its own rows).  Without a mesh every helper
here is a no-op, as in the reference.

Inside a step the model works on local tensors:

* :func:`gather` turns one stored parameter (a DTensor) into what a
  rank computes with: gathered off every axis but ``model``, and off
  ``model`` too unless :func:`compute_dim` keeps the leaf's tensor-parallel
  shard (FSDP's all-gather; its backward reduce-scatters the gradient
  where it is a sum over the axis -- a batch axis --, else keeps this
  rank's block of it).  What the gradient still owes is declared to
  DTensor with ``to_local(grad_placements=...)``: a ``Partial`` sum over
  each batch axis the leaf is replicated on (and over ``model`` for a
  whole leaf used on a rank's own heads); the step then reduces it onto
  the stored placement.  Without ``grad_placements`` DTensor would take
  such a gradient for the replicated whole: every rank would train those
  leaves on its own rows alone, with no error.
* :func:`to_model_parallel` / :func:`from_model_parallel` bracket a
  tensor-parallel region (Megatron's f and g): identity forward and
  all-reduce backward at its input, all-reduce forward and identity
  backward at its output, over ``model``.
* :func:`gather_rows` / :func:`own_rows` give a MoE layer the whole
  micro-batch (routing and capacity are decided over every row, as the
  reference's single program does) and take this rank's rows back.
* :func:`batch_sum` sums a value over the batch axes (no gradient).

The collectives are ``_c10d_functional`` ops: the dispatcher sees them
(so ``core.costanalysis`` counts them), and they run under the dry run's
fake process group and ``FakeTensorMode``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

_C10D = torch.ops._c10d_functional


@dataclasses.dataclass(frozen=True)
class MeshContext:
    mesh: object  # a DeviceMesh
    batch_axes: tuple[str, ...] = ()

    @property
    def sizes(self) -> dict[str, int]:
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.shape))

    @property
    def batch_ways(self) -> int:
        return math.prod(self.sizes[a] for a in self.batch_axes)

    @property
    def model_size(self) -> int:
        return self.sizes.get("model", 1)


_local = threading.local()


@contextlib.contextmanager
def use_mesh(mesh, *, batch_axes: tuple[str, ...] = ()):
    """Install ``mesh`` (and the axes the batch rows are sharded over) for
    the model code run inside, on this thread."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = MeshContext(mesh, tuple(batch_axes))
    try:
        yield _local.ctx
    finally:
        _local.ctx = prev


def current() -> MeshContext | None:
    return getattr(_local, "ctx", None)


def current_mesh():
    """The mesh installed by ``use_mesh``, or None."""
    ctx = current()
    return ctx.mesh if ctx is not None else None


def batch_axes_for(b: int, sizes: dict[str, int]):
    if "pod" in sizes and "data" in sizes:
        if b % (sizes["pod"] * sizes["data"]) == 0:
            return ("pod", "data")
    if "data" in sizes and b % sizes["data"] == 0:
        return ("data",)
    return None


def shard_spec(x: torch.Tensor, *axes) -> torch.Tensor:
    """Place a DTensor by ``axes`` (dropping non-dividing / missing ones);
    a local tensor, or no mesh: ``x`` as it is (a rank's rows are already
    its own)."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    sizes = ctx.sizes
    names = list(ctx.mesh.mesh_dim_names)

    def ok(a, dim):
        if a is None:
            return ()
        a = (a,) if isinstance(a, str) else tuple(a)
        if all(n in sizes for n in a) and dim % math.prod(sizes[n] for n in a) == 0:
            return a
        return ()

    placements = [Replicate()] * len(names)
    for d, (a, dim) in enumerate(zip(axes, x.shape)):
        for n in ok(a, dim):
            placements[names.index(n)] = Shard(d)
    return x.redistribute(ctx.mesh, placements)


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """Shard the leading (batch) dim over the data axes (see
    :func:`shard_spec`)."""
    ctx = current()
    if ctx is None:
        return x
    return shard_spec(x, batch_axes_for(x.shape[0], ctx.sizes), *([None] * (x.dim() - 1)))


# ----------------------------------------------------------------------------
# What a rank computes with
# ----------------------------------------------------------------------------

#: Leaves that keep their ``model`` shard inside a step (tensor
#: parallelism): the projections of a self-attention mixer (column-parallel
#: ``wq`` / ``wk`` / ``wv`` by head, row-parallel ``wo``) when both the
#: query and the KV heads divide the axis, and the dense FFN (``wi`` /
#: ``wg`` columns, ``wo`` rows) when ``d_ff`` does.  Every other leaf is
#: gathered whole over ``model`` at the compute boundary and keeps its
#: sharded placement for storage and AdamW only: embed / unembed (no
#: vocab-parallel cross-entropy), norms and qk-norms, the MoE router,
#: experts and shared expert (no expert parallelism), mamba's ``in_proj``
#: / ``out_proj`` / ``conv_*`` (no mamba TP), the cross-attention block,
#: and attention whose KV heads do not divide the axis (the reference
#: then still shards ``wk``'s flat ``kv * hd`` dim, splitting a head,
#: which a per-head kernel cannot take).
_TP_COLUMNS = {"mixer": ("wq", "wk", "wv"), "ffn": ("wi", "wg")}
_TP_ROWS = {"mixer": ("wo",), "ffn": ("wo",)}


def compute_dim(cfg, layer_spec, parent: str, name: str, model_size: int) -> int | None:
    """The dim of one repeat's leaf ``parent/.../name`` (no repeat axis)
    that stays sharded over ``model`` inside a step, or None: gathered
    whole."""
    if model_size <= 1 or parent not in _TP_COLUMNS:
        return None
    if parent == "mixer":
        if layer_spec.mixer not in ("attn", "attn_local"):
            return None
        if cfg.n_heads % model_size or cfg.n_kv_heads % model_size:
            return None
    elif layer_spec.ffn != "dense" or cfg.d_ff % model_size:
        return None
    if name in _TP_COLUMNS[parent]:
        return 1
    if name in _TP_ROWS[parent]:
        return 0
    return None


def _grad_placements(target, names, sum_axes):
    """The gradient's placements of a gathered leaf: a sum over
    ``sum_axes`` (each rank's rows, or heads, give part of it), ``target``
    elsewhere."""
    return [Partial() if n in sum_axes else t for n, t in zip(names, target)]


class _GatherShards(torch.autograd.Function):
    """All-gather a local shard along tensor dims over mesh dims (``plan``:
    (group, n, dim, this rank's coordinate, reduce) innermost mesh dim
    first); backward: reduce-scatter the gradient where it is a sum over
    that mesh dim (``reduce``), else keep this rank's block."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan = plan
        for group, n, dim, _, _ in plan:
            x = _all_gather(x.movedim(dim, 0), n, group).movedim(0, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for group, n, dim, coord, reduce in reversed(ctx.plan):
            if reduce:
                g = _reduce_scatter(g.movedim(dim, 0), n, group).movedim(0, dim)
            else:
                size = g.shape[dim] // n
                g = g.narrow(dim, coord * size, size)
        return g, None


def gather(x, keep_dim: int | None = None, *, in_tp: bool = False) -> torch.Tensor:
    """What this rank computes with for stored leaf ``x``: a DTensor
    gathered off every mesh axis but ``model``, where it keeps
    ``Shard(keep_dim)`` (or is gathered too when ``keep_dim`` is None); a
    local tensor as it is.  ``in_tp``: a whole leaf used inside a
    tensor-parallel region (the qk-norm scales, applied to a rank's own
    heads), whose gradient is then also a sum over ``model``."""
    if not isinstance(x, DTensor):
        return x
    ctx = current()
    batch_axes = ctx.batch_axes if ctx is not None else ()
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    target = [Replicate()] * len(names)
    if keep_dim is not None:
        m = names.index("model")
        if x.placements[m] != Shard(keep_dim):
            raise ValueError(f"leaf placed {x.placements} cannot keep Shard({keep_dim}) "
                             "over model")
        target[m] = Shard(keep_dim)
    sum_axes = batch_axes + (("model",) if in_tp and keep_dim is None else ())
    # a mesh dim of size 1 holds the whole leaf: nothing to gather or sum
    wide = [n for n, size in zip(names, mesh.shape) if size > 1]
    sum_axes = tuple(a for a in sum_axes if a in wide)
    plan, kept = [], []
    for i in reversed(range(len(names))):
        cur = x.placements[i]
        if names[i] in wide and isinstance(cur, Shard) and cur != target[i]:
            plan.append((_group(mesh, names[i]), mesh.shape[i], cur.dim,
                         mesh.get_local_rank(names[i]), names[i] in sum_axes))
    for i, n in enumerate(names):  # what the gradient of the local shard still owes
        gathered = isinstance(x.placements[i], Shard) and x.placements[i] != target[i]
        kept.append(x.placements[i] if gathered or n not in wide else target[i])
    local = x.to_local(grad_placements=_grad_placements(
        kept, names, [n for i, n in enumerate(names)
                      if n in sum_axes and not isinstance(kept[i], Shard)]))
    return _GatherShards.apply(local, tuple(plan)) if plan else local


def gather_unit(cfg, unit, bp: dict) -> dict:
    """One repeat's stored leaves (``{"layer<j>": ...}``) as this rank
    computes with them (:func:`compute_dim` decides each)."""
    ctx = current()
    m = ctx.model_size if ctx is not None else 1

    def walk(tree, spec, parent):
        in_tp = parent is not None and compute_dim(cfg, spec, parent, "wo", m) is not None
        return {k: walk(v, spec, parent or k) if isinstance(v, dict)
                else gather(v, compute_dim(cfg, spec, parent or k, k, m), in_tp=in_tp)
                for k, v in tree.items()}

    return {name: walk(bp[name], spec, None)
            for name, spec in ((f"layer{j}", s) for j, s in enumerate(unit))}


# ----------------------------------------------------------------------------
# Collectives with their backwards
# ----------------------------------------------------------------------------


def _group(mesh, axis: str) -> str:
    return mesh.get_group(axis).group_name


def _all_reduce(x: torch.Tensor, group: str) -> torch.Tensor:
    return _C10D.wait_tensor(_C10D.all_reduce(x.contiguous(), "sum", group))


def _all_gather(x: torch.Tensor, n: int, group: str) -> torch.Tensor:
    return _C10D.wait_tensor(_C10D.all_gather_into_tensor(x.contiguous(), n, group))


def _reduce_scatter(x: torch.Tensor, n: int, group: str) -> torch.Tensor:
    return _C10D.wait_tensor(_C10D.reduce_scatter_tensor(x.contiguous(), "sum", n, group))


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    """All-gather dim 0 over ``groups`` (innermost axis first); backward:
    reduce-scatter the summed gradient back (outermost first)."""

    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        for n, g in groups:
            x = _all_gather(x, n, g)
        return x

    @staticmethod
    def backward(ctx, g):
        for n, grp in reversed(ctx.groups):
            g = _reduce_scatter(g, n, grp)
        return g, None


def _model_group(ctx: MeshContext | None) -> str | None:
    if ctx is None or ctx.model_size <= 1:
        return None
    return _group(ctx.mesh, "model")


def to_model_parallel(x: torch.Tensor) -> torch.Tensor:
    """Enter a tensor-parallel region: ``x`` (replicated over ``model``)
    as it is; its gradient summed over ``model`` in the backward."""
    g = _model_group(current())
    return x if g is None else _CopyToModel.apply(x, g)


def from_model_parallel(x: torch.Tensor) -> torch.Tensor:
    """Leave a tensor-parallel region: the partial sums of ``x`` summed
    over ``model``."""
    g = _model_group(current())
    return x if g is None else _ReduceFromModel.apply(x, g)


def _row_groups(ctx: MeshContext | None) -> tuple:
    if ctx is None or ctx.batch_ways <= 1:
        return ()
    return tuple((ctx.sizes[a], _group(ctx.mesh, a)) for a in reversed(ctx.batch_axes))


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0), in global order."""
    groups = _row_groups(current())
    return _GatherRows.apply(x, groups) if groups else x


def own_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor that :func:`gather_rows` made whole."""
    ctx = current()
    if ctx is None or ctx.batch_ways <= 1:
        return x
    n = x.shape[0] // ctx.batch_ways
    idx = 0
    for a in ctx.batch_axes:
        idx = idx * ctx.sizes[a] + ctx.mesh.get_local_rank(a)
    return x[idx * n:(idx + 1) * n]


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch axes (no gradient): a rank's share of a
    global sum made whole."""
    ctx = current()
    if ctx is None or ctx.batch_ways <= 1:
        return x
    x = x.detach()
    for a in ctx.batch_axes:
        x = _all_reduce(x, _group(ctx.mesh, a))
    return x
