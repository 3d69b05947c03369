"""Sharding policy: path-based partition specs for params / opt state /
batch / caches (reference ``launch/sharding.py``), and their DTensor
placements.

Policy (single pod, mesh ("data", "model")):
  * 2-D weight (in, out):    in -> data (FSDP/ZeRO-3), out -> model (TP)
    ("wo"-style output projections are transposed: model, data)
  * embeddings (V, D):       V -> model (vocab-parallel), D replicated
  * MoE experts (E, D, F):   E -> model (expert parallel) when E divides the
    axis, else fall back to (D -> data, F -> model) tensor parallel
  * norms / scalars / small vectors: replicated
  * batch: leading dim over ("pod","data"); KV caches prefer heads -> model,
    falling back to sequence -> model when GQA head counts don't divide
    the axis.
Every rule checks divisibility and degrades to replication, so any
(arch x shape x mesh) combination produces a valid sharding.  Across pods,
parameters are replicated (grads all-reduce over ``pod``); only the batch
shards over ``pod``.

The rules are pure functions of a leaf's key path (a tuple of dict keys,
as ``core.tree.tree_paths`` gives), its shape and the mesh's axis sizes,
and return the reference's spec for every leaf (a test holds them equal).
A spec :class:`P` holds one entry per tensor dim: an axis name, a tuple of
names (major first), or None.  :func:`to_placements` turns it into
DTensor placements on a ``DeviceMesh``: an entry ``("pod", "data")`` puts
``Shard(d)`` on both mesh dims, so each rank holds the block that the
reference's ``NamedSharding`` gives its device.

What a rank computes with inside a step is decided by
``models.meshutil.compute_dim``: the one place that says which leaves
keep their ``model`` shard there.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.tree import tree_from_paths, tree_paths
from repro_torch.launch.mesh import axis_sizes

Params = Any


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("pod", "data"), None)``.
    A one-axis tuple entry is kept as the axis name, as JAX's
    ``PartitionSpec`` keeps it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _ax(mesh_sizes: dict[str, int], name: str, dim: int):
    """Use mesh axis ``name`` for a dim only if it divides evenly."""
    if name in mesh_sizes and dim % mesh_sizes[name] == 0:
        return name
    return None


def param_pspec(path: tuple, shape: tuple[int, ...], mesh_sizes: dict[str, int]) -> P:
    """Partition spec for one parameter leaf."""
    name = path[-1] if path else ""
    stacked = "blocks" in path  # stacked repeats: leading repeat dim
    dims = tuple(shape[1:]) if stacked else tuple(shape)

    def two_d(d_in: int, d_out: int, *, transposed: bool = False):
        if transposed:
            return [_ax(mesh_sizes, "model", d_in), _ax(mesh_sizes, "data", d_out)]
        return [_ax(mesh_sizes, "data", d_in), _ax(mesh_sizes, "model", d_out)]

    if name in ("embed", "unembed"):
        spec = [_ax(mesh_sizes, "model", dims[0]), None]
    elif name in ("wq", "wk", "wv", "wi", "wg", "in_proj"):
        if len(dims) == 3:  # MoE experts (E, D, F)
            e, d, f = dims
            if _ax(mesh_sizes, "model", e):
                spec = ["model", _ax(mesh_sizes, "data", d), None]
            else:
                spec = [None, _ax(mesh_sizes, "data", d), _ax(mesh_sizes, "model", f)]
        else:
            spec = two_d(*dims)
    elif name in ("wo", "out_proj"):
        if len(dims) == 3:  # MoE experts (E, F, D)
            e, f, d = dims
            if _ax(mesh_sizes, "model", e):
                spec = ["model", None, _ax(mesh_sizes, "data", d)]
            else:
                spec = [None, _ax(mesh_sizes, "model", f), _ax(mesh_sizes, "data", d)]
        else:
            spec = two_d(*dims, transposed=True)
    elif name in ("router", "shared_gate"):
        spec = [_ax(mesh_sizes, "data", dims[0]), None]
    elif name == "conv_w":
        spec = [None, _ax(mesh_sizes, "model", dims[1])]
    elif name == "conv_b":
        spec = [_ax(mesh_sizes, "model", dims[0])]
    else:
        # norms, A_log, D, dt_bias, biases: replicate
        spec = [None] * len(dims)

    if stacked:
        spec = [None] + spec
    if len(spec) != len(shape):
        raise ValueError(f"{'/'.join(path)}: spec {spec} for shape {shape}")
    return P(*spec)


def param_specs(shape_tree: Params, mesh) -> Params:
    """Spec tree matching a params (or grads / moments) tree."""
    sizes = axis_sizes(mesh)
    return tree_from_paths([(path, param_pspec(path, tuple(leaf.shape), sizes))
                            for path, leaf in tree_paths(shape_tree)])


def _strip(spec: P, axis: str) -> P:
    out = []
    for entry in spec:
        if entry == axis:
            out.append(None)
        elif isinstance(entry, tuple):
            kept = tuple(a for a in entry if a != axis)
            out.append(kept if kept else None)
        else:
            out.append(entry)
    return P(*out)


def drop_axis(param_spec_tree: Params, axis: str = "data") -> Params:
    """Remove one mesh axis from every spec (gather-once weights)."""
    if isinstance(param_spec_tree, P):
        return _strip(param_spec_tree, axis)
    return {k: drop_axis(v, axis) for k, v in param_spec_tree.items()}


def opt_state_specs(param_spec_tree: Params) -> Params:
    return {"m": param_spec_tree, "v": param_spec_tree, "count": P()}


# ----------------------------------------------------------------------------
# Batch / activations / caches
# ----------------------------------------------------------------------------


def batch_axes(mesh_sizes: dict[str, int], b: int):
    """Best axes tuple for the global-batch dim."""
    if "pod" in mesh_sizes:
        combined = mesh_sizes["pod"] * mesh_sizes["data"]
        if b % combined == 0:
            return ("pod", "data")
    if b % mesh_sizes.get("data", 1) == 0:
        return ("data",)
    return None


def batch_pspec(shape: tuple[int, ...], mesh_sizes: dict[str, int]) -> P:
    """Tokens / embeddings / masks: shard the leading (batch) dim."""
    ax = batch_axes(mesh_sizes, shape[0]) if shape else None
    return P(ax, *([None] * (len(shape) - 1)))


def cache_pspec(path: tuple, shape: tuple[int, ...], mesh_sizes: dict[str, int]) -> P:
    """KV / SSM cache leaves (leading repeat-stack dim)."""
    name = path[-1] if path else ""
    if name in ("k", "v", "cross_k", "cross_v"):
        r, b, s, h, hd = shape
        b_ax = batch_axes(mesh_sizes, b)
        h_ax = _ax(mesh_sizes, "model", h)
        s_ax = None
        if h_ax is None:
            s_ax = _ax(mesh_sizes, "model", s)
        if b_ax is None:
            # batch unshardable (e.g. long_500k b=1): spread seq over all axes
            if s_ax == "model":
                if "data" in mesh_sizes and s % (mesh_sizes["data"] * mesh_sizes["model"]) == 0:
                    s_ax = ("data", "model")
            elif _ax(mesh_sizes, "data", s):
                s_ax = ("data",) if s_ax is None else s_ax
        return P(None, b_ax, s_ax, h_ax, None)
    if name == "ssm":
        r, b, h, p_, n = shape
        b_ax = batch_axes(mesh_sizes, b)
        h_ax = _ax(mesh_sizes, "data", h) if b_ax is None else _ax(mesh_sizes, "model", h)
        return P(None, b_ax, h_ax, None, None)
    if name == "conv":
        r, b, w, c = shape
        return P(None, batch_axes(mesh_sizes, b), None, _ax(mesh_sizes, "model", c))
    return P(*([None] * len(shape)))


def cache_specs(shape_tree: Params, mesh) -> Params:
    sizes = axis_sizes(mesh)
    return tree_from_paths([(path, cache_pspec(path, tuple(leaf.shape), sizes))
                            for path, leaf in tree_paths(shape_tree)])


def batch_specs(shape_tree: Params, mesh) -> Params:
    sizes = axis_sizes(mesh)
    return {k: batch_pspec(tuple(v.shape), sizes) for k, v in shape_tree.items()}


def logits_pspec(mesh_sizes: dict[str, int], b: int, v: int) -> P:
    return P(batch_axes(mesh_sizes, b), None, _ax(mesh_sizes, "model", v))


# ----------------------------------------------------------------------------
# Specs -> DTensor placements
# ----------------------------------------------------------------------------


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def to_placements(spec: P, mesh) -> tuple:
    """DTensor placements (one per mesh dim) for ``spec``: ``Shard(d)`` on
    every mesh dim named in entry d, ``Replicate()`` elsewhere.  A tuple
    entry must name its axes in mesh order (major first), as DTensor
    splits a dim over several mesh dims in that order."""
    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec}: axis {a!r} not in mesh {tuple(names)}")
            idx.append(names.index(a))
        if idx != sorted(idx) or len(set(idx)) != len(idx):
            raise ValueError(f"spec {spec}: axes {axes} not in mesh order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: axis {names[i]!r} used twice")
            out[i] = Shard(d)
    return tuple(out)


def _map_specs(fn, tree: Params, specs: Params) -> Params:
    if isinstance(specs, P):
        return fn(tree, specs)
    return {k: _map_specs(fn, tree[k], specs[k]) for k in specs}


def local_block(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of a full leaf ``x`` placed by ``spec`` (a view):
    along dim d, part :func:`rank_index` of the entry's axes, of as many
    equal parts as they have ranks."""
    sizes = axis_sizes(mesh)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if axes:
            ways = math.prod(sizes[a] for a in axes)
            if x.shape[d] % ways:
                raise ValueError(f"spec {spec}: dim {d} of {tuple(x.shape)} does not "
                                 f"split {ways} ways")
            n = x.shape[d] // ways
            x = x.narrow(d, rank_index(mesh, axes) * n, n)
    return x


def distribute(tree: Params, specs: Params, mesh) -> Params:
    """Every leaf as a DTensor placed by its spec (the twin of
    ``jax.device_put(tree, to_named(specs, mesh))``).  Each rank must hold
    the same full leaf, on any device (the host, for a state larger than a
    card): it copies only its own block to the mesh's device, with no
    communication."""
    return _map_specs(lambda x, spec: place(x, spec, mesh), tree, specs)


def place(x: torch.Tensor, spec: P, mesh) -> DTensor:
    """One leaf of :func:`distribute`.  ``from_local`` wraps a view of the
    block; the ``detach`` leaves a DTensor whose local tensor is no view,
    as ``distribute_tensor``'s is."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    x = x.detach()
    local = local_block(x, spec, mesh).to(mesh.device_type, copy=True).contiguous()
    return DTensor.from_local(local, mesh, to_placements(spec, mesh), run_check=False,
                              shape=x.shape, stride=x.stride()).detach()


def shaped(tree_of_shapes: Params, specs: Params, mesh) -> Params:
    """The dry run's inputs: a tree of fake (or meta) tensors as DTensors
    placed by ``specs`` (the twin of ``ShapeDtypeStruct(sharding=)``)."""
    return distribute(tree_of_shapes, specs, mesh)


def rank_index(mesh, axes: tuple[str, ...]) -> int:
    """This rank's block index over ``axes`` (major first)."""
    sizes = axis_sizes(mesh)
    idx = 0
    for a in axes:
        idx = idx * sizes[a] + mesh.get_local_rank(a)
    return idx


def _batch_layout(shape: tuple, mesh, accum: int) -> tuple[P, tuple[str, ...], int]:
    """(spec, batch axes, ways) of a global batch leaf of ``shape``: the
    spec of one micro-batch (:func:`batch_pspec`)."""
    b, rest = shape[0], tuple(shape[1:])
    if b % accum:
        raise ValueError(f"batch of {b} rows is not a multiple of accum {accum}")
    sizes = axis_sizes(mesh)
    spec = batch_pspec((b // accum, *rest), sizes)
    axes = _axes_of(spec[0])
    return spec, axes, math.prod(sizes[a] for a in axes)


def local_batch(batch: dict, mesh, *, accum: int = 1) -> dict:
    """This rank's rows of a global batch (numpy arrays or tensors; every
    rank holds the same batch), micro-batch major: micro-batch i of
    ``accum`` is global rows ``[i B / accum, (i + 1) B / accum)``, as the
    reference splits it, and this rank holds its share of each in turn."""
    out = {}
    for k, x in batch.items():
        _, axes, ways = _batch_layout(tuple(x.shape), mesh, accum)
        b, rest = x.shape[0], tuple(x.shape[1:])
        rows = x.reshape(accum, ways, b // (accum * ways), *rest)[:, rank_index(mesh, axes)]
        out[k] = rows.reshape(-1, *rest)
    return out


def from_local_batch(local: dict, mesh, *, global_batch: int, accum: int = 1) -> dict:
    """:func:`local_batch`'s rows as DTensors sharded by the batch spec of
    a ``global_batch``-row batch.  With ``accum > 1`` a DTensor's global
    view lists the rows micro-batch major, not in the batch's order."""
    out = {}
    for k, x in local.items():
        shape = (global_batch, *x.shape[1:])
        spec, _, _ = _batch_layout(shape, mesh, accum)
        out[k] = DTensor.from_local(x.contiguous(), mesh, to_placements(spec, mesh),
                                    run_check=False, shape=torch.Size(shape),
                                    stride=torch.empty(shape, device="meta").stride())
    return out


def distribute_batch(batch: dict, mesh, *, accum: int = 1) -> dict:
    """This rank's rows of a global batch of tensors as DTensors
    (:func:`local_batch`, :func:`from_local_batch`)."""
    b = next(iter(batch.values())).shape[0]
    return from_local_batch(local_batch(batch, mesh, accum=accum), mesh, global_batch=b,
                            accum=accum)
