"""Cluster-level streaming: collective <-> compute overlap (reference
``core/overlap.py``).

At cluster scale the "transfer" stage of the paper's pipeline is the
collective.  A blocking ``all-gather -> matmul`` serializes the two stages
exactly like the paper's single-stream baseline; the ring **collective
matmul** decomposes the gather into P-1 neighbour hops and overlaps each
hop with a chunk matmul -- the multi-stream pipeline, over
``torch.distributed``: hop i+1 is posted (``batch_isend_irecv``) before
chunk i's product and waited after it.

Both the blocking versions and the ring versions are provided, with the
reference's index arithmetic; the local products are plain
``torch.matmul``, as the reference computes them outside any Pallas
kernel.  ``core.costanalysis`` tells them apart: all-gather /
reduce-scatter bytes (blocking) against collective-permute bytes
(overlappable) -- each hop reports itself through :func:`ring_hop`, as
point-to-point traffic passes no dispatch mode.

The functions take local shards and a process group (one mesh axis:
``mesh.get_group(axis)``); :func:`make_sharded_ag_matmul` /
:func:`make_sharded_rs_matmul` wrap them over a mesh, as the reference's
``shard_map`` wrappers do.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.core import costanalysis
from repro_torch.launch.sharding import P, to_placements

_C10D = torch.ops._c10d_functional


def ring_hop(send: torch.Tensor, recv: torch.Tensor, group, *, to: int, src: int) -> list:
    """Post one hop of a ring: ``send`` to group rank ``to``, ``recv``
    from group rank ``src``.  Returns the works to wait on; reports the
    hop's bytes as a collective-permute to any active cost counter."""
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, to), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src), group)]
    costanalysis.note_collective("collective-permute", recv.numel() * recv.element_size())
    return dist.batch_isend_irecv(ops)


# ----------------------------------------------------------------------------
# Blocking references (single-stream analogue).
# ----------------------------------------------------------------------------


def ag_matmul_reference(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """y_local = all_gather(x) @ w_local -- transfer then compute (blocking).
    ``x``: (m_local, k) row shard; ``w``: (k, n_local) column shard.
    Returns (m_full, n_local)."""
    p = dist.get_world_size(group)
    x_full = _C10D.wait_tensor(_C10D.all_gather_into_tensor(x.contiguous(), p,
                                                            group.group_name))
    return x_full @ w


def rs_matmul_reference(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """y_local = reduce_scatter(x @ w_local_k) -- compute then transfer.
    ``x``: (m_full, k_local); ``w``: (k_local, n).  Returns (m_full / P,
    n): the summed partial products' rows of this rank."""
    p = dist.get_world_size(group)
    partial = x @ w
    return _C10D.wait_tensor(_C10D.reduce_scatter_tensor(partial.contiguous(), "sum", p,
                                                         group.group_name))


# ----------------------------------------------------------------------------
# Ring (streamed) versions: neighbour hops overlap chunk matmuls.
# ----------------------------------------------------------------------------


def ag_matmul_ring(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Streamed all-gather matmul: each of the P steps multiplies the x
    shard held into its row block of the output while the next shard is
    in flight on the ring (sent to the left neighbour).  Same math as
    :func:`ag_matmul_reference`; the gather becomes P-1 hops."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    m_local = x.shape[0]
    y = x.new_empty((m_local * p, w.shape[1]), dtype=torch.result_type(x, w))
    cur = x.contiguous()
    for i in range(p):
        works, nxt = [], None
        if i < p - 1:  # post the next hop before this chunk's product
            nxt = torch.empty_like(cur)
            works = ring_hop(cur, nxt, group, to=(idx - 1) % p, src=(idx + 1) % p)
        src = (idx + i) % p  # the shard held now came from rank idx + i
        y[src * m_local:(src + 1) * m_local] = (cur @ w).to(y.dtype)
        for work in works:
            work.wait()
        cur = nxt
    return y


def rs_matmul_ring(x: torch.Tensor, w: torch.Tensor, group) -> torch.Tensor:
    """Streamed reduce-scatter matmul: step i adds the partial product for
    the rank i + 2 hops behind to an accumulator circulating to the right;
    after P-1 hops every rank holds the fully reduced rows it owns.  Each
    hop overlaps the next chunk's product."""
    p, idx = dist.get_world_size(group), dist.get_rank(group)
    m_full = x.shape[0]
    if m_full % p:
        raise ValueError(f"rows {m_full} must divide the axis size {p}")
    m_local = m_full // p

    def chunk(j):  # partial product for the row block of rank idx - j
        owner = (idx - j) % p
        return x[owner * m_local:(owner + 1) * m_local] @ w

    acc = chunk(1).contiguous()  # the accumulator of owner idx - 1 starts here
    for i in range(p - 1):
        recv = torch.empty_like(acc)
        works = ring_hop(acc, recv, group, to=(idx + 1) % p, src=(idx - 1) % p)
        part = chunk(i + 2)
        for work in works:
            work.wait()
        acc = recv + part
    return acc


# ----------------------------------------------------------------------------
# Mesh wrappers (the reference's shard_map wrappers).
# ----------------------------------------------------------------------------


def _local_block(t: torch.Tensor, mesh, spec: P) -> torch.Tensor:
    if isinstance(t, DTensor):
        t = t.redistribute(mesh, to_placements(spec, mesh))
    else:  # every rank holds the whole tensor: keep this rank's block
        t = distribute_tensor(t, mesh, to_placements(spec, mesh), src_data_rank=None)
    return t.to_local()


def _sharded(fn, mesh, axis: str, in_specs, out_spec, out_shape) -> Callable:
    group = mesh.get_group(axis)

    def run(x, w):
        y = fn(_local_block(x, mesh, in_specs[0]), _local_block(w, mesh, in_specs[1]), group)
        shape = torch.Size(out_shape(x, w))
        return DTensor.from_local(y, mesh, to_placements(out_spec, mesh), run_check=False,
                                  shape=shape,
                                  stride=torch.empty(shape, device="meta").stride())

    return run


def make_sharded_ag_matmul(mesh, axis: str, *, ring: bool = True) -> Callable:
    """y = X @ W with X row-sharded and W column-sharded over ``axis``;
    returns a DTensor column-sharded over ``axis``."""
    return _sharded(ag_matmul_ring if ring else ag_matmul_reference, mesh, axis,
                    (P(axis, None), P(None, axis)), P(None, axis),
                    lambda x, w: (x.shape[0], w.shape[1]))


def make_sharded_rs_matmul(mesh, axis: str, *, ring: bool = True) -> Callable:
    """y = reduce_scatter(X @ W) with X column- and W row-sharded over
    ``axis``; returns a DTensor row-sharded over ``axis``."""
    return _sharded(rs_matmul_ring if ring else rs_matmul_reference, mesh, axis,
                    (P(None, axis), P(axis, None)), P(axis, None),
                    lambda x, w: (x.shape[0], w.shape[1]))
