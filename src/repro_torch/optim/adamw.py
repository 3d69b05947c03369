"""AdamW with decoupled weight decay and global-norm clipping (reference
``optim/adamw.py``), over the port's nested-dict params.

Moments are kept in ``moment_dtype`` (f32 by default, bf16 where the state
would not fit otherwise); the update math runs in f32 whatever the param
and moment types.  Bias correction uses the step count after the update
(``count + 1``), clipping scales every grad by ``grad_clip / global norm``
when the norm exceeds it, and decay applies to every leaf with ``ndim >=
2`` -- in this layout every block leaf carries the repeat axis, so the
stacked norm scales ``(r, D)`` are decayed too, as in the reference.

:func:`apply_updates` writes the new values into the params and moments
it is given (the reference returns new arrays; a second copy of a
4B-parameter model's state would not fit beside the first on an 80 GB
card, so the training step commits in place).  Every scalar of the step
(the norm, the clip scale, the LR, the bias corrections) is computed before
the first write, and each leaf is updated in slices of at most
``SLICE`` elements, so the only allocations during the writes are one
slice's f32 temporaries; should the writes still fail part way,
:class:`CommitError` says that the state is half-updated.

Over a device mesh the params, grads and moments are DTensors of equal
placements: the update runs on each rank's local shards, and the global
norm counts every element once (:func:`global_norm`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.core.tree import tree_map, tree_paths

Params = dict
SLICE = 1 << 24  # elements of one leaf updated at a time (64 MiB of f32)


class CommitError(RuntimeError):
    """An in-place update failed after it began writing: some leaves hold
    the new values, some the old."""


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    schedule: Callable[[torch.Tensor], torch.Tensor] | None = None  # step -> lr scale
    moment_dtype: Any = torch.float32


def init_state(params: Params, moment_dtype=torch.float32) -> dict[str, Any]:
    """Zero moments shaped (and, for DTensor params, placed) as the params,
    and a 0-d int32 step count, on the params' device."""
    zeros = lambda p: torch.zeros_like(p, dtype=moment_dtype)  # noqa: E731
    dev = _local(tree_paths(params)[0][1]).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1)
    parts = [flat[i:i + SLICE].float().square().sum() for i in range(0, flat.numel(), SLICE)]
    return torch.stack(parts).sum() if len(parts) > 1 else parts[0]


def _local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (the same storage); a tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``tree_paths`` order) of each
    leaf's f32 sum of squares.  DTensor leaves: each rank sums its shard's
    squares, and those sums are added over the mesh dims that shard the
    leaf only (one all-reduce for each set of sharding dims), so an
    element replicated over a dim counts once, not once a rank.  On a mesh
    of one rank that is one set, summed in leaf order: the single-device
    norm, bit for bit."""
    total = None
    parts: dict[tuple, torch.Tensor] = {}
    mesh = None
    for _, x in tree_paths(tree):
        if isinstance(x, DTensor):
            mesh = x.device_mesh
            key = tuple(isinstance(pl, Shard) and n > 1
                        for pl, n in zip(x.placements, mesh.shape))
            s = _sq_sum(x.to_local())
            parts[key] = s if key not in parts else parts[key] + s
            continue
        s = _sq_sum(x)
        total = s if total is None else total + s
    for key, s in parts.items():
        s = DTensor.from_local(s, mesh, [Partial() if k else Replicate() for k in key])
        s = s.full_tensor()
        total = s if total is None else total + s
    return total.sqrt()


def _update(cfg: AdamWConfig, p, g, m, v, *, scale, lr, bc1, bc2, decay: bool):
    """One slice of the reference's ``upd``: new (p, m, v), f32 math."""
    g = g.float() * scale
    m = cfg.b1 * m.float() + (1.0 - cfg.b1) * g
    v = cfg.b2 * v.float() + (1.0 - cfg.b2) * g.square()
    step = (m / bc1) / ((v / bc2).sqrt() + cfg.eps)
    if decay:
        step = step + cfg.weight_decay * p.float()
    return p.float() - lr * step, m, v


def apply_updates(cfg: AdamWConfig, params: Params, grads: Params, state: dict
                  ) -> tuple[Params, dict, dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (the params, ``state``, {"grad_norm",
    "lr"}), the params and the state (the count too) updated."""
    count = _local(state["count"]) + 1
    gnorm = global_norm(grads)
    scale = torch.where(gnorm > cfg.grad_clip, cfg.grad_clip / gnorm.clamp_min(1e-9),
                        1.0).to(torch.float32)
    lr = torch.full((), cfg.lr, dtype=torch.float32, device=gnorm.device)
    if cfg.schedule is not None:
        lr = lr * cfg.schedule(count)
    cf = count.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** cf
    bc2 = 1.0 - cfg.b2 ** cf
    kw = dict(scale=scale, lr=lr, bc1=bc1, bc2=bc2)

    gs, ms, vs = (dict(tree_paths(t)) for t in (grads, state["m"], state["v"]))
    done = 0  # leaves written
    touched = False  # a write has begun
    with torch.no_grad():
        try:
            for path, p in tree_paths(params):
                decay = p.dim() >= 2 and cfg.weight_decay > 0.0
                p, g, m, v = (_local(t) for t in (p, gs[path], ms[path], vs[path]))
                fp, fm, fv, fg = p.view(-1), m.view(-1), v.view(-1), g.reshape(-1)
                for i in range(0, fp.numel(), SLICE):
                    sl = slice(i, i + SLICE)
                    a, b, c = _update(cfg, fp[sl], fg[sl], fm[sl], fv[sl], decay=decay, **kw)
                    touched = True
                    fp[sl] = a.to(p.dtype)
                    fm[sl] = b.to(m.dtype)
                    fv[sl] = c.to(v.dtype)
                done += 1
            _local(state["count"]).copy_(count)
        except Exception as e:
            if touched:
                raise CommitError(
                    f"AdamW failed after {done} leaves were updated in place: "
                    f"{type(e).__name__}: {e}") from e
            raise
    return params, state, {"grad_norm": gnorm, "lr": lr}
