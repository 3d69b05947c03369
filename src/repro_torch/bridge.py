"""Weights across frameworks: the reference's parameter pytree, as numpy
arrays, into the port's parameters.

    tree = jax.tree.map(np.asarray, repro.models.transformer.init_params(cfg, key))
    params = params_from_numpy(tree, cfg, device="cpu")

The layouts already agree (weights ``(in, out)``, a leading repeat axis on
every block leaf), so the bridge checks each leaf's shape against
``transformer.param_shapes`` and converts it to its stored type
(``transformer.leaf_dtype``: ``cfg.param_dtype``, but f32 for mamba's A_log,
D and dt_bias and the MoE router).  The leaves of every ported layer kind
are covered: attention, sandwich norms, the dense FFN kinds, the MoE
router, experts and shared expert, and mamba.  It is for tests that hold the port against the reference
on equal weights.  :func:`opt_state_from_numpy` carries the reference's
AdamW state across the same way, so that a step can start from a mid-run
state of the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    """f32 for every float type numpy has; bf16 for ml_dtypes' bfloat16
    (what ``np.asarray`` of a JAX bf16 array gives)."""
    return torch.bfloat16 if a.dtype.name == "bfloat16" else torch.float32


def opt_state_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """The reference's AdamW state ``{"m", "v", "count"}`` (numpy leaves,
    moments f32 or bf16) as the port's: moments shaped as the params, in
    their own type (bf16 moments stay bf16, bit for bit), and ``count`` a
    0-d int32 tensor.  Raises ``ValueError`` on a missing, extra or
    misshapen leaf."""
    dev = resolve_device(device)
    if set(tree) != {"m", "v", "count"}:
        raise ValueError(f"opt state: keys {sorted(tree)} != ['count', 'm', 'v']")

    def moments(t, shapes, path):
        if set(t) != set(shapes):
            raise ValueError(f"{path}: keys {sorted(t)} != expected {sorted(shapes)}")
        out = {}
        for k, want in shapes.items():
            if isinstance(want, dict):
                out[k] = moments(t[k], want, f"{path}/{k}")
                continue
            a = np.asarray(t[k])
            if a.shape != tuple(want):
                raise ValueError(f"{path}/{k}: shape {a.shape} != {want}")
            dt = _torch_dtype(a)
            if dt == torch.bfloat16:  # the bit pattern, exactly
                out[k] = torch.from_numpy(a.view(np.int16).copy()).view(dt).to(dev)
            else:
                out[k] = torch.from_numpy(a.astype(np.float32)).to(dev)
        return out

    shapes = T.param_shapes(cfg)
    return {"m": moments(tree["m"], shapes, "m"), "v": moments(tree["v"], shapes, "v"),
            "count": torch.tensor(int(np.asarray(tree["count"])), dtype=torch.int32,
                                  device=dev)}


def params_from_numpy(tree: dict, cfg: ModelConfig, device=None) -> dict:
    """Convert a nested dict of numpy arrays (any float type, bf16
    included) into the port's params on ``device``.  Raises ``ValueError``
    on a missing, extra or misshapen leaf."""
    dev = resolve_device(device)

    def convert(t, shapes, path):
        if set(t) != set(shapes):
            raise ValueError(
                f"params{path}: keys {sorted(t)} != expected {sorted(shapes)}")
        out = {}
        for k, want in shapes.items():
            if isinstance(want, dict):
                out[k] = convert(t[k], want, f"{path}/{k}")
                continue
            a = np.asarray(t[k])
            if a.shape != tuple(want):
                raise ValueError(f"params{path}/{k}: shape {a.shape} != {want}")
            out[k] = torch.from_numpy(a.astype(np.float32)).to(
                device=dev, dtype=T.leaf_dtype(cfg, k))
        return out

    return convert(tree, T.param_shapes(cfg), "")
