"""Weights across frameworks: the reference's parameter pytree, as numpy
arrays, into the port's parameters.

    tree = jax.tree.map(np.asarray, repro.models.transformer.init_params(cfg, key))
    params = params_from_numpy(tree, cfg, device="cpu")

The layouts already agree (weights ``(in, out)``, a leading repeat axis on
every block leaf), so the bridge checks each leaf's shape against
``transformer.param_shapes`` and converts it to its stored type
(``transformer.leaf_dtype``: ``cfg.param_dtype``, but f32 for mamba's A_log,
D and dt_bias).  It is for tests that hold the port against the reference
on equal weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


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
