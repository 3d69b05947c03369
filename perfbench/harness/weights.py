"""Seeded weights, drawn on the device in the types they are served in.

The program's parameter tree (``repro_torch.models.transformer.
param_shapes``: leaves stacked over the layers, matrices stored ``(in,
out)``) is the interface the engine takes, so the harness draws into it:
one call a stacked leaf, with a ``torch.Generator`` on the device seeded
from ``--seed``.  Both the program and the plain reference are handed
these same tensors.

Distributions, by leaf name (the published models' initialisations where
they have one, so the activations keep their published scale):

* ``embed`` / ``unembed``: N(0, 0.02);
* a norm's ``scale`` (the gain is ``1 + scale``): N(0, 0.1), so a missing
  gain shows in the check;
* mamba's ``A_log``: log U(1, 16); ``dt_bias``: the inverse softplus of a
  log-uniform dt in [0.001, 0.1]; ``D``: U(0.5, 1.5); ``conv_w`` and
  ``conv_b``: U(-0.5, 0.5) (a width-4 conv's default);
* every other matrix: N(0, 1 / fan_in), fan_in its ``in`` size.
"""

from __future__ import annotations

import math

import torch


def _draw(name: str, shape: tuple[int, ...], dtype: torch.dtype,
          gen: torch.Generator) -> torch.Tensor:
    t = torch.empty(shape, dtype=dtype, device=gen.device)
    if name in ("embed", "unembed"):
        return t.normal_(0.0, 0.02, generator=gen)
    if name == "scale":
        return t.normal_(0.0, 0.1, generator=gen)
    if name == "A_log":
        return t.uniform_(1.0, 16.0, generator=gen).log_()
    if name == "dt_bias":
        dt = t.uniform_(math.log(1e-3), math.log(1e-1), generator=gen).exp_()
        return dt + torch.log(-torch.expm1(-dt))
    if name == "D":
        return t.uniform_(0.5, 1.5, generator=gen)
    if name in ("conv_w", "conv_b"):
        return t.uniform_(-0.5, 0.5, generator=gen)
    fan_in = shape[-2] if len(shape) >= 2 else 1
    return t.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=gen)


def make_params(cfg, seed: int, device) -> dict:
    """The parameter tree of the port's ``cfg`` drawn from ``seed`` on
    ``device``."""
    from repro_torch.models import transformer as T

    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def walk(tree: dict) -> dict:
        return {k: walk(v) if isinstance(v, dict)
                else _draw(k, tuple(v), T.leaf_dtype(cfg, k), gen)
                for k, v in tree.items()}
    return walk(T.param_shapes(cfg))
