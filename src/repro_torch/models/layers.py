"""Shared layers (plain functions on tensors, params in nested dicts).

Port of the reference ``models/layers.py`` for the serving slice: the same
init distributions (drawn from an explicit ``torch.Generator``), rmsnorm
with the ``1 + scale`` convention in f32, half-split rope with f32 angles,
the swiglu FFN and the tanh softcap.  Weights are stored ``(in, out)`` and
applied as ``x @ w``, as in the reference.
"""

from __future__ import annotations

import math

import torch

Params = dict


# ----------------------------------------------------------------------------
# Initializers
# ----------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, dtype, *, scale: float | None = None
               ) -> torch.Tensor:
    """Truncated normal in [-2, 2] times ``scale`` (default 1/sqrt(fan_in)),
    drawn in f32."""
    fan_in = shape[0] if len(shape) > 1 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(1, fan_in))
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return w.mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=gen.device)
    w.normal_(0.0, 1.0, generator=gen).mul_(0.02)
    return w.to(dtype)


# ----------------------------------------------------------------------------
# RMSNorm, rope, FFN, softcap
# ----------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with the zero-centred ``1 + scale`` gain."""
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].float())).to(dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of shape ``positions.shape + (head_dim / 2,)`` in f32."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(theta) * idx / half)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); sin/cos: (..., S, D/2), broadcast over heads.
    Half-split layout (first half / second half), not interleaved."""
    dtype = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    sin = sin[..., None, :]
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype) -> Params:
    """The swiglu FFN (the only kind the port has; ``transformer.
    check_supported`` rejects the others)."""
    return {
        "wi": dense_init(gen, (d_model, d_ff), dtype),
        "wg": dense_init(gen, (d_model, d_ff), dtype),
        "wo": dense_init(gen, (d_ff, d_model), dtype),
    }


def ffn_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """swiglu: (silu(x @ wg) * (x @ wi)) @ wo."""
    return (torch.nn.functional.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)
