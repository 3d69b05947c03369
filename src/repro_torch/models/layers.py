"""Shared layers (plain functions on tensors, params in nested dicts).

Port of the reference ``models/layers.py`` for the serving slice: the same
init distributions (drawn from an explicit ``torch.Generator``), rmsnorm
with the ``1 + scale`` convention in f32, half-split rope with f32 angles,
whisper's sinusoidal absolute positions, the FFN kinds (swiglu, geglu,
gelu_mlp), the tanh softcap and the training loss (the chunked cross
entropy).  Weights are
stored ``(in, out)`` and applied as ``x @ w``, as in the reference.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

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


def sinusoidal_positions(seq: int, d_model: int, dtype, device=None) -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (S, D)."""
    return sinusoidal_positions_at(torch.arange(seq, dtype=torch.float32, device=device),
                                   d_model, dtype)


def sinusoidal_positions_at(positions: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    """Sinusoidal embeddings at ``positions`` (any shape, on any device):
    (..., D), sin then cos of ``position * exp(-ln(1e4) i / (D/2 - 1))``
    in f32.  Row p equals ``sinusoidal_positions(seq)[p]``; a decode step
    passes its device ``cur_len``, so nothing is read back to the host."""
    half = d_model // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * idx / max(1, half - 1))
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def ffn_init(gen: torch.Generator, d_model: int, d_ff: int, dtype, *,
             kind: str = "swiglu") -> Params:
    """The FFN's weights: ``wi``, ``wg``, ``wo`` for the gated kinds
    (swiglu, geglu), ``wi``, ``wo`` for ``gelu_mlp``."""
    if kind in ("swiglu", "geglu"):
        return {
            "wi": dense_init(gen, (d_model, d_ff), dtype),
            "wg": dense_init(gen, (d_model, d_ff), dtype),
            "wo": dense_init(gen, (d_ff, d_model), dtype),
        }
    if kind == "gelu_mlp":
        return {"wi": dense_init(gen, (d_model, d_ff), dtype),
                "wo": dense_init(gen, (d_ff, d_model), dtype)}
    raise ValueError(f"unknown ffn kind {kind}")


def ffn_apply(p: Params, x: torch.Tensor, *, kind: str = "swiglu") -> torch.Tensor:
    """swiglu: (silu(x @ wg) * (x @ wi)) @ wo; geglu: the same with the
    tanh-approximate gelu (as the reference's ``jax.nn.gelu(approximate=
    True)``); gelu_mlp: gelu(x @ wi) @ wo."""
    f = torch.nn.functional
    if kind == "swiglu":
        return (f.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    if kind == "geglu":
        return (f.gelu(x @ p["wg"], approximate="tanh") * (x @ p["wi"])) @ p["wo"]
    if kind == "gelu_mlp":
        return f.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]
    raise ValueError(f"unknown ffn kind {kind}")


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------------------
# Chunked cross-entropy (vocab/sequence streaming)
# ----------------------------------------------------------------------------


def _chunk_nll(h: torch.Tensor, embed_f32: torch.Tensor, t: torch.Tensor, m: torch.Tensor,
               final_softcap: float) -> torch.Tensor:
    logits = softcap(h.float() @ embed_f32.T, final_softcap)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, t.long()[..., None])[..., 0]
    return ((logz - gold) * m.float()).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,  # (B, S, D) final hidden states
    out_embed: torch.Tensor,  # (V, D) output embedding (logits = h @ E^T)
    targets: torch.Tensor,  # (B, S) int
    mask: torch.Tensor,  # (B, S) 0/1 loss mask
    *,
    chunk: int = 512,
    final_softcap: float = 0.0,
    total_count: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean CE over masked tokens, streaming over sequence chunks
    (reference ``layers.chunked_cross_entropy``): f32 logits over the
    whole (padded) vocabulary, the final softcap, the masked mean.  The
    table is cast to f32 once, outside the chunk loop; under autograd each
    chunk is a checkpoint, so only one chunk's (B, chunk, V) logits exist
    at a time, in the backward too.  ``total_count``: the denominator in
    place of the mask's count, when these rows are one rank's share of a
    batch (the whole batch's count: the ranks' results then sum to its
    mean)."""
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"seq {s} % loss chunk {chunk} != 0")
    embed_f32 = out_embed.float()
    loss_sum = hidden.new_zeros((), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    grad = torch.is_grad_enabled() and (hidden.requires_grad or out_embed.requires_grad)
    for i in range(0, s, chunk):
        args = (hidden[:, i:i + chunk], embed_f32, targets[:, i:i + chunk],
                mask[:, i:i + chunk], final_softcap)
        nll = (checkpoint(_chunk_nll, *args, use_reentrant=False) if grad
               else _chunk_nll(*args))
        loss_sum = loss_sum + nll
        count = count + mask[:, i:i + chunk].float().sum()
    if total_count is not None:
        count = total_count
    return loss_sum / count.clamp_min(1.0)
