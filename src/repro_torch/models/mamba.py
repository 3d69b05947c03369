"""Mamba2 (SSD, state-space duality) block — arXiv:2405.21060 (reference
``models/mamba.py``).

The chunked SSD scan is the paper's true-dependent streaming: the prompt is
cut into chunk tasks and the O(1) SSM state is handed from each to the
next.  The prefill branch of :func:`mamba_apply` runs it through the SSD
kernel wrapper (``kernels/ssd_chunk``: the CUDA kernel on the card, the
plain version on the CPU); the decode branch is one recurrence step in
plain PyTorch ops (the reference has no kernel for it).  When a gradient
is wanted (training) the scan goes through :class:`SSDChunked`, an
``autograd.Function`` whose forward is the same kernel and whose backward
recomputes through the plain ``ssd_chunked_ref`` under autograd: the
counterpart of the reference's JAX autodiff of its jnp scan.

Shapes follow the minimal-SSD reference: x (B, S, H, P), dt (B, S, H), A
(H,) negative, B/C (B, S, N) single-group, state (B, H, P, N) f32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd_chunk as ssd_kernel
from repro_torch.kernels.ref import ssd_chunked_ref as ssd_chunked  # the plain versions
from repro_torch.kernels.ref import ssd_ref, ssd_step_ref
from repro_torch.models import layers

Params = dict

CONV_WIDTH = 4
#: Leaves kept in f32 whatever ``param_dtype`` is (reference mamba.py:168-170).
F32_PARAMS = ("A_log", "D", "dt_bias")

__all__ = ["CONV_WIDTH", "F32_PARAMS", "SSDChunked", "mamba_dims", "mamba_shapes", "mamba_init",
           "mamba_apply", "mamba_cache_init", "ssd", "ssd_chunked", "ssd_ref", "ssd_decode_step"]


class SSDChunked(torch.autograd.Function):
    """The SSD kernel with a backward: forward through
    ``kernels/ssd_chunk.ssd_chunked`` (the CUDA kernel on the card, the plain
    version on the CPU) -> (y, final state); backward by differentiating
    the plain version at the saved inputs, for x, dt, a, b_, c_ and
    init_state."""

    @staticmethod
    def forward(ctx, x, dt, a, b_, c_, init_state, chunk):
        y, final = ssd_kernel.ssd_chunked(x, dt, a, b_, c_, chunk=chunk, init_state=init_state)
        ctx.save_for_backward(x, dt, a, b_, c_, init_state)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        saved = ctx.saved_tensors
        inputs = [t.detach().requires_grad_(need) if t is not None else None
                  for t, need in zip(saved, ctx.needs_input_grad)]
        with torch.enable_grad():
            y, final = ssd_chunked(*inputs[:5], chunk=ctx.chunk, init_state=inputs[5])
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad((y, final), wanted, (dy, dfinal), allow_unused=True))
        out = [next(grads) if t is not None and t.requires_grad else None for t in inputs]
        return (*out, None)


def ssd(x, dt, a, b_, c_, *, chunk: int, init_state=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill scan: through :class:`SSDChunked` when a gradient is
    wanted, else straight through the kernel wrapper."""
    args = (x.contiguous(), dt.contiguous(), a.contiguous(), b_.contiguous(), c_.contiguous())
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (*args, init_state)):
        return SSDChunked.apply(*args, init_state, chunk)
    return ssd_kernel.ssd_chunked(*args, chunk=chunk, init_state=init_state)


def ssd_decode_step(state, x_t, dt_t, a, b_t, c_t) -> tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update (decode): state (B, H, P, N), x_t (B, H, P),
    dt_t (B, H), a (H,), b_t/c_t (B, N) -> (y (B, H, P) in x_t's type, new
    state f32)."""
    state, y = ssd_step_ref(state, x_t, dt_t, a, b_t, c_t)
    return y.to(x_t.dtype), state


def mamba_dims(d_model: int, *, expand: int = 2, headdim: int = 64, d_state: int = 128):
    d_inner = expand * d_model
    n_heads = d_inner // headdim
    conv_dim = d_inner + 2 * d_state
    return d_inner, n_heads, conv_dim


def mamba_shapes(d_model: int, *, expand: int = 2, headdim: int = 64,
                 d_state: int = 128) -> dict:
    """Leaf shapes of one block, as the reference's ``mamba_init`` tree."""
    d_inner, n_heads, conv_dim = mamba_dims(d_model, expand=expand, headdim=headdim,
                                            d_state=d_state)
    return {"in_proj": (d_model, 2 * d_inner + 2 * d_state + n_heads),
            "conv_w": (CONV_WIDTH, conv_dim), "conv_b": (conv_dim,),
            "A_log": (n_heads,), "D": (n_heads,), "dt_bias": (n_heads,),
            "norm": {"scale": (d_inner,)}, "out_proj": (d_inner, d_model)}


def mamba_init(gen: torch.Generator, *, d_model: int, expand: int = 2, headdim: int = 64,
               d_state: int = 128, dtype=torch.float32) -> Params:
    """The reference's distributions: fan-in truncated normals for the
    projections, a 0.5-scaled one for the conv taps, A_log = log of
    linspace(1, 16, H), D ones, zero dt_bias / conv_b / norm scale."""
    shapes = mamba_shapes(d_model, expand=expand, headdim=headdim, d_state=d_state)
    n_heads = shapes["A_log"][0]
    dev = gen.device
    return {
        "in_proj": layers.dense_init(gen, shapes["in_proj"], dtype),
        "conv_w": layers.dense_init(gen, shapes["conv_w"], dtype, scale=0.5),
        "conv_b": torch.zeros(shapes["conv_b"], dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, device=dev)),
        "D": torch.ones((n_heads,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((n_heads,), dtype=torch.float32, device=dev),
        "norm": layers.rmsnorm_init(shapes["norm"]["scale"][0], dtype, dev),
        "out_proj": layers.dense_init(gen, shapes["out_proj"], dtype),
    }


def _split_proj(zxbcdt: torch.Tensor, d_inner: int, d_state: int, n_heads: int):
    z = zxbcdt[..., :d_inner]
    x = zxbcdt[..., d_inner: 2 * d_inner]
    b_ = zxbcdt[..., 2 * d_inner: 2 * d_inner + d_state]
    c_ = zxbcdt[..., 2 * d_inner + d_state: 2 * d_inner + 2 * d_state]
    dt = zxbcdt[..., 2 * d_inner + 2 * d_state:]
    return z, x, b_, c_, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width CONV_WIDTH: xbc (B, S, C), w (W, C).
    The reference's four shifted multiply-adds, in its order (not
    ``F.conv1d``, which goes through cuDNN, in TF32 by default on the card)."""
    pads = F.pad(xbc, (0, 0, CONV_WIDTH - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(CONV_WIDTH):
        out = out + pads[:, i: i + xbc.shape[1]] * w[i][None, None, :]
    return out + b[None, None, :]


def mamba_apply(
    p: Params,
    u: torch.Tensor,  # (B, S, D)
    *,
    headdim: int = 64,
    d_state: int = 128,
    expand: int = 2,
    chunk: int = 64,
    state: torch.Tensor | None = None,  # (B, H, P, N) f32
    conv_state: torch.Tensor | None = None,  # (B, W-1, conv_dim)
    decode: bool = False,
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The full block: returns (out (B, S, D), {"ssm": new state, "conv":
    new conv tail}).  Prefill continues from ``state`` / ``conv_state``
    (zeros when None) through the SSD kernel wrapper; ``decode`` takes one
    token and needs both."""
    bsz, s, d_model = u.shape
    d_inner, n_heads, conv_dim = mamba_dims(d_model, expand=expand, headdim=headdim,
                                            d_state=d_state)
    zxbcdt = u @ p["in_proj"]
    z, x, b_, c_, dt = _split_proj(zxbcdt, d_inner, d_state, n_heads)
    xbc = torch.cat([x, b_, c_], dim=-1)  # (B, S, conv_dim)
    if decode:
        assert conv_state is not None and s == 1
        window = torch.cat([conv_state, xbc], dim=1)  # (B, W, conv_dim)
        conv = (window * p["conv_w"][None]).sum(dim=1, keepdim=True) + p["conv_b"][None, None]
        new_conv_state = window[:, 1:]
    else:
        # Chunked-prefill continuation: the previous chunk's tail enters the
        # causal conv window (zeros when starting fresh).
        head = (conv_state if conv_state is not None else
                torch.zeros((bsz, CONV_WIDTH - 1, conv_dim), dtype=xbc.dtype, device=u.device))
        ext = torch.cat([head.to(xbc.dtype), xbc], dim=1)
        conv = _causal_conv(ext, p["conv_w"], p["conv_b"])[:, CONV_WIDTH - 1:]
        new_conv_state = ext[:, -(CONV_WIDTH - 1):]
    conv = F.silu(conv)
    x = conv[..., :d_inner].reshape(bsz, s, n_heads, headdim)
    b_ = conv[..., d_inner: d_inner + d_state]
    c_ = conv[..., d_inner + d_state:]

    a = -torch.exp(p["A_log"])  # (H,) negative
    # jax.nn.softplus is logaddexp(x, 0).
    dt = dt.float() + p["dt_bias"][None, None]
    dt = torch.logaddexp(dt, torch.zeros_like(dt))

    if decode:
        assert state is not None
        y_t, new_state = ssd_decode_step(state, x[:, 0], dt[:, 0], a, b_[:, 0], c_[:, 0])
        y = y_t[:, None]
    else:
        init = state.float().contiguous() if state is not None else None
        y, new_state = ssd(x, dt, a, b_, c_, chunk=chunk, init_state=init)

    y = y + p["D"][None, None, :, None].to(y.dtype) * x  # skip connection
    y = y.reshape(bsz, s, d_inner)
    y = layers.rmsnorm(p["norm"], y * F.silu(z))
    out = y @ p["out_proj"]
    return out, {"ssm": new_state, "conv": new_conv_state}


def mamba_cache_init(bsz: int, d_model: int, *, expand=2, headdim=64, d_state=128,
                     dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """Zero decode state of ``bsz`` rows: ssm (B, H, P, N) f32 and the conv
    tail (B, W-1, conv_dim) in ``dtype``."""
    d_inner, n_heads, conv_dim = mamba_dims(d_model, expand=expand, headdim=headdim,
                                            d_state=d_state)
    return {
        "ssm": torch.zeros((bsz, n_heads, headdim, d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((bsz, CONV_WIDTH - 1, conv_dim), dtype=dtype, device=device),
    }
