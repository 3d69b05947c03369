"""Mamba2 SSD chunk scan: wrapper of ``csrc/ssd_chunk.cu``.

Replaces the TPU kernel ``repro/kernels/ssd_chunk.py::_ssd_kernel``
(``ssd_chunk_kernel``, reached through ``ops.ssd``) and computes what the
reference model runs as the jnp ``models/mamba.ssd_chunked``: an initial
state in, the final state out, the reference's chunk grid with a ragged
tail, and one B/C group shared by every head without a broadcast copy.
The kernel has two bodies: bf16 inputs of the serve's shapes run on the
tensor cores (``mma.sync``), f32 and other shapes on an f32 FMA body; their
design, choice and bound are in the CUDA source's header.

On a CPU tensor the wrapper runs the plain version
(:func:`ssd_chunked_plain`, from ``kernels/ref.py``); on a CUDA tensor it
launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import costanalysis
from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import ssd_chunked_ref as ssd_chunked_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256  # N: the kernel stages B and C rows of N f32 in shared memory

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "ssd_chunk.cu", "ssd_chunk",
    [_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])


def _check_inputs(x, dt, a, b_, c_, init_state) -> None:
    """Raise ``ValueError`` unless x (B, S, H, P), dt (B, S, H) f32, a (H,)
    f32, b_/c_ (B, S, N) of x's type and init_state (B, H, P, N) f32 (or
    None) share one cpu or cuda device, fit together, and are contiguous."""
    ts = [t for t in (x, dt, a, b_, c_, init_state) if t is not None]
    if any(t.device != x.device for t in ts) or x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"ssd: all inputs must be on one cpu or cuda device, got "
            f"{[str(t.device) for t in ts]}")
    if x.dim() != 4 or dt.dim() != 3 or a.dim() != 1 or b_.dim() != 3 or b_.shape != c_.shape:
        raise ValueError(
            f"ssd: want x (B, S, H, P), dt (B, S, H), a (H,), b_/c_ (B, S, N), got "
            f"{tuple(x.shape)}, {tuple(dt.shape)}, {tuple(a.shape)}, {tuple(b_.shape)}, "
            f"{tuple(c_.shape)}")
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    if dt.shape != (bsz, s, h) or a.shape != (h,) or b_.shape[:2] != (bsz, s) or s < 1:
        raise ValueError(
            f"ssd: dt {tuple(dt.shape)}, a {tuple(a.shape)}, b_ {tuple(b_.shape)} do not "
            f"fit x {tuple(x.shape)} (S >= 1)")
    if init_state is not None and init_state.shape != (bsz, h, p, n):
        raise ValueError(
            f"ssd: init_state {tuple(init_state.shape)} != {(bsz, h, p, n)}")
    if x.dtype not in _DTYPES or b_.dtype != x.dtype or c_.dtype != x.dtype:
        raise ValueError(
            f"ssd: x, b_, c_ must share float32 or bfloat16, got "
            f"{x.dtype}/{b_.dtype}/{c_.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, a, init_state) if t is not None):
        raise ValueError("ssd: dt, a and init_state must be float32")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("ssd: inputs must be contiguous")


def cost(x, b_, *, chunk: int, init: bool) -> tuple[float, float]:
    """(flops, bytes) of one call: per batch row the causal half of each
    chunk's C B^T (shared by the heads), per head the decayed scores times
    x, the carried state's term and the state update; x, dt, a, B, C and
    the initial state read once, y and the final state written once."""
    b, s, h, p = x.shape
    n = b_.shape[-1]
    e = x.element_size()
    state = b * h * p * n * 4
    nbytes = (2 * x.numel() * e + b * s * h * 4 + h * 4 + 2 * b_.numel() * e
              + (state if init else 0) + state)
    pairs = 0
    for t0 in range(0, s, chunk):
        q = min(chunk, s - t0)
        pairs += q * (q + 1) // 2
    flops = b * (2.0 * pairs * n + h * (2.0 * pairs * p + 4.0 * s * p * n))
    return flops, float(nbytes)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) f32, positive
    a: torch.Tensor,  # (H,) f32, negative
    b_: torch.Tensor,  # (B, S, N)
    c_: torch.Tensor,  # (B, S, N)
    *,
    chunk: int = 64,
    init_state: torch.Tensor | None = None,  # (B, H, P, N) f32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan -> (y (B, S, H, P) in x's type, final state
    (B, H, P, N) f32); the contract of the reference's
    ``models/mamba.ssd_chunked``."""
    _check_inputs(x, dt, a, b_, c_, init_state)
    if chunk < 1:
        raise ValueError(f"ssd: chunk must be >= 1, got {chunk}")
    return costanalysis.as_kernel(
        lambda: (ssd_chunked_plain(x, dt, a, b_, c_, chunk=chunk, init_state=init_state)
                 if x.device.type == "cpu"
                 else _launch(x, dt, a, b_, c_, chunk=chunk, init_state=init_state)),
        lambda: cost(x, b_, chunk=min(chunk, x.shape[1]), init=init_state is not None))


def _launch(x, dt, a, b_, c_, *, chunk, init_state) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on CUDA tensors."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    if n > MAX_STATE:
        raise ValueError(f"ssd kernel: state size {n} > {MAX_STATE}")
    y = torch.empty_like(x)
    final = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    KERNEL.launch(
        _DTYPES[x.dtype], ptr(x), ptr(dt), ptr(a), ptr(b_), ptr(c_),
        ptr(init_state) if init_state is not None else None, ptr(y), ptr(final),
        bsz, s, h, p, n, min(chunk, s), ctypes.c_void_p(stream_of(x)))
    return y, final
