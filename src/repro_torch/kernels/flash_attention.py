"""Prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(``flash_attention_kernel``) and covers what the reference model runs as
``attention.flash_attention_ref`` for a prefill chunk: ``q_offset``, GQA
without a broadcast copy, and lengths that are not tile multiples.  The
kernel's design and bound are in the CUDA source's header.

On a CPU tensor the wrapper runs the plain version
(:func:`flash_attention_plain`, from ``kernels/ref.py``); on a CUDA tensor
it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention",
    [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, ctypes.c_float, _P])


def _check_inputs(q, k, v) -> None:
    """Raise ``ValueError`` unless q (B, Sq, H, hd) and k/v (B, Sk, Hkv, hd)
    share one cpu or cuda device and one f32/bf16 type, fit together, and
    are contiguous."""
    ts = (q, k, v)
    if any(t.device != q.device for t in ts) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"flash_attention: all inputs must be on one cpu or cuda device, got "
            f"{[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash_attention: q, k, v must share float32 or bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(
            f"flash_attention: want q (B, Sq, H, hd) and k/v (B, Sk, Hkv, hd), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2] or k.shape[1] < 1:
        raise ValueError(
            f"flash_attention: k/v {tuple(k.shape)} do not fit q {tuple(q.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("flash_attention: inputs must be contiguous")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, Hkv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
    q_offset: int = 0,
) -> torch.Tensor:
    _check_inputs(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head_dim {hd} > {MAX_HEAD_DIM}")
    out = torch.empty_like(q)
    KERNEL.launch(
        _DTYPES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(out), b, sq, sk, h, hkv,
        hd, int(q_offset), int(bool(causal)), int(window), float(softcap),
        float(scale), ctypes.c_void_p(stream_of(q)))
    return out
