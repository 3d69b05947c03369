"""Walsh-Hadamard transform of each row: wrapper of ``csrc/fwt.cu``.

Replaces the TPU kernel ``repro/kernels/fwt.py::fwt_block`` (body
``_fwt_block_kernel``): the unnormalized WHT over the last axis of a
``(rows, block)`` matrix, ``block`` a power of two, ``log2(block)``
butterfly stages in f32, output in x's type.  The two-pass Kronecker
driver is ``ops.fwt``.  The kernel's design and bound are in the CUDA
source's header.

On a CPU tensor the wrapper runs the plain version (:func:`fwt_plain`, from
``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises — it
never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import fwt_ref as fwt_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_BLOCK = 1 << 15  # a row of f32 in shared memory: 128 KB of the 227 KB a block may use

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("fwt.cu", "fwt_block", [_I, _P, _P, _I, _I, _P])


def fwt_block(x: torch.Tensor) -> torch.Tensor:
    """WHT of each row of ``x (rows, block)``, f32 or bf16."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fwt_block: x must be on a cpu or cuda device, got {x.device}")
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1 or x.shape[1] & (x.shape[1] - 1):
        raise ValueError(
            f"fwt_block: want x (rows, block), block a power of two, got {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"fwt_block: x must be float32 or bfloat16, got {x.dtype}")
    if x.device.type == "cpu":
        return fwt_plain(x)
    rows, block = x.shape
    if block > MAX_BLOCK:
        raise ValueError(f"fwt_block kernel: block {block} > {MAX_BLOCK} (shared memory)")
    if not x.is_contiguous():
        raise ValueError("fwt_block kernel: x must be contiguous")
    out = torch.empty_like(x)
    KERNEL.launch(_DTYPES[x.dtype], ptr(x), ptr(out), rows, block,
                  ctypes.c_void_p(stream_of(x)))
    return out
