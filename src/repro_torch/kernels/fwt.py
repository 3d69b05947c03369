"""Walsh-Hadamard transform: wrappers of ``csrc/fwt.cu``.

Replaces the TPU kernel ``repro/kernels/fwt.py::fwt_block`` (body
``_fwt_block_kernel``): the unnormalized WHT in log2 butterfly stages in
f32, output in the input's type.  Two entries:

* :func:`fwt_block`, the row pass: the WHT over the last axis of ``(rows,
  block)``.  Up to a block of 1024 a warp holds a row (or several) in
  registers, 16 bytes a lane a load, and runs the stages in registers and
  by warp shuffles, with no shared memory and no barrier; larger blocks go
  through shared memory once.
* :func:`fwt_columns`, the column pass: the WHT over the first axis of
  ``(b1, b2)`` in its own layout, a strip of columns a block in shared
  memory between its two phases, loaded straight into registers 16 bytes
  a lane.  ``out`` may alias ``y``.

The two-pass Kronecker transform is ``ops.fwt``: the row pass on ``(B1, B2)``,
then the column pass on its output, in place of the reference's two
transposes.  Bound (bytes: 16 MB in and out a pass for a 2^22 f32 task,
~0.010 ms a pass at 3.35 TB/s) and design are in the CUDA source's header.
Each body runs the stages in the plain version's order, so a kernel's
output equals its plain version's bit for bit.

On a CPU tensor a wrapper runs the plain version (:func:`fwt_plain`,
:func:`fwt_columns_plain`, from ``kernels/ref.py``); on a CUDA tensor it
launches its kernel or raises -- it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import fwt_columns_plain
from repro_torch.kernels.ref import fwt_ref as fwt_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# A row (block) or a column (b1) of f32 in shared memory: 128 KB of the 227
# KB a block may use.
MAX_BLOCK = 1 << 15

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("fwt.cu", "fwt_block", [_I, _P, _P, _I, _I, _P])
COLUMNS_KERNEL = CudaKernel("fwt.cu", "fwt_columns", [_I, _P, _P, _I, _I, _P])


def _pow2(v: int) -> bool:
    return v >= 1 and not v & (v - 1)


def _check(name: str, t: torch.Tensor, axis: int) -> None:
    """Device, a 2-D shape whose transformed ``axis`` is a power of two, and
    the type."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: input must be on a cpu or cuda device, got {t.device}")
    if t.dim() != 2 or t.shape[0] < 1 or t.shape[1] < 1 or not _pow2(t.shape[axis]):
        raise ValueError(f"{name}: want a 2-D input, axis {axis} a power of two, got "
                         f"{tuple(t.shape)}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{name}: input must be float32 or bfloat16, got {t.dtype}")


def fwt_block(x: torch.Tensor) -> torch.Tensor:
    """WHT of each row of ``x (rows, block)``, f32 or bf16."""
    _check("fwt_block", x, 1)
    if x.device.type == "cpu":
        return fwt_plain(x)
    rows, block = x.shape
    if block > MAX_BLOCK:
        raise ValueError(f"fwt_block kernel: block {block} > {MAX_BLOCK} (shared memory)")
    if not x.is_contiguous():
        raise ValueError("fwt_block kernel: x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("fwt_block kernel: x must be 16-byte aligned (16-byte loads)")
    out = torch.empty_like(x)
    KERNEL.launch(_DTYPES[x.dtype], ptr(x), ptr(out), rows, block,
                  ctypes.c_void_p(stream_of(x)))
    return out


def fwt_columns(y: torch.Tensor, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """WHT over the first axis of ``y (b1, b2)``, f32 or bf16, into ``out``
    (a new tensor by default; ``out=y`` transforms in place)."""
    _check("fwt_columns", y, 0)
    if out is not None and (out.shape != y.shape or out.dtype != y.dtype
                            or out.device != y.device):
        raise ValueError(f"fwt_columns: out {tuple(out.shape)} {out.dtype} on {out.device} "
                         f"does not match y {tuple(y.shape)} {y.dtype} on {y.device}")
    if y.device.type == "cpu":
        res = fwt_columns_plain(y)
        return res if out is None else out.copy_(res)
    b1, b2 = y.shape
    if b1 > MAX_BLOCK:
        raise ValueError(f"fwt_columns kernel: b1 {b1} > {MAX_BLOCK} (shared memory)")
    if out is None:
        out = torch.empty_like(y)
    if not (y.is_contiguous() and out.is_contiguous()):
        raise ValueError("fwt_columns kernel: y and out must be contiguous")
    COLUMNS_KERNEL.launch(_DTYPES[y.dtype], ptr(y), ptr(out), b1, b2,
                          ctypes.c_void_p(stream_of(y)))
    return out
