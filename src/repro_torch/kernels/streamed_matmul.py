"""Tiled matmul: wrapper of ``csrc/streamed_matmul.cu``.

Replaces the TPU kernel ``repro/kernels/streamed_matmul.py::streamed_matmul``
(body ``_mm_kernel``, reached through ``ops.matmul``): ``x @ y`` with an f32
accumulator over the k stream, output in ``result_type(x, y)``.  The TPU
kernel needs every dimension to divide by its VMEM block sizes; the CUDA
kernel masks its edges, so it takes no block arguments and any ``(m, k) @
(k, n)``.  It runs on the tensor cores as :func:`plan_matmul` says: f32 x
f32 as three TF32 products (3xTF32, f32 accuracy), f32 x bf16 as two, bf16
x bf16 as one bf16 product; ``ref.matmul_tf32_plain`` emulates those
products for the tests.  The kernel's design and bound are in the CUDA
source's header.

On a CPU tensor the wrapper runs the plain version (:func:`matmul_plain`,
from ``kernels/ref.py``); on a CUDA tensor it launches the kernel or raises
— it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import matmul_ref as matmul_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("streamed_matmul.cu", "streamed_matmul",
                    [_I, _I, _P, _P, _P, _I, _I, _I, _P])

BLOCK = (128, 128, 32)  # a block's (m, n) tile of out and its k stage


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """How one call runs: ``body`` "tf32" (wgmma m64n128k8, ``products``
    TF32 products a k-step: 3 for f32 x f32, 2 with one bf16 operand) or
    "bf16" (mma.sync m16n8k16, one product); a grid of (n, m) tiles of
    ``BLOCK``.  Which operands go by cp.async the C entry decides from
    their pointers and rows (see its note)."""

    body: str
    products: int
    grid: tuple[int, int]


def plan_matmul(m: int, n: int, k: int, x_dtype: torch.dtype,
                y_dtype: torch.dtype) -> MatmulPlan:
    """The kernel's body for x (m, k) @ y (k, n) of these types."""
    bf16 = torch.bfloat16
    both = x_dtype == bf16 and y_dtype == bf16
    products = 1 if both else 3 - (x_dtype == bf16) - (y_dtype == bf16)
    grid = (-(-n // BLOCK[1]), -(-m // BLOCK[0]))
    return MatmulPlan("bf16" if both else "tf32", products, grid)


#: The analyzer's view of this module (``analysis.kernelcheck``): the plan
#: the launch uses and shapes with ragged edge tiles (KRN001).
KERNEL_META = {
    "streamed_matmul": dict(
        cover="matmul", plan=plan_matmul, kernels=(KERNEL,),
        lint_shapes=(
            dict(m=2048, n=2048, k=2048, x_dtype=torch.float32, y_dtype=torch.float32),
            dict(m=300, n=130, k=64, x_dtype=torch.bfloat16, y_dtype=torch.float32),
            dict(m=1, n=257, k=33, x_dtype=torch.bfloat16, y_dtype=torch.bfloat16),
        )),
}


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x (m, k) @ y (k, n)`` -> (m, n) in ``result_type(x, y)``; f32 or
    bf16 inputs on one cpu or cuda device."""
    if x.device != y.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"matmul: x and y must be on one cpu or cuda device, got {x.device}, {y.device}")
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0] or 0 in (*x.shape, y.shape[1]):
        raise ValueError(
            f"matmul: want x (m, k) and y (k, n), non-empty, got {tuple(x.shape)}, "
            f"{tuple(y.shape)}")
    if x.dtype not in _DTYPES or y.dtype not in _DTYPES:
        raise ValueError(f"matmul: inputs must be float32 or bfloat16, got {x.dtype}, {y.dtype}")
    if x.device.type == "cpu":
        return matmul_plain(x, y)
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul kernel: inputs must be contiguous")
    m, k = x.shape
    n = y.shape[1]
    out = torch.empty((m, n), dtype=torch.result_type(x, y), device=x.device)
    KERNEL.launch(_DTYPES[x.dtype], _DTYPES[y.dtype], ptr(x), ptr(y), ptr(out), m, n, k,
                  ctypes.c_void_p(stream_of(x)))
    return out
