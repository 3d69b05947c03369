"""Prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(``flash_attention_kernel``) and covers what the reference model runs as
``attention.flash_attention_ref`` for a prefill chunk: ``q_offset``, a
bidirectional prefix (``prefix_len``, prefix-LM), non-causal attention
(an encoder, cross-attention), GQA without a broadcast copy, and lengths
that are not tile multiples.  Two
CUDA bodies, as :func:`plan_flash` picks them: bf16 with head_dim a multiple
of 16 runs on the tensor cores (``"tc"``), f32 or any other head_dim on the
SIMT body (``"simt"``).  The bodies' designs and bounds are in the CUDA
source's header; ``ref.flash_attention_tc_plain`` emulates the tensor-core
body's rounding for the tests.

On a CPU tensor the wrapper runs the plain version
(:func:`flash_attention_plain`, from ``kernels/ref.py``); on a CUDA tensor
it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention",
    [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, ctypes.c_float, _I, _P])

TC_WARPS = 4  # warps a block of the tensor-core body
KEY_TILE = 16  # keys of one softmax step of the tensor-core body
SIMT_ROWS, SIMT_KEYS = 16, 32  # the SIMT body's query and key tiles


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How one call runs.  ``body`` "tc": grid (m-tiles, Hkv, B) of ``warps``
    warps, each block one m-tile of 16 of the Sq * g rows of a (b, kv head),
    its ``key_splits`` = ``warps`` warps sharing each staged K/V tile and
    splitting its 16-key softmax steps (``key_tile``) among them.  ``body``
    "simt": grid (B * H, Sq / 16) of 4 warps, one query head a block, key
    tiles of 32."""

    body: str
    grid: tuple[int, int, int]
    warps: int
    key_splits: int
    key_tile: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan_flash(batch: int, sq: int, n_heads: int, n_kv: int, head_dim: int,
               dtype: torch.dtype) -> FlashPlan:
    """The body and tiling of a call, from its shape and type alone: the
    tensor-core body for bf16 with head_dim % 16 == 0, else the SIMT body."""
    if dtype != torch.bfloat16 or head_dim % 16:
        return FlashPlan("simt", (batch * n_heads, -(-sq // SIMT_ROWS), 1), 4, 1, SIMT_KEYS)
    m_tiles = -(-sq * (n_heads // n_kv) // 16)
    return FlashPlan("tc", (m_tiles, n_kv, batch), TC_WARPS, TC_WARPS, KEY_TILE)


#: The analyzer's view of this module (``analysis.kernelcheck``): the plan
#: the launch uses and shapes of several m-tiles and both bodies (KRN001).
KERNEL_META = {
    "flash_attention": dict(
        cover="flash", plan=plan_flash, kernels=(KERNEL,),
        lint_shapes=(
            dict(batch=1, sq=64, n_heads=32, n_kv=8, head_dim=128, dtype=torch.bfloat16),
            dict(batch=2, sq=37, n_heads=16, n_kv=16, head_dim=64, dtype=torch.bfloat16),
            dict(batch=1, sq=1500, n_heads=16, n_kv=16, head_dim=64, dtype=torch.float32),
            dict(batch=3, sq=20, n_heads=6, n_kv=2, head_dim=24, dtype=torch.bfloat16),
        )),
}


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
    prefix_len: int = 0,
) -> torch.Tensor:
    """Causal: key j is seen by query i when ``j <= q_offset + i`` or ``j <
    prefix_len`` (a bidirectional prefix, prefix-LM); ``causal=False``
    sees every key (an encoder, cross-attention)."""
    _check_inputs(q, k, v)
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len must be >= 0, got {prefix_len}")
    if q.device.type == "cpu":
        return flash_attention_plain(
            q, k, v, causal=causal, window=window, softcap=softcap,
            scale=scale, q_offset=q_offset, prefix_len=prefix_len)
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head_dim {hd} > {MAX_HEAD_DIM}")
    plan = plan_flash(b, sq, h, hkv, hd, q.dtype)
    if plan.body == "tc" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention kernel: the tensor-core body copies q, k and v "
                         "in 16-byte chunks; they must start on 16-byte boundaries")
    out = torch.empty_like(q)
    KERNEL.launch(
        _DTYPES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(out), b, sq, sk, h, hkv,
        hd, int(q_offset), int(bool(causal)), int(prefix_len), int(window), float(softcap),
        float(scale), int(plan.body == "tc"), ctypes.c_void_p(stream_of(q)))
    return out
