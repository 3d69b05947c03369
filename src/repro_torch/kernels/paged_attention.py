"""Paged decode attention: wrapper of ``csrc/paged_attention.cu``.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::_paged_kernel``
(``paged_attention_kernel``), single-token queries, full-precision pools.
The kernel's design and bound are in the CUDA source's header.

On a CPU tensor the wrapper runs the plain version
(:func:`paged_attention_plain`, from ``kernels/ref.py``); on a CUDA tensor
it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import paged_attention_ref as paged_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 16  # query heads per kv head the kernel holds in registers
MAX_HEAD_DIM = 256

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "paged_attention.cu", "paged_attention",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, ctypes.c_float, _P])


def _check_inputs(q, k_pool, v_pool, page_table, cur_len) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernel takes:
    one cpu or cuda device, f32 or bf16 q/pools of one type, int32 table
    and lengths, consistent shapes, contiguous memory."""
    ts = (q, k_pool, v_pool, page_table, cur_len)
    if any(t.device != q.device for t in ts) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"paged_attention: all inputs must be on one cpu or cuda device, got "
            f"{[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"paged_attention: q and pools must share float32 or bfloat16, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or cur_len.dtype != torch.int32:
        raise ValueError("paged_attention: page_table and cur_len must be int32")
    if q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"paged_attention: want q (B, H, hd) and pools (nb, bs, Hkv, hd), got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, h, hd = q.shape
    hkv = k_pool.shape[2]
    if k_pool.shape[3] != hd or h % hkv:
        raise ValueError(
            f"paged_attention: head_dim {hd} vs pool {k_pool.shape[3]}, or "
            f"{h} heads not a multiple of {hkv} kv heads")
    if page_table.dim() != 2 or page_table.shape[0] != b or tuple(cur_len.shape) != (b,):
        raise ValueError(
            f"paged_attention: want page_table (B, n_pages) and cur_len (B,) for "
            f"B={b}, got {tuple(page_table.shape)}, {tuple(cur_len.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("paged_attention: inputs must be contiguous")


def paged_attention(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, n_pages) int32
    cur_len: torch.Tensor,  # (B,) int32
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    _check_inputs(q, k_pool, v_pool, page_table, cur_len)
    if q.device.type == "cpu":
        return paged_attention_plain(
            q, k_pool, v_pool, page_table, cur_len, window=window,
            softcap=softcap, scale=scale)
    b, h, hd = q.shape
    _, bs, hkv, _ = k_pool.shape
    if h // hkv > MAX_GROUP or hd > MAX_HEAD_DIM:
        raise ValueError(
            f"paged_attention kernel: at most {MAX_GROUP} query heads per kv "
            f"head and head_dim {MAX_HEAD_DIM}, got {h // hkv} and {hd}")
    out = torch.empty_like(q)
    KERNEL.launch(
        _DTYPES[q.dtype], ptr(q), ptr(k_pool), ptr(v_pool), ptr(page_table),
        ptr(cur_len), ptr(out), b, h, hkv, hd, bs, page_table.shape[1],
        int(window), float(softcap), float(scale), ctypes.c_void_p(stream_of(q)))
    return out
