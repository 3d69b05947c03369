"""Quantized KV pages: per-page, per-kv-head scale quantization (the port's
own copy of the reference ``kernels/quant.py``).

A pool leaf keeps shape ``(r, num_blocks, block_size, n_kv_heads,
head_dim)`` but stores a narrow type; a parallel f32 scale leaf of shape
``(r, num_blocks, n_kv_heads)`` holds one scale per (layer, page, kv head):

    scale = absmax(page rows over (block_size, head_dim)) / QMAX
    q     = clip(round(x / scale), -127, 127)   (int8; round half to even)
    q     = cast(clip(x / scale, -448, 448))    (fp8 e4m3; clipped first:
                                                 an unclipped cast gives NaN)
    x~    = q * scale

The arithmetic is the reference's operation for operation, so equal inputs
give bit-equal codes and scales.
"""

from __future__ import annotations

import torch

#: Accepted ``kv_dtype`` values, "fp32" meaning the unquantized pool.
KV_DTYPES = ("fp32", "int8", "fp8")

#: kv_dtype -> (storage dtype, QMAX).
_QUANT = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}


def validate_kv_dtype(kv_dtype: str) -> str:
    if kv_dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {KV_DTYPES}, got {kv_dtype!r}")
    return kv_dtype


def is_quantized(kv_dtype: str) -> bool:
    return validate_kv_dtype(kv_dtype) != "fp32"


def storage_dtype(kv_dtype: str) -> torch.dtype:
    """The pool leaf type of a quantized mode."""
    return _QUANT[kv_dtype][0]


def qmax(kv_dtype: str) -> float:
    return _QUANT[kv_dtype][1]


def kv_dtype_of(codes: torch.Tensor) -> str:
    """The quantized mode a pool of ``codes`` stores."""
    for name, (dt, _) in _QUANT.items():
        if codes.dtype == dt:
            return name
    raise ValueError(f"{codes.dtype} is not a quantized pool type")


def scales_of(rows: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """``(..., block_size, n_kv_heads, head_dim)`` rows -> ``(...,
    n_kv_heads)`` f32 scales: absmax over (block_size, head_dim) / QMAX.
    An all-zero page gets scale 0 (and all-zero codes)."""
    return rows.float().abs().amax(dim=(-3, -1)) / qmax(kv_dtype)


def quantize(rows: torch.Tensor, scale: torch.Tensor, kv_dtype: str) -> torch.Tensor:
    """Quantize ``(..., bs, hkv, hd)`` rows with ``(..., hkv)`` scales."""
    dt, q = _QUANT[kv_dtype]
    inv = torch.where(scale > 0.0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    x = rows.float() * inv[..., None, :, None]
    if dt == torch.int8:
        return torch.clamp(torch.round(x), -q, q).to(dt)
    return torch.clamp(x, -q, q).to(dt)


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(..., bs, hkv, hd)`` codes back to f32 with ``(..., hkv)`` scales."""
    return codes.float() * scale[..., None, :, None]


def page_bytes_est(block_size: int, n_kv_heads: int, head_dim: int, kv_dtype: str,
                   *, compute_itemsize: int = 4) -> int:
    """Per-layer bytes of one K+V page, scale rows included (the analytic
    twin of ``PagedKVCache.page_bytes``)."""
    validate_kv_dtype(kv_dtype)
    if kv_dtype == "fp32":
        item, scale_bytes = compute_itemsize, 0
    else:
        item = torch.empty((), dtype=storage_dtype(kv_dtype)).element_size()
        scale_bytes = 2 * n_kv_heads * 4  # k_scale + v_scale rows, f32
    return 2 * block_size * n_kv_heads * head_dim * item + scale_bytes
