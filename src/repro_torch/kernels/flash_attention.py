"""Prefill attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::_flash_kernel``
(``flash_attention_kernel``) and covers what the reference model runs as
``attention.flash_attention_ref`` for a prefill chunk: ``q_offset``, a
bidirectional prefix (``prefix_len``, prefix-LM), non-causal attention
(an encoder, cross-attention), GQA without a broadcast copy, and lengths
that are not tile multiples.  Three CUDA bodies, as :func:`plan_flash` picks
them from the shape and type: bf16 with head_dim 64, 128 or 256 at long
query blocks or long key ranges runs on ``wgmma`` with TMA copies (``"wg"``,
its keys split across blocks where the grid would leave SMs idle), other
bf16 with head_dim a multiple of 16 on ``mma.sync`` (``"tc"``), f32 or any
other head_dim on the SIMT body (``"simt"``).  The bodies' designs and
bounds are in the CUDA source's header; ``ref.flash_attention_tc_plain``
emulates the two tensor-core bodies' rounding and key splits for the tests.

On a CPU tensor the wrapper runs the plain version
(:func:`flash_attention_plain`, from ``kernels/ref.py``); on a CUDA tensor
it launches the planned body or raises — it never falls back to another
body or to the plain version.
:func:`flash_attention_lse` also returns each row's natural-log
logsumexp, (B, Sq, H) f32, which the kernel writes beside the output (the
training path's backward recomputes P from it); the serving path passes
the kernel a null ``lse`` and pays nothing for it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core import costanalysis
from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import flash_attention_lse_ref as flash_attention_lse_plain
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_I, _P = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel(
    "flash_attention.cu", "flash_attention",
    [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, ctypes.c_float, _I, _I, _I, _I, _P, _P])
BODIES = ("simt", "tc", "wg")  # the C entry's body codes 0, 1, 2; KERNEL.parts' keys

TC_WARPS = 4  # warps a block of the tensor-core body
KEY_TILE = 16  # keys of one softmax step of the tensor-core body
SIMT_ROWS, SIMT_KEYS = 16, 32  # the SIMT body's query and key tiles
WG_HEAD_DIMS = (64, 128, 256)  # the wgmma body's instantiations
WG_CONSUMERS = {64: 3, 128: 2, 256: 1}  # most consumer warpgroups a block (registers)
# The wgmma body where a call has at least WG_MIN_KEYS keys or WG_MIN_WORK
# query rows (Sq * g) x keys a kv head; below both (the serve's chunks of
# 64), the tc body.  The crossover measured on the H100 by
# launch/flash_bodies.py (PERF.md): at 2^16 rows x keys the two
# bodies are within 7% either way.
WG_MIN_KEYS, WG_MIN_WORK = 512, 1 << 17
SMS = 132  # the H100's SMs: a key split fills one wave of blocks
WG_MIN_SPLIT_TILES = 2  # key tiles a split takes at least


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How one call runs.  ``body`` "tc": grid (m-tiles, Hkv, B) of ``warps``
    warps, each block one m-tile of 16 of the Sq * g rows of a (b, kv head),
    its ``key_splits`` = ``warps`` warps sharing each staged K/V tile and
    splitting its 16-key softmax steps (``key_tile``) among them.  ``body``
    "wg": grid (m-tiles x ``key_splits``, Hkv, B), a block one consumer
    warpgroup of 64 rows for each 4 of its ``warps`` plus a producer warp
    (:attr:`block_rows`: 64, 128 or 192), key tiles of ``key_tile`` (128,
    or 64 at head_dim 256), the keys cut into ``key_splits`` contiguous
    runs of :func:`tiles_per_split` tiles, each its own block, combined by
    a second kernel when more than one.  ``body`` "simt": grid (B * H, Sq /
    16) of 4 warps, one query head a block, key tiles of 32."""

    body: str
    grid: tuple[int, int, int]
    warps: int
    key_splits: int
    key_tile: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def block_rows(self) -> int:
        """Query rows a block: an m-tile of the (b, kv head)'s Sq * g rows
        (one query head's for the SIMT body)."""
        if self.body == "wg":
            return 64 * ((self.warps - 1) // 4)
        return 16 if self.body == "tc" else SIMT_ROWS


def tiles_per_split(plan: FlashPlan, sk: int) -> int:
    """Key tiles of each of the wgmma body's contiguous key splits over
    ``sk`` keys (the last may have fewer)."""
    return _cdiv(_cdiv(sk, plan.key_tile), plan.key_splits)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan_flash(batch: int, sq: int, n_heads: int, n_kv: int, head_dim: int,
               dtype: torch.dtype, *, sk: int) -> FlashPlan:
    """The body and tiling of a call, from its shape and type alone: the
    SIMT body for f32 or a head_dim that is not a multiple of 16; the wgmma
    body (:func:`wg_plan`) for bf16 at head_dim 64 / 128 / 256 with at least
    ``WG_MIN_KEYS`` keys (Sk) or ``WG_MIN_WORK`` rows (Sq * g) x keys a kv
    head; else the tensor-core body (:func:`tc_plan`)."""
    if dtype != torch.bfloat16 or head_dim % 16:
        return FlashPlan("simt", (batch * n_heads, _cdiv(sq, SIMT_ROWS), 1), 4, 1, SIMT_KEYS)
    rows = sq * (n_heads // n_kv)
    if head_dim in WG_HEAD_DIMS and (sk >= WG_MIN_KEYS or rows * sk >= WG_MIN_WORK):
        return wg_plan(batch, sq, n_heads, n_kv, head_dim, sk=sk)
    return tc_plan(batch, sq, n_heads, n_kv)


def tc_plan(batch: int, sq: int, n_heads: int, n_kv: int) -> FlashPlan:
    """The tensor-core body's tiling: one 16-row m-tile a block."""
    rows = sq * (n_heads // n_kv)
    return FlashPlan("tc", (_cdiv(rows, 16), n_kv, batch), TC_WARPS, TC_WARPS, KEY_TILE)


def wg_plan(batch: int, sq: int, n_heads: int, n_kv: int, head_dim: int, *,
            sk: int) -> FlashPlan:
    """The wgmma body's tiling (head_dim 64 / 128 / 256): as many consumer
    warpgroups of 64 rows a block as a kv head's rows fill, up to
    ``WG_CONSUMERS`` (3 at head_dim 64, 2 at 128, 1 at 256: registers); a
    key split where the blocks of the m-tiles fill at most a quarter of the
    ``SMS``: enough splits to fill them, each of at least
    ``WG_MIN_SPLIT_TILES`` key tiles, none empty."""
    rows = sq * (n_heads // n_kv)
    consumers = min(WG_CONSUMERS[head_dim], _cdiv(rows, 64))
    block_rows = 64 * consumers
    key_tile = 128 if head_dim <= 128 else 64
    m_tiles = _cdiv(rows, block_rows)
    key_tiles = _cdiv(sk, key_tile)
    base = m_tiles * n_kv * batch
    splits = 1
    if 4 * base <= SMS:
        splits = max(1, min(_cdiv(SMS, base), key_tiles // WG_MIN_SPLIT_TILES))
    splits = _cdiv(key_tiles, _cdiv(key_tiles, splits))  # none empty
    return FlashPlan("wg", (m_tiles * splits, n_kv, batch), 4 * consumers + 1, splits, key_tile)


#: The analyzer's view of this module (``analysis.kernelcheck``): the plan
#: the launch uses and shapes of several m-tiles and all three bodies (KRN001).
KERNEL_META = {
    "flash_attention": dict(
        cover="flash", plan=plan_flash, kernels=(KERNEL,),
        lint_shapes=(
            dict(batch=1, sq=64, n_heads=32, n_kv=8, head_dim=128, dtype=torch.bfloat16, sk=128),
            dict(batch=2, sq=37, n_heads=16, n_kv=16, head_dim=64, dtype=torch.bfloat16, sk=37),
            dict(batch=1, sq=1500, n_heads=16, n_kv=16, head_dim=64, dtype=torch.float32,
                 sk=1500),
            dict(batch=3, sq=20, n_heads=6, n_kv=2, head_dim=24, dtype=torch.bfloat16, sk=20),
            # the wgmma body: whisper's encoder and cross-attention (a key
            # split), training's 4 x 512, paligemma's prefix chunk (hd 256)
            dict(batch=1, sq=1500, n_heads=16, n_kv=16, head_dim=64, dtype=torch.bfloat16,
                 sk=1500),
            dict(batch=1, sq=64, n_heads=16, n_kv=16, head_dim=64, dtype=torch.bfloat16,
                 sk=1500),
            dict(batch=4, sq=512, n_heads=32, n_kv=8, head_dim=128, dtype=torch.bfloat16,
                 sk=512),
            dict(batch=1, sq=320, n_heads=8, n_kv=1, head_dim=256, dtype=torch.bfloat16,
                 sk=320),
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


def _launch(q, k, v, lse, *, causal, window, softcap, scale, q_offset, prefix_len,
            plan: FlashPlan | None = None) -> torch.Tensor:
    """Launch the kernel on CUDA tensors; ``lse`` is a (B, Sq, H) f32
    output or None.  ``plan``: :func:`plan_flash`'s unless given (a script
    that times one body against another at the same shape)."""
    b, sq, h, hd = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention kernel: head_dim {hd} > {MAX_HEAD_DIM}")
    plan = plan or plan_flash(b, sq, h, hkv, hd, q.dtype, sk=sk)
    if plan.body != "simt" and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"flash_attention kernel: the {plan.body} body copies q, k and v "
                         "in 16-byte chunks; they must start on 16-byte boundaries")
    out = torch.empty_like(q)
    ws = None
    if plan.key_splits > 1 and plan.body == "wg":  # each split's (acc, m, l) a row
        ws = torch.empty((b * hkv * plan.key_splits * sq * (h // hkv), hd + 2),
                         dtype=torch.float32, device=q.device)
    KERNEL.launch(
        _DTYPES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(out),
        ptr(lse) if lse is not None else None, b, sq, sk, h, hkv,
        hd, int(q_offset), int(bool(causal)), int(prefix_len), int(window), float(softcap),
        float(scale), BODIES.index(plan.body), plan.block_rows, plan.key_splits,
        tiles_per_split(plan, sk), ptr(ws) if ws is not None else None,
        ctypes.c_void_p(stream_of(q)), part=plan.body)
    return out


def cost(q, k, *, causal: bool, window: int, q_offset: int, prefix_len: int,
         lse: bool) -> tuple[float, float]:
    """(flops, bytes) of one call: the scores and P V over the keys each
    query sees (causal up to its position or the end of a bidirectional
    prefix, else every key; within the window), and q, k, v read once, the
    output (and the lse) written once."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    qpos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk, np.maximum(qpos + 1, prefix_len)) if causal else np.full(sq, sk)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(sq, dtype=np.int64)
    keys = int(np.maximum(hi - lo, 0).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + (b * sq * h * 4 if lse else 0)
    return 4.0 * b * keys * h * hd, float(nbytes)


def _checked(q, k, v, prefix_len: int) -> None:
    _check_inputs(q, k, v)
    if prefix_len < 0:
        raise ValueError(f"flash_attention: prefix_len must be >= 0, got {prefix_len}")


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
    _checked(q, k, v, prefix_len)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, prefix_len=prefix_len)
    return costanalysis.as_kernel(
        lambda: (flash_attention_plain(q, k, v, **kw) if q.device.type == "cpu"
                 else _launch(q, k, v, None, **kw)),
        lambda: cost(q, k, causal=causal, window=window, q_offset=q_offset,
                     prefix_len=prefix_len, lse=False))


def flash_attention_lse(
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`flash_attention` and the natural-log logsumexp of each row's
    visible scores, (B, Sq, H) f32 (a row that sees no key: about -1e30,
    finite)."""
    _checked(q, k, v, prefix_len)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, prefix_len=prefix_len)

    def run():
        if q.device.type == "cpu":
            return flash_attention_lse_plain(q, k, v, **kw)
        b, sq, h, _ = q.shape
        lse = torch.empty((b, sq, h), dtype=torch.float32, device=q.device)
        return _launch(q, k, v, lse, **kw), lse

    return costanalysis.as_kernel(
        run, lambda: cost(q, k, causal=causal, window=window, q_offset=q_offset,
                          prefix_len=prefix_len, lse=True))
