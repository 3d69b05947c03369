"""Paged decode attention: wrappers of the four C entries of
``csrc/paged_attention.cu``.

Replaces the TPU kernel ``repro/kernels/paged_attention.py::_paged_kernel``
in each of its uses: single-token queries (``paged_attention``, the decode
tick), a ``q_len > 1`` draft block per row (``paged_attention_multi``, the
speculative verify step), and their fused-dequant twins over int8 / fp8
pools with per-(page, kv head) f32 scales (``paged_attention_quant``,
``paged_attention_multi_quant``).  All four run one CUDA body, split-KV on
tensor cores, cut as :func:`plan_split` says (a single-token call is a
call with q_len 1); only a single-token call whose head_dim is not a
multiple of 16 runs the page-walking body instead
(:func:`single_token_body`).  Each entry has its own :class:`CudaKernel`
and launch count, one per call.  The bodies' designs and bounds are in the
CUDA source's notes.

On a CPU tensor a wrapper runs its plain version (from ``kernels/ref.py``);
on a CUDA tensor it launches the kernel or raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels._build import CudaKernel, ptr, stream_of
from repro_torch.kernels.ref import (
    paged_attention_multi_quant_ref as paged_attention_multi_quant_plain,
    paged_attention_multi_ref as paged_attention_multi_plain,
    paged_attention_quant_ref as paged_attention_quant_plain,
    paged_attention_ref as paged_attention_plain,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CODES = {torch.int8: 2, torch.float8_e4m3fn: 3}  # quantized pools' code types
MAX_HEAD_DIM = 256

_I, _P, _F = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
# n_heads, n_kv, head_dim, block_size, n_pages, window, softcap, scale, stream
_GEOM = [_I, _I, _I, _I, _I, _I, _F, _F, _P]
# Every entry: dtype, [code,] q, pools, [scales,] table, lengths, out,
# workspace, batch, [q_len,] tile_rows, pages_per_split, then the geometry.
KERNEL = CudaKernel("paged_attention.cu", "paged_attention",
                    [_I, *[_P] * 7, _I, _I, _I, *_GEOM])
MULTI_KERNEL = CudaKernel("paged_attention.cu", "paged_attention_multi",
                          [_I, *[_P] * 7, _I, _I, _I, _I, *_GEOM])
QUANT_KERNEL = CudaKernel("paged_attention.cu", "paged_attention_quant",
                          [_I, _I, *[_P] * 9, _I, _I, _I, *_GEOM])
MULTI_QUANT_KERNEL = CudaKernel("paged_attention.cu", "paged_attention_multi_quant",
                                [_I, _I, *[_P] * 9, _I, _I, _I, _I, *_GEOM])


def single_token_body(head_dim: int) -> str:
    """The CUDA body a single-token entry runs: ``"split"`` (split-KV on
    tensor cores, mma k-steps of 16 columns) for head_dim a multiple of 16,
    as in every configuration; ``"walk"`` (one block per sequence and kv
    head walking its pages) for any other."""
    return "split" if head_dim % 16 == 0 else "walk"


MAX_TILE_ROWS = 64  # query rows one block of the split body holds
WALK_MAX_GROUP = 16  # query heads per kv head the walk body holds
TARGET_BLOCKS = 4 * 132  # about four blocks on each of the H100's 132 SMs
MIN_PAGES_PER_SPLIT = 2


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """How the split body cuts one call: the q_len * g rows of a
    (sequence, kv head) into ``tiles`` balanced tiles of at most
    ``tile_rows``, and the page table into ``n_splits`` ranges of
    ``pages_per_split`` pages (the last may be shorter).  One block per
    (sequence, kv head, tile, split); with more than one split each block
    writes partial (m, l, acc) rows to an f32 workspace of
    ``workspace_shape`` (acc in the first head_dim columns, then m and l)
    and a combine pass sums them."""

    tiles: int
    tile_rows: int
    pages_per_split: int
    n_splits: int
    grid: tuple[int, int, int]
    workspace_shape: tuple[int, int] | None

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan_split(batch: int, n_kv: int, q_len: int, group: int, n_pages: int,
               head_dim: int) -> SplitPlan:
    """The split body's cut of a call, from its shape alone (the
    host never reads cur_len): enough splits for about TARGET_BLOCKS blocks,
    but at least MIN_PAGES_PER_SPLIT pages per split where the table has
    them."""
    rows = q_len * group
    tiles = -(-rows // MAX_TILE_ROWS)
    tile_rows = -(-rows // tiles)
    pairs = batch * n_kv * tiles
    max_splits = max(1, -(-n_pages // MIN_PAGES_PER_SPLIT))
    splits = min(max(1, -(-TARGET_BLOCKS // pairs)), max_splits)
    pps = -(-n_pages // splits)
    n_splits = -(-n_pages // pps)
    ws = (batch * n_kv * n_splits * rows, head_dim + 2) if n_splits > 1 else None
    return SplitPlan(tiles, tile_rows, pps, n_splits, (batch, n_kv, tiles * n_splits), ws)


#: The analyzer's view of this module (``analysis.kernelcheck``): the plan
#: every entry's launch uses, its entries, and shapes whose plans have
#: several row tiles and several page splits (KRN001), at which the launch
#: arguments are also built (KRN001 arity, KRN002).
KERNEL_META = {
    "paged_attention": dict(
        cover="split", plan=plan_split,
        kernels=(KERNEL, MULTI_KERNEL, QUANT_KERNEL, MULTI_QUANT_KERNEL),
        lint_shapes=(
            dict(batch=4, n_kv=8, q_len=1, group=4, n_pages=9, head_dim=128),  # decode tick
            dict(batch=4, n_kv=8, q_len=5, group=4, n_pages=9, head_dim=128),  # verify block
            dict(batch=1, n_kv=2, q_len=40, group=4, n_pages=37, head_dim=64),  # 3 row tiles
            dict(batch=64, n_kv=8, q_len=1, group=8, n_pages=128, head_dim=128),
        )),
}


def _check_inputs(q, k_pool, v_pool, page_table, cur_len, *, q_dims: int,
                  k_scale=None, v_scale=None) -> None:
    """Raise ``ValueError`` unless the inputs are what the kernel takes:
    one cpu or cuda device; f32 or bf16 q with pools of q's type, or int8 /
    fp8 code pools with (num_blocks, Hkv) f32 scales; int32 table and
    lengths; consistent shapes; contiguous memory."""
    quant = k_scale is not None
    name = "paged_attention" + ("_multi" if q_dims == 4 else "") + ("_quant" if quant else "")
    ts = (q, k_pool, v_pool, page_table, cur_len) + ((k_scale, v_scale) if quant else ())
    if any(t.device != q.device for t in ts) or q.device.type not in ("cpu", "cuda"):
        raise ValueError(
            f"{name}: all inputs must be on one cpu or cuda device, got "
            f"{[str(t.device) for t in ts]}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: q must be float32 or bfloat16, got {q.dtype}")
    if quant:
        if k_pool.dtype not in _CODES or v_pool.dtype != k_pool.dtype:
            raise ValueError(
                f"{name}: pools must share int8 or float8_e4m3fn codes, got "
                f"{k_pool.dtype}/{v_pool.dtype}")
        if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
            raise ValueError(f"{name}: k_scale and v_scale must be float32")
    elif k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(
            f"{name}: q and pools must share float32 or bfloat16, got "
            f"{q.dtype}/{k_pool.dtype}/{v_pool.dtype}")
    if page_table.dtype != torch.int32 or cur_len.dtype != torch.int32:
        raise ValueError(f"{name}: page_table and cur_len must be int32")
    want_q = "(B, T, H, hd)" if q_dims == 4 else "(B, H, hd)"
    if q.dim() != q_dims or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(
            f"{name}: want q {want_q} and pools (nb, bs, Hkv, hd), got "
            f"{tuple(q.shape)}, {tuple(k_pool.shape)}, {tuple(v_pool.shape)}")
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    nb, _, hkv, _ = k_pool.shape
    if k_pool.shape[3] != hd or h % hkv:
        raise ValueError(
            f"{name}: head_dim {hd} vs pool {k_pool.shape[3]}, or "
            f"{h} heads not a multiple of {hkv} kv heads")
    if quant and (tuple(k_scale.shape) != (nb, hkv) or tuple(v_scale.shape) != (nb, hkv)):
        raise ValueError(
            f"{name}: want k_scale and v_scale (num_blocks, Hkv) = {(nb, hkv)}, got "
            f"{tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b or tuple(cur_len.shape) != (b,):
        raise ValueError(
            f"{name}: want page_table (B, n_pages) and cur_len (B,) for "
            f"B={b}, got {tuple(page_table.shape)}, {tuple(cur_len.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name}: inputs must be contiguous")
    if q.device.type != "cuda":
        return
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name} kernel: head_dim at most {MAX_HEAD_DIM}, got {hd}")
    if q_dims == 3 and single_token_body(hd) == "walk":
        if h // hkv > WALK_MAX_GROUP:
            raise ValueError(
                f"{name} kernel: head_dim {hd} (not a multiple of 16) takes at most "
                f"{WALK_MAX_GROUP} query heads per kv head, got {h // hkv}")
        return
    # The split body: mma k-steps of 16 columns, 16-byte copies.
    if hd % 16:
        raise ValueError(f"{name} kernel: head_dim a multiple of 16, got {hd}")
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError(f"{name} kernel: q and pools must start on a 16-byte boundary")


def _split_args(q, k_pool, page_table) -> tuple[torch.Tensor | None, list]:
    """An entry's workspace (kept alive by the caller across the launch)
    and its workspace pointer, batch, q_len (draft-block entries only),
    tile_rows and pages_per_split arguments, from :func:`plan_split`; for
    the walk body no workspace and pages_per_split 0."""
    b, h, hd = q.shape[0], q.shape[-2], q.shape[-1]
    multi = q.dim() == 4
    if not multi and single_token_body(hd) == "walk":
        return None, [None, b, 0, 0]
    t = q.shape[1] if multi else 1
    hkv = k_pool.shape[2]
    plan = plan_split(b, hkv, t, h // hkv, page_table.shape[1], hd)
    ws = (torch.empty(plan.workspace_shape, dtype=torch.float32, device=q.device)
          if plan.workspace_shape else None)
    return ws, [None if ws is None else ptr(ws), b, *([t] if multi else []), plan.tile_rows,
                plan.pages_per_split]


def launch_args(q, k_pool, v_pool, page_table, cur_len, out, *, k_scale=None, v_scale=None,
                window: int, softcap: float, scale: float, stream: int | None
                ) -> tuple[CudaKernel, torch.Tensor | None, list]:
    """The entry a call launches, its workspace (kept alive by the caller
    across the launch) and its whole argument list, from the tensors
    alone: the wrappers launch exactly this, and the analyzer
    (``analysis.kernelcheck``) builds it on CPU tensors, without a launch,
    to see that the page table and lengths reach the kernel."""
    quant = k_scale is not None
    kernel = {(3, False): KERNEL, (4, False): MULTI_KERNEL, (3, True): QUANT_KERNEL,
              (4, True): MULTI_QUANT_KERNEL}[(q.dim(), quant)]
    ws, split = _split_args(q, k_pool, page_table)
    head = [_DTYPES[q.dtype]] + ([_CODES[k_pool.dtype]] if quant else [])
    tensors = [q, k_pool, v_pool, *((k_scale, v_scale) if quant else ()), page_table,
               cur_len, out]
    _, bs, hkv, hd = k_pool.shape
    geometry = [q.shape[-2], hkv, hd, bs, page_table.shape[1], int(window), float(softcap),
                float(scale), ctypes.c_void_p(stream)]
    return kernel, ws, [*head, *map(ptr, tensors), *split, *geometry]


def _launch(q, k_pool, v_pool, page_table, cur_len, **kw) -> torch.Tensor:
    out = torch.empty_like(q)
    kernel, ws, args = launch_args(q, k_pool, v_pool, page_table, cur_len, out,
                                   stream=stream_of(q), **kw)
    kernel.launch(*args)
    return out


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
    _check_inputs(q, k_pool, v_pool, page_table, cur_len, q_dims=3)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pool, v_pool, page_table, cur_len,
                                     window=window, softcap=softcap, scale=scale)
    return _launch(q, k_pool, v_pool, page_table, cur_len, window=window, softcap=softcap,
                   scale=scale)


def paged_attention_multi(
    q: torch.Tensor,  # (B, T, H, hd): token t of row b at position cur_len[b] + t
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    cur_len: torch.Tensor,  # (B,) int32: position of token 0
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    _check_inputs(q, k_pool, v_pool, page_table, cur_len, q_dims=4)
    if q.device.type == "cpu":
        return paged_attention_multi_plain(q, k_pool, v_pool, page_table, cur_len,
                                           window=window, softcap=softcap, scale=scale)
    return _launch(q, k_pool, v_pool, page_table, cur_len, window=window, softcap=softcap,
                   scale=scale)


def paged_attention_quant(
    q: torch.Tensor,  # (B, H, hd)
    k_pool: torch.Tensor,  # (num_blocks, block_size, Hkv, hd) int8 / fp8 codes
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (num_blocks, Hkv) f32
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    _check_inputs(q, k_pool, v_pool, page_table, cur_len, q_dims=3, k_scale=k_scale,
                  v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_attention_quant_plain(q, k_pool, v_pool, k_scale, v_scale, page_table,
                                           cur_len, window=window, softcap=softcap,
                                           scale=scale)
    return _launch(q, k_pool, v_pool, page_table, cur_len, k_scale=k_scale, v_scale=v_scale,
                   window=window, softcap=softcap, scale=scale)


def paged_attention_multi_quant(
    q: torch.Tensor,  # (B, T, H, hd)
    k_pool: torch.Tensor,  # int8 / fp8 codes
    v_pool: torch.Tensor,
    k_scale: torch.Tensor,  # (num_blocks, Hkv) f32
    v_scale: torch.Tensor,
    page_table: torch.Tensor,
    cur_len: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
    scale: float,
) -> torch.Tensor:
    _check_inputs(q, k_pool, v_pool, page_table, cur_len, q_dims=4, k_scale=k_scale,
                  v_scale=v_scale)
    if q.device.type == "cpu":
        return paged_attention_multi_quant_plain(
            q, k_pool, v_pool, k_scale, v_scale, page_table, cur_len, window=window,
            softcap=softcap, scale=scale)
    return _launch(q, k_pool, v_pool, page_table, cur_len, k_scale=k_scale, v_scale=v_scale,
                   window=window, softcap=softcap, scale=scale)
