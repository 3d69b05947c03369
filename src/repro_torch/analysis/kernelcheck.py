"""Pass 2: CUDA kernel lint over the ``kernels/`` package (the reference
``analysis/kernelcheck.py``, for hand-written CUDA in place of Pallas).

Each kernel module with a launch plan exports ``KERNEL_META``: the plan
function its launch uses (``plan_split``, ``plan_flash``, ``plan_matmul``,
``plan_strips``), its ``CudaKernel`` entries, and lint shapes that give
multi-block grids.  Because the plan the lint sees is the plan the launch
runs with, a tiling edit that stops covering the operands fails here,
before it reads or writes out of bounds on a card.

Rules:

* **KRN001** — the plan does not cover its operands: every query row, key,
  page, output tile or NW strip exactly once, no empty split or tile, the
  workspace shape the combine pass expects; or an entry's ctypes argtypes
  differ in arity from the ``extern "C"`` entry parsed from
  ``kernels/csrc/*.cu``, or from the argument list the wrapper builds.
* **KRN002** — an index-bearing operand (the page table, ``cur_len``) is
  not among the arguments the paged wrapper hands to its launch
  (``paged_attention.launch_args``, built on CPU tensors without a launch).
* **KRN003** — dtype contract between the quantized entries and the
  ``kernels.quant`` pool layout: codes in ``quant.storage_dtype``,
  ``(num_blocks, n_kv)`` f32 scales, the output in the query's dtype (the
  dequantization stays fused, never materialized), and ``scales_of`` of a
  page giving ``(n_kv,)`` f32.  On the CPU it goes through the wrappers'
  input checks and plain versions; on a card through the kernels.
* **KRN004** — ops<->ref oracle parity: every oracle parameter exists on
  the wrapper, and wrapper extras are kernel-only knobs.
"""

from __future__ import annotations

import inspect
import re

import torch

from repro_torch.analysis import Finding
from repro_torch.device import resolve_device

#: ops.* wrapper -> ref.* oracle, for KRN004 signature parity (the
#: reference's pairs, the port's oracle names, and the SSD scan).
ORACLE_PAIRS = (
    ("matmul", "matmul_ref"),
    ("flash_attention", "flash_attention_ref"),
    ("paged_attention", "paged_attention_ref"),
    ("paged_attention_multi", "paged_attention_multi_ref"),
    ("paged_attention_quant", "paged_attention_quant_ref"),
    ("paged_attention_multi_quant", "paged_attention_multi_quant_ref"),
    ("fwt", "fwt_ref"),
    ("nw_tile", "nw_ref"),
    ("nw_wavefront", "nw_full_ref"),
    ("ssd", "ssd_ref"),
)

#: Wrapper-only parameters that tune the kernel schedule, not the math —
#: the oracle legitimately lacks them.
KERNEL_KNOBS = frozenset(
    {"interpret", "block_q", "block_k", "block_m", "block_n", "block",
     "row_tile", "chunk"})

_ENTRY = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)


def c_entries(source: str) -> dict[str, int]:
    """``extern "C"`` entry -> parameter count, parsed from ``csrc/<source>``."""
    from repro_torch.kernels import _build

    text = (_build.CSRC / source).read_text()
    return {m.group(1): len([p for p in m.group(2).split(",") if p.strip()])
            for m in _ENTRY.finditer(text)}


def check_arity(name: str, kernel) -> list[Finding]:
    """KRN001: the ctypes argtypes of ``kernel`` against its C entry."""
    entries = c_entries(kernel.source)
    if kernel.symbol not in entries:
        return [Finding("KRN001", f"{name}:{kernel.symbol}",
                        f"no extern \"C\" entry {kernel.symbol} in csrc/{kernel.source}",
                        "kernel")]
    want = entries[kernel.symbol]
    if len(kernel.argtypes) != want:
        return [Finding("KRN001", f"{name}:{kernel.symbol}",
                        f"{len(kernel.argtypes)} ctypes argtypes for a C entry of {want} "
                        "parameters", "kernel")]
    return []


# -- plan coverage (KRN001) ----------------------------------------------------


def _cover(n: int, parts: int, size: int) -> str | None:
    """Why ``parts`` ranges of ``size`` do not cover [0, n) exactly once
    with none empty, or None."""
    if parts < 1 or size < 1:
        return f"{parts} parts of {size}"
    if parts * size < n:
        return f"{parts} x {size} covers {parts * size} of {n}"
    if (parts - 1) * size >= n:
        return f"{parts} x {size} over {n} leaves the last part empty"
    return None


def _check_split(plan, s: dict) -> list[str]:
    from repro_torch.kernels import paged_attention as PA

    rows = s["q_len"] * s["group"]
    bad = []
    why = _cover(rows, plan.tiles, plan.tile_rows)
    if why or plan.tile_rows > PA.MAX_TILE_ROWS:
        bad.append(f"row tiles: {why or f'tile_rows {plan.tile_rows} > {PA.MAX_TILE_ROWS}'}")
    why = _cover(s["n_pages"], plan.n_splits, plan.pages_per_split)
    if why:
        bad.append(f"page splits: {why}")
    if plan.grid != (s["batch"], s["n_kv"], plan.tiles * plan.n_splits):
        bad.append(f"grid {plan.grid} is not (batch, n_kv, tiles x splits)")
    ws = ((s["batch"] * s["n_kv"] * plan.n_splits * rows, s["head_dim"] + 2)
          if plan.n_splits > 1 else None)
    if plan.workspace_shape != ws:
        bad.append(f"workspace {plan.workspace_shape} != {ws} (acc, m, l per split row)")
    return bad


def _check_flash(plan, s: dict) -> list[str]:
    from repro_torch.kernels import flash_attention as FA

    if plan.body == "tc":
        rows = s["sq"] * (s["n_heads"] // s["n_kv"])
        why = _cover(rows, plan.grid[0], 16)
        bad = [f"m-tiles: {why}"] if why else []
        if plan.grid[1:] != (s["n_kv"], s["batch"]):
            bad.append(f"grid {plan.grid} is not (m-tiles, n_kv, batch)")
        if plan.key_splits != plan.warps or plan.key_tile != FA.KEY_TILE:
            bad.append(f"{plan.key_splits} key splits over {plan.warps} warps, key tile "
                       f"{plan.key_tile}")
        return bad
    why = _cover(s["sq"], plan.grid[1], FA.SIMT_ROWS)
    bad = [f"query tiles: {why}"] if why else []
    if (plan.grid[0], plan.grid[2]) != (s["batch"] * s["n_heads"], 1):
        bad.append(f"grid {plan.grid} is not (batch x heads, query tiles, 1)")
    return bad


def _check_matmul(plan, s: dict) -> list[str]:
    from repro_torch.kernels import streamed_matmul as MM

    bad = [f"{axis} tiles: {why}" for axis, why in (
        ("n", _cover(s["n"], plan.grid[0], MM.BLOCK[1])),
        ("m", _cover(s["m"], plan.grid[1], MM.BLOCK[0]))) if why]
    n_bf16 = (s["x_dtype"] == torch.bfloat16) + (s["y_dtype"] == torch.bfloat16)
    want = ("bf16", 1) if n_bf16 == 2 else ("tf32", 3 - n_bf16)
    if (plan.body, plan.products) != want:
        bad.append(f"body {plan.body} x {plan.products} for {s['x_dtype']} @ "
                   f"{s['y_dtype']}, want {want}")
    return bad


def _check_strips(plan, s: dict) -> list[str]:
    i1 = s.get("i1", s["rows"])
    cols = {j for i in range(s.get("i0", 0), i1) for j in range(s["cols"])
            if s["d0"] <= i + j < s["d1"]}
    strips = set(range(plan.j_lo, plan.j_lo + plan.n_strips))
    if strips != cols:
        return [f"strips {sorted(strips)} != the tile columns of the run {sorted(cols)}"]
    return []


#: KERNEL_META's ``cover``: what the plan's grid must cover.
_COVERAGE = {"split": _check_split, "flash": _check_flash, "matmul": _check_matmul,
             "strips": _check_strips}


def check_layout(name: str, meta: dict) -> list[Finding]:
    """KRN001 (plan coverage, arity) for one KERNEL_META entry, and for the
    paged entries the launch arguments themselves (arity, KRN002)."""
    findings = [f for k in meta["kernels"] for f in check_arity(name, k)]
    cover = _COVERAGE[meta["cover"]]
    for i, shape in enumerate(meta["lint_shapes"]):
        plan = meta["plan"](**shape)
        for msg in cover(plan, shape):
            findings.append(Finding("KRN001", f"{name}:shape[{i}]", msg, "kernel"))
        if meta["cover"] == "split":
            findings.extend(check_launch_args(name, i, shape))
    return findings


def check_launch_args(name: str, i: int, s: dict, launch_args=None) -> list[Finding]:
    """KRN001 arity and KRN002 for the paged entries at one lint shape: the
    argument list ``launch_args`` (the wrapper's) builds on CPU tensors,
    without a launch."""
    if launch_args is None:
        from repro_torch.kernels.paged_attention import launch_args

    findings = []
    b, hkv, hd, t = s["batch"], s["n_kv"], s["head_dim"], s["q_len"]
    h, bs = hkv * s["group"], 16
    q = torch.empty((b, t, h, hd) if t > 1 else (b, h, hd), dtype=torch.bfloat16)
    table = torch.zeros((b, s["n_pages"]), dtype=torch.int32)
    cur = torch.zeros((b,), dtype=torch.int32)
    for quant in (False, True):
        pool = torch.empty((s["n_pages"] + 1, bs, hkv, hd),
                           dtype=torch.int8 if quant else torch.bfloat16)
        scales = torch.empty((s["n_pages"] + 1, hkv)) if quant else None
        kernel, ws, args = launch_args(q, pool, pool, table, cur, torch.empty_like(q),
                                       k_scale=scales, v_scale=scales, window=0, softcap=0.0,
                                       scale=1.0, stream=None)
        target = f"{name}:{kernel.symbol}:shape[{i}]"
        if len(args) != len(kernel.argtypes):
            findings.append(Finding(
                "KRN001", target, f"the wrapper passes {len(args)} arguments to "
                f"{len(kernel.argtypes)} argtypes", "kernel"))
        passed = {a.value for a in args if hasattr(a, "value")}
        for what, tensor in (("page_table", table), ("cur_len", cur)):
            if tensor.data_ptr() not in passed:
                findings.append(Finding(
                    "KRN002", f"{target}:{what}",
                    f"{what} is index-bearing but never reaches the launch", "kernel"))
    return findings


# -- quant contract (KRN003) ---------------------------------------------------


def check_quant_contract(device=None, ops=None) -> list[Finding]:
    """KRN003: the quant entries of ``ops`` (the port's) accept pools in
    ``quant.storage_dtype`` with per-(page, kv-head) f32 scales and return
    the query dtype, on ``device`` (the card, through the kernels, unless
    the caller asks for the CPU and its plain versions)."""
    from repro_torch.kernels import quant
    if ops is None:
        from repro_torch.kernels import ops

    findings: list[Finding] = []
    b, h, hkv, hd, nb, bs, t = 2, 4, 2, 16, 9, 8, 3
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(0)
    for kind in quant.KV_DTYPES:
        if not quant.is_quantized(kind):
            continue
        code = quant.storage_dtype(kind)
        rows = torch.randn((nb, bs, hkv, hd), generator=gen)
        scale = quant.scales_of(rows, kind)
        pool = quant.quantize(rows, scale, kind).to(dev)
        scale = scale.to(dev)
        table = torch.arange(1, 1 + b * 4, dtype=torch.int32).reshape(b, 4).remainder(nb).to(dev)
        cur = torch.tensor([5, 30], dtype=torch.int32).to(dev)
        for entry, qshape in (("paged_attention_quant", (b, h, hd)),
                              ("paged_attention_multi_quant", (b, t, h, hd))):
            q = torch.randn(qshape, generator=gen).to(device=dev, dtype=torch.bfloat16)
            target = f"{entry}[{kind}]"
            if pool.dtype != code:
                findings.append(Finding(
                    "KRN003", target, f"quant.quantize stores {pool.dtype}, storage_dtype "
                    f"says {code}", "kernel"))
                continue
            try:
                out = getattr(ops, entry)(q, pool, pool, scale, scale, table, cur)
            except (ValueError, RuntimeError) as e:
                findings.append(Finding(
                    "KRN003", target, f"kernel rejects the quant.py pool layout: "
                    f"{type(e).__name__}: {str(e).splitlines()[0]}", "kernel"))
                continue
            if out.dtype != q.dtype or out.shape != q.shape:
                findings.append(Finding(
                    "KRN003", target, f"output {tuple(out.shape)} {out.dtype} != query "
                    f"{tuple(q.shape)} {q.dtype} (dequant must stay fused in the kernel)",
                    "kernel"))
        # The scale layout the kernel reads must be what quant.scales_of
        # produces for a page of rows.
        sc = quant.scales_of(torch.zeros((bs, hkv, hd)), kind)
        if tuple(sc.shape) != (hkv,) or sc.dtype != torch.float32:
            findings.append(Finding(
                "KRN003", f"quant.scales_of[{kind}]",
                f"per-page scale is {tuple(sc.shape)} {sc.dtype}, kernel expects "
                "(kv_heads,) float32 per page", "kernel"))
    return findings


# -- oracle parity (KRN004) ----------------------------------------------------


def check_oracle_parity(ops=None, ref=None) -> list[Finding]:
    """KRN004: ops.* and ref.* agree on the math-relevant signature."""
    if ops is None or ref is None:
        from repro_torch.kernels import ops, ref

    findings: list[Finding] = []
    for op_name, ref_name in ORACLE_PAIRS:
        op_fn = getattr(ops, op_name, None)
        ref_fn = getattr(ref, ref_name, None)
        if op_fn is None or ref_fn is None:
            findings.append(Finding("KRN004", f"{op_name}<->{ref_name}",
                                    "oracle pair is missing one side", "kernel"))
            continue
        op_params = set(inspect.signature(op_fn).parameters)
        ref_params = set(inspect.signature(ref_fn).parameters)
        missing = ref_params - op_params
        if missing:
            findings.append(Finding(
                "KRN004", op_name,
                f"oracle parameters {sorted(missing)} missing from the wrapper", "kernel"))
        extras = op_params - ref_params - KERNEL_KNOBS
        if extras:
            findings.append(Finding(
                "KRN004", op_name,
                f"wrapper-only parameters {sorted(extras)} are not declared kernel knobs "
                "— the oracle can't cover them", "kernel"))
    return findings


def audit_kernels(device=None) -> list[Finding]:
    """The full kernel lint: every KERNEL_META plan and launch, every
    entry's arity, the quant dtype contract on ``device`` (through the
    kernels on the card, the default; the plain versions on the CPU), and
    ops<->ref parity."""
    from repro_torch.kernels import (_build, flash_attention, fwt, nw_tile,  # noqa: F401
                                     paged_attention, ssd_chunk, streamed_matmul)

    findings: list[Finding] = []
    covered = set()
    for mod in (paged_attention, flash_attention, streamed_matmul, nw_tile):
        for name, meta in mod.KERNEL_META.items():
            findings.extend(check_layout(name, meta))
            covered.update(meta["kernels"])
    for kernel in _build.KERNELS:  # the entries without a plan (SSD, FWT): arity only
        if kernel not in covered and kernel.source in _build.SOURCES:
            findings.extend(check_arity(kernel.symbol, kernel))
    findings.extend(check_quant_contract(device))
    findings.extend(check_oracle_parity())
    return findings
