"""Variant builds of the port's CUDA kernels, timed on the card.

A variant is a kernel's source with a few strings replaced -- a tiling
constant, or a piece of work taken out -- built with the port's nvcc flags
into ``build/variants/`` and swapped into the wrapper's ``CudaKernel`` for
the timing, then held against the plain version (a variant with work taken
out is expected to disagree, and its line says so).  The variants are the
design questions the kernels' sources and PERF.md answer with times:

  * ssd, at the serve's shape (b = 1, a 64-token chunk, H = 80, P = 64,
    N = 128, bf16, a carried state): the tensor-core body with 64 columns
    of P a block (the source's), 32 and 16, and without its products;
  * nw, at the streaming path's shape (one 2048^2 task of +-1 scores, B =
    32, one launch): west-value groups of 4 rows (the source's), 2, 8 and
    16, and without the west values' loads and checks (every strip then
    runs at once: the rows alone);
  * fwt, both passes of a 2^22 f32 task (row pass on (4096, 1024), column
    pass on its output), each over a rotation of 8 tasks (128 MB, past the
    50 MB L2): strips of 8 columns (the source's) and 4, the column pass
    with 256 threads a block in place of 512, without the butterflies
    (its loads and stores alone: the column pass's phase-1 and phase-2
    stages and the row pass's too), without the shuffle stages (both
    passes' lane bits), and with every block of the column pass reading
    its rows in the same order (the source staggers the blocks' starts).
    A strip of 16 columns is 256 KB of f32 at b1 = 4096, more than the 227
    KB a block may use, so it has no variant.

    PYTHONPATH=src python -m repro_torch.launch.variants [--kernel ssd nw fwt]
        [--parent DIR]

One line per variant and timed call, in the order source, variants,
source: device time (calls queued behind a spin kernel, so that the events
see the card, not the host's issue rate) and the largest error against the
plain version; then the card's name and power limit.  ``--parent DIR``
(an unpacked tree of another commit, e.g. ``git archive`` of the parent
into ``build/``) times the whole ``ops.fwt`` of a 2^22 f32 task, cold (the
same rotation) and warm (one task again and again), in that tree and in
this one, each in its own process, in the order parent, this, this,
parent.  Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import fwt as FWT
from repro_torch.kernels import nw_tile as NW
from repro_torch.kernels import ssd_chunk as SSD

OUT = _build.BUILD_DIR / "variants"

SSD_COLS = "__host__ __device__ constexpr int cols_for(int n) { return n >= 256 ? 32 : 64; }"
NW_GROUP = "constexpr int kGroup = 4;"
NW_FETCH = ("        if (lk) word = link_word(r, j, g0 + c, kB);\n"
            "        else value = state_west(r, j, g0 + c, kB);\n")
FWT_WIDTH = "constexpr int kStripWidth = 8;"
FWT_THREADS = "constexpr int kColumnThreads = 512;"
FWT_SHUFFLES = "    if (kLv + j >= lo && kLv + j < hi) lane_stage(v, lane, 1 << j);\n"
FWT_STAGGER = "    const int i = words > 1024 ? (i0 + blockIdx.x) & ((words >> 10) - 1) : i0;\n"
FWT_STAGES = [("  chunk_stages<VEC, G>(v, lane, 0, lb);\n", ""),
              ("    chunk_stages<VEC, kG>(v, lane, w, sb < 10 ? sb : 10);\n", ""),
              ("      if (10 + j < sb) reg_stage(v, 1 << j);\n", "      ;\n")]
VARIANTS = {  # kernel -> {variant: [(old, new), ...]}; the source first
    "ssd": {
        "cols 64 (source)": [],
        "cols 32": [(SSD_COLS, SSD_COLS.replace("n >= 256", "n >= 128"))],
        "cols 16": [(SSD_COLS, SSD_COLS.replace("n >= 256 ? 32", "n >= 128 ? 16"))],
        "no products": [("mma_bf16(", "skip_mma("),
                        ("namespace tc {\n", "namespace tc {\n__device__ __forceinline__ void "
                         "skip_mma(float (&)[4], const uint32_t (&)[4], uint32_t, uint32_t) {}\n")],
    },
    "nw": {
        "group 4 (source)": [],
        "group 2": [(NW_GROUP, "constexpr int kGroup = 2;")],
        "group 8": [(NW_GROUP, "constexpr int kGroup = 8;")],
        "group 16": [(NW_GROUP, "constexpr int kGroup = 16;")],
        "no west loads": [(NW_FETCH, "        word = static_cast<unsigned long long>(g0 + c + 1)"
                                     " << 32;\n        value = 0.f;\n")],
    },
    "fwt": {
        "W 8 (source)": [],
        "W 4": [(FWT_WIDTH, "constexpr int kStripWidth = 4;")],
        "columns 256 threads": [(FWT_THREADS, "constexpr int kColumnThreads = 256;")],
        "no butterflies": FWT_STAGES,
        "no shuffle stages": [(FWT_SHUFFLES, "")],
        "rows in order": [(FWT_STAGGER, "    const int i = i0;\n")],
    },
}
_SOURCES = {"ssd": "ssd_chunk.cu", "nw": "nw_tile.cu", "fwt": "fwt.cu"}
_KERNELS = {"ssd": (SSD.KERNEL,), "nw": (NW.KERNEL,), "fwt": (FWT.KERNEL, FWT.COLUMNS_KERNEL)}
FWT_TASKS = 8  # 2^22 f32 tasks in the cold rotation: 128 MB, past the 50 MB L2


def device_ms(fn, iters: int) -> float:
    """Mean device time per call, the ``iters`` calls queued behind a spin
    kernel (~0.2 s) so that they run back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(400_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_variants(kernel: str) -> dict[str, list[tuple]]:
    """Each variant of ``kernel`` built into OUT (one nvcc a variant, all
    started together): name -> [(library, entry point)] in the order of
    ``_KERNELS[kernel]``."""
    OUT.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC / _SOURCES[kernel]).read_text()
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS[kernel].items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{kernel} variant {name!r}: {old[:40]!r} is not in the source")
            src = src.replace(old, new)
        path = OUT / f"{kernel}_{i}.cu"
        path.write_text(src)
        lib = path.with_suffix(".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(lib),
               str(path)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), lib)
    built = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{kernel} variant {name!r} failed to build:\n{log}")
        handle = ctypes.CDLL(str(lib))
        built[name] = []
        for k in _KERNELS[kernel]:
            fn = getattr(handle, k.symbol)
            fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
            built[name].append((handle, fn))
    return built


def _cases(kernel: str, seed: int) -> list[tuple]:
    """[(label, call, error of the kernel against the plain version, calls
    to time)] at the shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if kernel == "fwt":
        xs = [torch.randn((4096, 1024), generator=g, device="cuda") for _ in range(FWT_TASKS)]
        ys = [FWT.fwt_plain(x) for x in xs]
        turn = itertools.count()
        want = FWT.fwt_columns_plain(ys[0])
        return [("rows", lambda: FWT.fwt_block(xs[next(turn) % FWT_TASKS]),
                 lambda: (FWT.fwt_block(xs[0]) - ys[0]).abs().max().item(), 64),
                ("columns", lambda: FWT.fwt_columns(ys[next(turn) % FWT_TASKS]),
                 lambda: (FWT.fwt_columns(ys[0]) - want).abs().max().item(), 64)]
    if kernel == "ssd":
        h, p, n = 80, 64, 128
        x = torch.randn((1, 64, h, p), generator=g, device="cuda").bfloat16()
        dt = torch.nn.functional.softplus(torch.randn((1, 64, h), generator=g, device="cuda"))
        a = -torch.exp(torch.linspace(-1.0, 1.0, h, device="cuda"))
        bm, cm = ((0.3 * torch.randn((1, 64, n), generator=g, device="cuda")).bfloat16()
                  for _ in range(2))
        st = torch.randn((1, h, p, n), generator=g, device="cuda")
        args = (x, dt, a, bm, cm)
        y_p, f_p = SSD.ssd_chunked_plain(*args, chunk=256, init_state=st)

        def run():
            return SSD.ssd_chunked(*args, chunk=256, init_state=st)

        def err():
            y, f = run()
            return max((y.float() - y_p.float()).abs().max().item()
                       / max(1.0, y_p.float().abs().max().item()),
                       (f - f_p).abs().max().item() / max(1.0, f_p.abs().max().item()))
        return [("", run, err, 100)]
    rng = np.random.default_rng(seed)
    s, t = rng.integers(0, 4, 2048), rng.integers(0, 4, 2048)
    scores = torch.from_numpy(np.where(s[:, None] == t[None, :], 1.0, -1.0)
                              .astype(np.float32)).cuda()
    plain = NW.nw_wavefront_plain(scores, block=32)
    state, sc, out = NW.initial_state(scores, 32)

    def run():
        NW.nw_run(state, sc, 0, 127)
        return out
    return [("", run, lambda: (run() - plain).abs().max().item(), 20)]


def time_variants(kernel: str, seed: int = 0) -> list[dict]:
    built = build_variants(kernel)
    cases = _cases(kernel, seed)
    kernels = _KERNELS[kernel]
    for k in kernels:
        k._bind()
    source = [(k._lib, k._fn) for k in kernels]
    names = list(built)
    rows = []
    try:
        for name in names + names[:1]:
            for k, (lib, fn) in zip(kernels, built[name]):
                k._lib, k._fn = lib, fn
            for label, call, err, iters in cases:
                e = err()
                ms = device_ms(call, iters)
                rows.append({"kernel": kernel, "variant": name, "call": label, "ms": ms,
                             "err": e})
                print(f"[variants] {kernel} {name}{' ' + label if label else ''}: {ms:.4f} ms, "
                      f"error against the plain version {e:.3e}", flush=True)
    finally:
        for k, (lib, fn) in zip(kernels, source):
            k._lib, k._fn = lib, fn
    return rows


# Times ops.fwt over a 2^22 f32 task in the tree whose src/ is argv[1], in
# a process of its own (two trees' packages share one name): cold over a
# rotation of FWT_TASKS tasks, warm on one task, queued behind a spin
# kernel.  Prints one JSON line.
OPS_FWT = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import ops
tasks, iters = int(sys.argv[2]), 64
g = torch.Generator(device="cuda").manual_seed(0)
xs = [torch.randn(1 << 22, generator=g, device="cuda") for _ in range(tasks)]
def queued(fn):
    fn(0)
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(400_000_000)
    a.record()
    for i in range(iters):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters
print(json.dumps({"cold_ms": queued(lambda i: ops.fwt(xs[i % tasks])),
                  "warm_ms": queued(lambda i: ops.fwt(xs[0]))}))
"""


def time_ops_fwt(tree: Path) -> dict:
    """``ops.fwt``'s cold and warm device ms in the tree at ``tree``."""
    out = subprocess.run([sys.executable, "-c", OPS_FWT, str(tree / "src"), str(FWT_TASKS)],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def compare_ops_fwt(parent: Path) -> list[dict]:
    here = Path(__file__).resolve().parents[3]
    rows = []
    for label, tree in (("parent", parent), ("this", here), ("this", here),
                        ("parent", parent)):
        r = {"tree": label, "path": str(tree), **time_ops_fwt(tree)}
        rows.append(r)
        print(f"[variants] ops.fwt 2^22 f32, {label} tree ({tree}): cold {r['cold_ms']:.4f} ms, "
              f"warm {r['warm_ms']:.4f} ms", flush=True)
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=sorted(VARIANTS), default=sorted(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="a tree of another commit whose ops.fwt to time beside this one's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 1
    rows = [r for kernel in args.kernel for r in time_variants(kernel, args.seed)]
    if args.parent is not None:
        rows += compare_ops_fwt(args.parent.resolve())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
