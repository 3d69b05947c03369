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
    runs at once: the rows alone).

    PYTHONPATH=src python -m repro_torch.launch.variants [--kernel ssd nw]

One line per variant, in the order source, variants, source: device time
(calls queued behind a spin kernel, so that the events see the card, not
the host's issue rate) and the largest error against the plain version;
then the card's name and power limit.  Runs on a CUDA card only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import nw_tile as NW
from repro_torch.kernels import ssd_chunk as SSD

OUT = _build.BUILD_DIR / "variants"

SSD_COLS = "__host__ __device__ constexpr int cols_for(int n) { return n >= 256 ? 32 : 64; }"
NW_GROUP = "constexpr int kGroup = 4;"
NW_FETCH = ("        if (lk) word = link_word(r, j, g0 + c, kB);\n"
            "        else value = state_west(r, j, g0 + c, kB);\n")
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
}
_SOURCES = {"ssd": "ssd_chunk.cu", "nw": "nw_tile.cu"}
_KERNELS = {"ssd": SSD.KERNEL, "nw": NW.KERNEL}


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


def build_variants(kernel: str) -> dict[str, tuple]:
    """Each variant of ``kernel`` built into OUT (one nvcc a variant, all
    started together): name -> (library, entry point)."""
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
        fn = getattr(handle, _KERNELS[kernel].symbol)
        fn.argtypes, fn.restype = _KERNELS[kernel].argtypes, ctypes.c_int
        built[name] = (handle, fn)
    return built


def _cases(kernel: str, seed: int):
    """(call, plain output, error of an output against it) at the shape."""
    g = torch.Generator(device="cuda").manual_seed(seed)
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

        def err(out):
            y, f = out
            return max((y.float() - y_p.float()).abs().max().item()
                       / max(1.0, y_p.float().abs().max().item()),
                       (f - f_p).abs().max().item() / max(1.0, f_p.abs().max().item()))
        return lambda: SSD.ssd_chunked(*args, chunk=256, init_state=st), err, 100
    rng = np.random.default_rng(seed)
    s, t = rng.integers(0, 4, 2048), rng.integers(0, 4, 2048)
    scores = torch.from_numpy(np.where(s[:, None] == t[None, :], 1.0, -1.0)
                              .astype(np.float32)).cuda()
    plain = NW.nw_wavefront_plain(scores, block=32)
    state, sc, out = NW.initial_state(scores, 32)

    def run():
        NW.nw_run(state, sc, 0, 127)
        return out
    return run, lambda got: (got - plain).abs().max().item(), 20


def time_variants(kernel: str, seed: int = 0) -> list[dict]:
    built = build_variants(kernel)
    call, err, iters = _cases(kernel, seed)
    k = _KERNELS[kernel]
    k._bind()
    source = (k._lib, k._fn)
    names = list(built)
    rows = []
    try:
        for name in names + names[:1]:
            k._lib, k._fn = built[name]
            e = err(call())
            ms = device_ms(call, iters)
            rows.append({"kernel": kernel, "variant": name, "ms": ms, "err": e})
            print(f"[variants] {kernel} {name}: {ms:.4f} ms, error against the plain version "
                  f"{e:.3e}", flush=True)
    finally:
        k._lib, k._fn = source
    return rows


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", nargs="+", choices=sorted(VARIANTS), default=sorted(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("variants: needs a CUDA card", file=sys.stderr)
        return 1
    rows = [r for kernel in args.kernel for r in time_variants(kernel, args.seed)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"variants": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
