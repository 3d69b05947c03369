"""Build the CUDA sources in ``csrc/`` and bind them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into ``build/<name>-<digest>.so``
at the repository root, with a plain C interface (no PyTorch headers, so a
build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -o build/<name>-<digest>.so csrc/<name>.cu

The digest covers the source and the shared header, so an edited kernel is
rebuilt and a stale library is never loaded.  Nothing builds at import:
the first launch of a kernel builds its library, and :func:`build` builds
several at once, one ``nvcc`` per source, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("paged_attention.cu", "flash_attention.cu", "ssd_chunk.cu", "streamed_matmul.cu",
           "fwt.cu", "nw_tile.cu")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the port's CUDA kernels are "
            "built from source at first use")
    return found


def library_path(source: str) -> Path:
    """Where ``source`` builds to: keyed by the digest of its text and the
    shared header's."""
    h = hashlib.sha1()
    for p in (CSRC / source, CSRC / "common.cuh"):
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(sources: tuple[str, ...] = SOURCES, *, ptxas_info: bool = False
          ) -> dict[str, float]:
    """Build every library in ``sources`` that is not built yet, one nvcc
    process per source, all running together.  Returns seconds per source
    built (empty when all were already built).  ``ptxas_info`` adds
    ``-Xptxas -v`` and prints each kernel's register and shared-memory use.
    Raises ``RuntimeError`` with the compiler's output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_info else ()),
               "-o", str(tmp), str(CSRC / src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    secs: dict[str, float] = {}
    failed = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        secs[src] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{src} (nvcc exit {proc.returncode}):\n{log}")
            continue
        if ptxas_info and log:
            print(f"[build] {src}:\n{log}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return secs


class CudaKernel:
    """One kernel of a built library: its C entry point, bound with ctypes,
    and a plain count of the launches made through :meth:`launch`.

    The C function launches on the stream it is given and returns
    ``cudaGetLastError()``; a non-zero code raises here.
    """

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._lib = None
        self._fn = None

    def _bind(self):
        if self._fn is None:
            build((self.source,))
            self._lib = ctypes.CDLL(str(library_path(self.source)))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = self._lib.error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._bind()(*args)
        if rc != 0:
            msg = self._lib.error_string(rc).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} ({msg})")
        self.launches += 1


def stream_of(t: torch.Tensor) -> int:
    """The current CUDA stream of ``t``'s device, as the integer handle the
    C entry points take."""
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
