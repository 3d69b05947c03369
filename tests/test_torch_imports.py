"""Package rules of the port: no module of ``repro_torch`` (nor
``chip_smoke.py``) imports JAX or the JAX package, and every entry point
resolves to CUDA by default, raising without a card unless the caller
passes ``device="cpu"``."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import bridge, configs, resolve_device
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.runtime import kv_cache, serving

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_port_files_are_found():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "serving.py", "paged_attention.py", "device.py", "mamba.py",
            "ssd_chunk.py", "mamba2_2_7b.py", "streams.py", "wavefront.py", "rmetric.py",
            "streamed_matmul.py", "fwt.py", "nw_tile.py"} <= names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.name} imports {bad}"


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in FILES if p.name != "chip_smoke.py"]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device() == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


def test_entry_points_raise_without_cuda(no_cuda):
    cfg = configs.get_smoke_config("qwen3-4b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, 0)
    params = T.init_params(cfg, 0, device="cpu")
    numpy_tree = _to_numpy(params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.params_from_numpy(numpy_tree, cfg)
    assert bridge.params_from_numpy(numpy_tree, cfg, device="cpu")["embed"].device.type == "cpu"
    scfg = serving.ServeConfig(max_seq=32, prefill_chunk=8, max_new_tokens=2,
                               max_batch=2, block_size=8, paged=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serving.StreamedBatchEngine(cfg, params, scfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kv_cache.PagedKVCache(cfg, max_batch=2, max_seq=32, block_size=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--paged"])
    eng = serving.StreamedBatchEngine(cfg, params, scfg, device="cpu")
    eng.submit(np.arange(5, dtype=np.int32))
    assert len(eng.run()[0]) == 2


def test_mamba_entry_points_raise_without_cuda(no_cuda):
    cfg = configs.get_smoke_config("mamba2-2.7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 2, 32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_paged_cache(cfg, 2, 5, 8)
    params = T.init_params(cfg, 0, device="cpu")
    for paged in (False, True):
        scfg = serving.ServeConfig(max_seq=32, prefill_chunk=8, max_new_tokens=2,
                                   max_batch=2, block_size=8, paged=paged,
                                   state_snapshots=True)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.StreamedBatchEngine(cfg, params, scfg)
        eng = serving.StreamedBatchEngine(cfg, params, scfg, device="cpu")
        eng.submit(np.arange(12, dtype=np.int32))
        assert len(eng.run()[0]) == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "mamba2-2.7b"])


def _to_numpy(t):
    return {k: _to_numpy(v) if isinstance(v, dict) else v.numpy() for k, v in t.items()}
