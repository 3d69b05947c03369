"""Architecture registry of the port.

qwen3-4b and mamba2-2.7b are served so far; the reference's other eight
architectures are listed in ROADMAP.md as still to port.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import LayerSpec, ModelConfig, smoke_reduce

#: arch-id -> module name
_MODULES: dict[str, str] = {
    "qwen3-4b": "qwen3_4b",
    "mamba2-2.7b": "mamba2_2_7b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


__all__ = ["LayerSpec", "ModelConfig", "smoke_reduce", "list_archs",
           "get_config", "get_smoke_config"]
