"""Architecture registry of the port.

All ten configs of the reference: the decoder-only attention stacks
(qwen3-4b, internlm2-20b, phi4-mini-3.8b, gemma2-27b, and the MoE configs
qwen2-moe-a2.7b and mixtral-8x7b), mamba2-2.7b, the jamba hybrid
(jamba-1.5-large-398b), the encoder-decoder whisper-medium and the
image-prefix paligemma-3b.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, LayerSpec, ModelConfig, ShapeSpec, smoke_reduce

#: arch-id -> module name
_MODULES: dict[str, str] = {
    "qwen3-4b": "qwen3_4b",
    "mamba2-2.7b": "mamba2_2_7b",
    "internlm2-20b": "internlm2_20b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "gemma2-27b": "gemma2_27b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "mixtral-8x7b": "mixtral_8x7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "whisper-medium": "whisper_medium",
    "paligemma-3b": "paligemma_3b",
}


def _module(arch: str):
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; the port has {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


#: The archs whose config module sets ``SUPPORTS_LONG_CONTEXT`` in the
#: reference (sub-quadratic mixers: they alone get the long_500k cell).
LONG_CONTEXT = frozenset({"mamba2-2.7b", "mixtral-8x7b", "jamba-1.5-large-398b"})


def list_archs() -> list[str]:
    return list(_MODULES)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE


def supports_long_context(arch: str) -> bool:
    _module(arch)  # raises on an unknown arch
    return arch in LONG_CONTEXT


def cells(include_skipped: bool = False) -> list[tuple[str, str]]:
    """All (arch, shape) dry-run cells (the reference's set); long_500k
    only for sub-quadratic archs."""
    out = []
    for arch in _MODULES:
        for shape in SHAPES:
            if shape == "long_500k" and not supports_long_context(arch):
                if include_skipped:
                    out.append((arch, shape + ":SKIP"))
                continue
            out.append((arch, shape))
    return out


__all__ = ["SHAPES", "ShapeSpec", "LayerSpec", "ModelConfig", "smoke_reduce", "list_archs",
           "get_config", "get_smoke_config", "supports_long_context", "cells"]
