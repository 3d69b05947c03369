"""The one device rule of the port: CUDA unless the caller asks for the CPU.

The reference picks its kernel path by sniffing the JAX backend; the port
never guesses.  Every entry point takes ``device=`` and passes it here.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``cuda`` by default, ``cpu`` only when asked for.

    Raises ``RuntimeError`` when CUDA is requested (explicitly or by
    default) and ``torch.cuda.is_available()`` is False, so a run that
    meant to use the card never silently falls back to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
