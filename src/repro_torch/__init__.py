"""PyTorch + CUDA port of the streaming serving system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its own
copies of what it needs and imports nothing of it.  The slice ported so far
is paged qwen3-4b serving: ``runtime.serving.StreamedBatchEngine`` over a
paged KV pool, with hand-written CUDA kernels for paged decode attention and
prefill attention (``kernels/csrc``).  Entry points run on the card unless
the caller passes ``device="cpu"`` (see :func:`device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
