"""PyTorch + CUDA port of the streaming serving system for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its own
copies of what it needs and imports nothing of it.  Ported so far:
qwen3-4b serving through ``runtime.serving.StreamedBatchEngine`` over a
paged KV pool, with speculative decode and int8/fp8 pages; mamba2-2.7b
serving with state snapshots; and the paper's streaming machinery
(``core/``: dependency taxonomy, R metric, halo, wavefront, and
``HostStreamExecutor`` over CUDA streams, driven by ``launch/streams``);
the reference's observability layer (``obs/``: spans, metrics, SLO,
request timelines, overlap, the doctor) wired into the engine, with its
R-gated serving policy (``measure_stage_times``, ``autotune``); and
single-device training (``runtime.trainer.Trainer``, ``launch.train``:
AdamW, the prefetching data pipeline, async checkpoints, supervised
steps), whose gradients go through the prefill and SSD kernels.
Every TPU kernel of the reference has a hand-written CUDA counterpart in
``kernels/csrc``: paged decode attention (four entries), prefill attention,
the SSD chunk scan, the streamed matmul, the Walsh-Hadamard transform and
the Needleman-Wunsch tile.  Entry points run on the card unless the caller
passes ``device="cpu"`` (see :func:`device.resolve_device`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
