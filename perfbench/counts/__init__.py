"""Frozen flop and byte counts: the chip's peaks, the model families' flops
per token and the kernels' operations and bytes per call."""
