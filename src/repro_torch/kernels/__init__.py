"""Hand-written CUDA kernels of the port (sources in ``csrc/``), their
ctypes wrappers, and the plain PyTorch versions they are held against."""
