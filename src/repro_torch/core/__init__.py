"""The paper's streaming machinery, ported: the dependency taxonomy, the R
metric and pipeline model, halo partitioning, wavefront scheduling and the
stream engine over CUDA streams."""
