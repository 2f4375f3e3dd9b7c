"""Hand-written CUDA kernels (``../csrc``) with their plain PyTorch
versions and launch counts (``_build.launches``)."""
