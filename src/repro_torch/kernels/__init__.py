"""Hand-written CUDA kernels of the port (``<name>/csrc/<name>.cu``), built
by ``_build`` on first use, each with its plain PyTorch version beside it."""
