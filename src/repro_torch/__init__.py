"""PHub in PyTorch: the port of the ``repro`` package to one NVIDIA H100.

The layout mirrors ``repro`` module for module.  The fused aggregation +
optimizer update runs in a hand-written CUDA kernel
(``kernels/agg_opt/csrc/agg_opt.cu``); the N workers of the sharded_ps
exchange are the leading axis of one tensor on one card
(``core/comm.py``).  Entry points default to ``device="cuda"``; a caller
that wants the CPU asks for it, and a tensor on the CPU takes each
kernel's plain PyTorch version.

Importing this package imports neither ``jax`` nor ``repro``.
"""
