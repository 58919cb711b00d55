"""Plain PyTorch versions of the blockwise int8 wire codec.

They repeat the kernels' arithmetic (``csrc/quant.cu``) operation for
operation, and equal the reference's eager jnp oracle
(``repro/kernels/quant/ref.py``) bitwise: per chunk ``scale = amax / 127``
(1.0 for an all-zero chunk), ``q = clip(round(x / scale), ±127)`` with
round half to even, and ``x' = q * scale``.  Both divisions are tensor by
tensor: PyTorch's CUDA division by a Python number multiplies by its
reciprocal.  CPU tensors take these in ``ops.py``; on the card they are
what the CUDA kernels are held against.
"""
from __future__ import annotations

import torch

QMAX = 127.0


def quantize_int8_ref(x: torch.Tensor, chunk_elems: int):
    """(n,) float -> ((n,) int8 payload, (n/ce,) f32 per-chunk scales)."""
    xc = x.float().reshape(-1, chunk_elems)
    amax = xc.abs().amax(dim=1)
    scales = torch.where(amax > 0, amax / amax.new_tensor(QMAX),
                         torch.ones_like(amax))
    q = torch.clamp(torch.round(xc / scales[:, None]), -QMAX, QMAX)
    return q.to(torch.int8).reshape(-1), scales


def dequantize_int8_ref(q: torch.Tensor, scales: torch.Tensor,
                        chunk_elems: int) -> torch.Tensor:
    """((n,) int8, (n/ce,) f32) -> (n,) f32."""
    qc = q.float().reshape(-1, chunk_elems)
    return (qc * scales.float()[:, None]).reshape(-1)
