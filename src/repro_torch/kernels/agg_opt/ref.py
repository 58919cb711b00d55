"""Plain PyTorch versions of the fused agg+opt kernel.

They repeat the kernel's arithmetic operation for operation: f32 compute,
the worker sum taken in worker order and then divided by W, each product
and sum rounded on its own (no FMA), and the results cast back to the p
and m dtypes.  CPU tensors take these in ``ops.py``; on the card they are
what the CUDA kernel is held against, bitwise.
"""
from __future__ import annotations

import torch


def worker_mean(g: torch.Tensor) -> torch.Tensor:
    """(W, ...) -> f32 mean over dim 0: summed in worker order, then
    divided by W (not multiplied by 1/W: for W=3 those differ).  The
    divisor is a tensor on the same device: PyTorch's CUDA division by a
    Python number multiplies by its reciprocal."""
    acc = g[0].float()
    for w in range(1, g.shape[0]):
        acc = acc + g[w].float()
    return acc / acc.new_tensor(float(g.shape[0]))


def _nesterov(p, g32, m, lr, momentum):
    m2 = momentum * m.float() + g32
    p2 = p.float() - lr * (g32 + momentum * m2)
    return p2.to(p.dtype), m2.to(m.dtype)


def agg_opt_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                lr: float, momentum: float):
    """Nesterov update of p/m by the pre-aggregated gradient g (same
    shape).  Returns (p', m')."""
    return _nesterov(p, g.float(), m, lr, momentum)


def multi_agg_opt_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                      lr: float, momentum: float):
    """Tall aggregation: g is (W, *p.shape) worker gradients, averaged over
    dim 0, then the same update.  Returns (p', m')."""
    return _nesterov(p, worker_mean(g), m, lr, momentum)
