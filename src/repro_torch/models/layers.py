"""Primitive layers: RMSNorm, RoPE, SwiGLU, initializers
(``repro/models/layers.py``).

JAX promotes a bf16 activation times an f32 weight to an f32 product;
PyTorch refuses mixed dtypes, so ``matmul`` casts both operands to their
promoted dtype first.  Float32 products run in full float32:
``full_f32_matmuls`` turns TF32 off for cuBLAS and cuDNN, as the reference
computes them.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def full_f32_matmuls() -> None:
    """Float32 products in full float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with JAX's type promotion."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """Normalizes in f32 and returns the input's dtype."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * scale).to(dt)


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    half = head_dim // 2
    return 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))


@functools.cache
def _device_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_freqs`` on ``device``, copied there once: a copy from pageable
    host memory waits for the card, at every layer otherwise."""
    with torch.inference_mode(False):       # usable by autograd later
        return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (T,) or broadcastable to (..., T)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _device_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs                  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]                          # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:2 * half]
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if 2 * half != hd:                                          # odd head_dim tail
        rot = torch.cat([rot, x[..., 2 * half:]], dim=-1)
    return rot.to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    h = F.silu(matmul(x, w1)) * matmul(x, w3)
    return matmul(h, w2)


def dense_init(shape: tuple[int, ...], dtype: torch.dtype, *,
               generator: torch.Generator | None, device,
               fan_in: int | None = None) -> torch.Tensor:
    """Normal(0, 1/fan_in) weights drawn in f32 from ``generator`` (scaled
    in place: one f32 copy at a time, 17.9 GB for arctic-480b's experts)."""
    fan_in = fan_in if fan_in is not None else shape[-2] if len(shape) >= 2 else shape[-1]
    std = fan_in ** -0.5
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(std).to(dtype)
