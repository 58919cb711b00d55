"""Plain version of the flash sliding-window attention kernel: the model's
blockwise attention (``repro/kernels/swa_attn/ref.py``).

The CPU tests hold it against the reference's kernel in interpret mode;
on the card it is what ``csrc/swa_attn.cu`` is held against, within a
stated tolerance (the kernel sums in another order, ``ops.py``).
"""
from __future__ import annotations

import torch

from ...models.attention import blockwise_attention


def swa_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int) -> torch.Tensor:
    """q: (B, nh, T, hd); k/v: (B, kv, T, hd) — the kernel layout."""
    T = q.shape[2]
    pos = torch.arange(T, dtype=torch.int32, device=q.device)
    out = blockwise_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), q_pos=pos, k_pos=pos,
                              window=window)
    return out.transpose(1, 2)
