"""Plain version of the decode attention kernel: the model's blockwise
attention at T=1 against a position-tagged cache
(``repro/kernels/decode_attn/ref.py``).

The CPU tests hold it against the reference's kernel in interpret mode;
on the card it is what ``csrc/decode_attn.cu`` is held against, within a
stated tolerance (``ops.py``).
"""
from __future__ import annotations

import torch

from ...models.attention import blockwise_attention


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor, q_pos: torch.Tensor, *,
                         window: int) -> torch.Tensor:
    """Kernel layout: q (B, kv, G, hd); k/v (B, S, kv, hd); pos (B, S);
    q_pos (B, 1).  Returns (B, kv, G, hd)."""
    B, kv, G, hd = q.shape
    out = blockwise_attention(q.reshape(B, 1, kv * G, hd), k, v, q_pos=q_pos,
                              k_pos=pos, window=window)
    return out.reshape(B, kv, G, hd)
