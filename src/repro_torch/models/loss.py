"""Chunked cross-entropy: bounds live logits to (B, chunk, V)
(``repro/models/loss.py``).

The LM head is applied chunk by chunk under ``torch.utils.checkpoint``,
so the backward recomputes each chunk's logits instead of keeping the full
(B, T, V) tensor — the reference's ``jax.checkpoint`` scan body.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .layers import matmul


def _chunk_nll(xb: torch.Tensor, lm_w: torch.Tensor, lb: torch.Tensor):
    logits = matmul(xb, lm_w).float()                   # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, lb.clamp(min=0)[..., None])[..., 0]
    mask = (lb >= 0).float()
    return ((lse - ll) * mask).sum(), mask.sum()


def chunked_cross_entropy(x: torch.Tensor, lm_w: torch.Tensor,
                          labels: torch.Tensor, *,
                          chunk: int = 1024) -> torch.Tensor:
    """x: (B, T, d) hidden states; lm_w: (d, V); labels: (B, T) int.

    Returns the mean token NLL (f32 scalar).  Positions with label < 0 are
    masked out."""
    B, T, d = x.shape
    chunk = min(chunk, T)
    n = -(-T // chunk)
    pad = n * chunk - T
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    nll = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        c_nll, c_cnt = checkpoint(_chunk_nll, x[:, sl], lm_w, labels[:, sl],
                                  use_reentrant=False)
        nll = nll + c_nll
        cnt = cnt + c_cnt
    return nll / torch.clamp(cnt, min=1.0)
