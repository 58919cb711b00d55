"""Blockwise (flash-style) GQA attention in plain PyTorch
(``repro/models/attention.py``).

An online softmax over KV blocks, written as a Python loop.  Masks come
from global token positions (-1 marks an empty slot).  As in the
reference: masked scores are ``NEG_INF = -1e30`` (not -inf), q is scaled
before its f32 cast, and the normalizer is clamped at 1e-30.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        q_pos: torch.Tensor, k_pos: torch.Tensor,
                        window: int = 0, block_kv: int = 1024) -> torch.Tensor:
    """Causal (sliding-window) GQA attention.

    q: (B, Tq, nh, hd);  k, v: (B, Tk, kv, hd);  nh % kv == 0.
    q_pos: (B, Tq) or (Tq,) global positions of queries.
    k_pos: (B, Tk) or (Tk,) global positions of keys; -1 = empty slot.
    window: 0 = full causal; w > 0 attends to (p-w, p].
    """
    B, Tq, nh, hd = q.shape
    Tk, kv = k.shape[1], k.shape[2]
    G = nh // kv
    if q_pos.dim() == 1:
        q_pos = q_pos[None, :].expand(B, Tq)
    if k_pos.dim() == 1:
        k_pos = k_pos[None, :].expand(B, Tk)

    # pad KV to a block multiple with invalid slots
    nblk = max(1, -(-Tk // block_kv))
    pad = nblk * block_kv - Tk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)

    scale = hd ** -0.5
    qh = (q.reshape(B, Tq, kv, G, hd) * scale).float()

    # carry in fp32
    m = torch.full((B, Tq, kv, G), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Tq, kv, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Tq, kv, G, hd), dtype=torch.float32,
                      device=q.device)
    for i in range(nblk):
        blk = slice(i * block_kv, (i + 1) * block_kv)
        pc = k_pos[:, blk]
        s = torch.einsum("btkgh,bskh->btkgs", qh, k[:, blk].float())
        valid = (pc >= 0)[:, None, None, None, :]
        allowed = pc[:, None, :] <= q_pos[:, :, None]
        if window > 0:
            allowed = allowed & (pc[:, None, :] > q_pos[:, :, None] - window)
        mask = valid & allowed[:, :, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "btkgs,bskh->btkgh", p, v[:, blk].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Tq, nh, hd).to(q.dtype)
