"""Plain version of the RWKV6 chunked-scan kernel
(``repro/kernels/rwkv_scan/kernel.py::rwkv_scan_kernel``), in the model
layout and from a given state.

Per (batch row, head) and chunk of ``ct`` tokens, in f32, with
``a = cumprod(w)`` inside the chunk and ``a_prev`` the same shifted by one
(starting from 1):

    rq = r * a_prev,  kd = k / a
    y  = strict_tril(rq kd^T) v + rq S + (sum_d r * (u * k)) v
    S <- a_last * S + (kd * a_last)^T v

The last chunk may be ragged (``T % ct != 0``, T = 1 included): its rows
past T do not exist, and ``a_last`` is its last row.  The strict lower
triangle is taken with where-semantics (entries on and above the diagonal
are dropped, never multiplied by 0), as the Pallas body does.

``a`` is multiplied up in row order (``torch.cumprod`` on the card is a
parallel scan that rounds otherwise), so the kernel and this version
compute the same ``a``, ``rq``, ``kd`` and ``kd * a_last`` bit for bit and
differ only in the order of their sums.  Under strong decay (a uniform
w <= 0.25) ``a`` underflows within a chunk, ``k / a`` becomes inf and the
output and state hold inf and NaN where the recurrence is finite: the
factorization's limit, which the reference's kernel and ``rwkv_chunked``
share.  Since the non-finite entries come from those elementwise values,
and a sum's class (finite, +-inf, NaN) does not depend on its order, the
kernel and this version put them in the same places.

The CPU tests hold this against the reference's kernel (interpret mode),
``rwkv_chunked`` and ``rwkv_recurrence``; on the card ``csrc/rwkv_scan.cu``
is held against it within a tolerance (``ops.py``).
"""
from __future__ import annotations

import torch


def rwkv_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                  ct: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, T, H, hd); u: (H, hd); state: (B, H, hd, hd) [k-dim x
    v-dim].  Returns (y (B, T, H, hd) in r's dtype, final state f32)."""
    T = r.shape[1]
    rf, kf, vf, wf = (x.float().transpose(1, 2) for x in (r, k, v, w))
    uf = u.float()[None, :, None, :]                    # (1, H, 1, hd)
    S = state.float()
    ys = []
    for c0 in range(0, T, ct):
        r_, k_, v_, w_ = (x[:, :, c0:c0 + ct] for x in (rf, kf, vf, wf))
        n = r_.shape[2]
        a = w_.clone()                                  # (B, H, n, hd)
        for i in range(1, n):       # in row order, as the kernel multiplies
            a[:, :, i] *= a[:, :, i - 1]
        a_prev = torch.cat([torch.ones_like(a[:, :, :1]), a[:, :, :-1]], 2)
        rq = r_ * a_prev
        kd = k_ / a
        att = rq @ kd.transpose(-1, -2)                 # (B, H, n, n)
        lower = torch.ones(n, n, dtype=torch.bool,
                           device=att.device).tril(-1)
        att = torch.where(lower, att, torch.zeros((), device=att.device))
        diag = (r_ * (uf * k_)).sum(-1, keepdim=True)   # (B, H, n, 1)
        ys.append(att @ v_ + rq @ S + diag * v_)
        a_last = a[:, :, -1]                            # (B, H, hd)
        S = a_last[..., None] * S + (kd * a_last[:, :, None]).transpose(
            -1, -2) @ v_
    y = torch.cat(ys, dim=2).transpose(1, 2)
    return y.to(r.dtype), S
