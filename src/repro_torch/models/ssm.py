"""Head-structured selective SSM (Mamba-2 style) for the Hymba hybrid block
(``repro/models/ssm.py``).

Per head h with state S in R^{N x hd} (N = ssm_state):
    dt_t  = softplus(x_t Wdt + b)          (per head)
    S_t   = exp(dt_t * A_h) S_{t-1} + dt_t * B_t (x_t^h)^T
    y_t^h = C_t @ S_t
B_t and C_t in R^N are shared across heads; A_h < 0 is a scalar a head.

``ssm_scan`` is the reference's sequential recurrence in f32, products
taken in its order (``exp(dt * A) * S + (dt * B) * x``).  What does not
depend on S (the decays and the updates) is computed for a block of steps
at once, and the outputs ``C_t @ S_t`` for the block's stacked states
after its loop, so the loop itself is one ``addcmul`` a step; a block's
length bounds the stacked states to ``_BLOCK_ELEMS`` floats.  The JAX
package has no kernel for the scan (its ``lax.scan`` is the oracle for
one), so this is plain PyTorch, under autograd in training.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import matmul

_BLOCK_ELEMS = 1 << 26          # f32 elements of one block's stacked states


def ssm_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """xh: (B, T, H, hd); dt: (B, T, H); A: (H,); Bm/Cm: (B, T, N); state:
    (B, H, N, hd).  Returns (y (B, T, H, hd), the last state (B, H, N,
    hd)), both in xh's dtype; the recurrence runs in f32."""
    Bsz, T, H, hd = xh.shape
    N = Bm.shape[-1]
    blk = max(1, _BLOCK_ELEMS // (Bsz * H * N * hd))
    S = state.float()
    Af = A.float()
    ys = []
    for t0 in range(0, T, blk):
        sl = slice(t0, min(T, t0 + blk))
        d_ = dt[:, sl].float()                                  # (B,b,H)
        decay = torch.exp(d_ * Af)[..., None, None]             # (B,b,H,1,1)
        upd = ((d_[..., None, None] * Bm[:, sl, None, :, None].float())
               * xh[:, sl, :, None, :].float())                 # (B,b,H,N,hd)
        states = []
        for dec, up in zip(decay.unbind(1), upd.unbind(1)):
            S = torch.addcmul(up, dec, S)
            states.append(S)
        ys.append(torch.einsum("btn,bthnd->bthd", Cm[:, sl].float(),
                               torch.stack(states, dim=1)))
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.to(xh.dtype), S.to(xh.dtype)


def ssm_branch(p: dict, x: torch.Tensor, cfg, state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, T, d) -> (y (B, T, d), the new state (B, H, N, hd))."""
    B, T, _ = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xs = matmul(x, p["w_in"]).reshape(B, T, H, hd)
    z = F.silu(matmul(x, p["w_gate"]))                      # (B, T, H*hd)
    dt = F.softplus(matmul(x, p["w_dt"]) + p["dt_bias"])    # (B, T, H)
    A = -torch.exp(p["a_log"])                              # (H,) negative
    Bm = matmul(x, p["w_B"])                                # (B, T, N)
    Cm = matmul(x, p["w_C"])
    y, state = ssm_scan(xs, dt, A, Bm, Cm, state)
    y = y.reshape(B, T, H * hd) * z
    return matmul(y, p["w_out"]), state
