"""RWKV6 ("Finch") blocks (``repro/models/rwkv.py``): a linear-attention
time-mix with data-dependent per-channel decay, and a channel-mix.

The recurrence per head (state S in R^{hd x hd}, k-dim by v-dim):
    y_t = r_t @ (diag(u) . (k_t v_t^T) + S_t)
    S_{t+1} = diag(w_t) S_t + k_t v_t^T
with w_t = exp(-exp(w0 + tanh(x_t Wa) Wb)) in (0, 1).

Each function keeps the reference's name and arithmetic: the decay LoRA in
f32, ``w`` cast to r's dtype, ``rms_norm`` of y over the whole d_model
with ``ln_x`` times ``silu(g)``; ``relu(.)^2`` and ``sigmoid`` in the
channel-mix.  ``time_mix(use_kernel=True)`` (the prefill) runs the scan
through ``kernels/rwkv_scan`` from the given state; otherwise it takes the
reference's own choice, ``rwkv_chunked`` when T is a multiple of 64 and
above 1, else ``rwkv_recurrence`` (the one-token decode step: plain tensor
ops, as the reference decodes).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.rwkv_scan import ops as scan_ops
from .layers import matmul, rms_norm


def token_shift(x: torch.Tensor, mu: torch.Tensor,
                x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """lerp(x_t, x_{t-1}, mu).  x: (B, T, d); x_prev: (B, 1, d) carry for
    decode (with T = 1 the shift is ``x_prev`` itself)."""
    if x_prev is None:
        prev = F.pad(x, (0, 0, 1, 0))[:, :-1]
    elif x.shape[1] > 1:
        dt = torch.promote_types(x_prev.dtype, x.dtype)
        prev = torch.cat([x_prev.to(dt), x.to(dt)], dim=1)[:, :-1]
    else:
        prev = x_prev
    return x + mu * (prev - x)


def rwkv_recurrence(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential scan.  r/k/v/w: (B, T, H, hd); u: (H, hd); state: (B, H,
    hd, hd).  Returns (y (B, T, H, hd), new state), both in r's dtype."""
    rt, kt, vt, wt = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    S = state.float()
    ys = []
    for t in range(r.shape[1]):
        r_, k_, v_, w_ = rt[:, t], kt[:, t], vt[:, t], wt[:, t]  # B, H, hd
        kv = k_[..., :, None] * v_[..., None, :]            # (B, H, hd, hd)
        ys.append(torch.einsum("bhk,bhkv->bhv", r_, uf * kv + S))
        S = w_[..., :, None] * S + kv
    return torch.stack(ys, dim=1).to(r.dtype), S.to(r.dtype)


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` over dim 1, whose backward is the branch PyTorch's
    own takes when no input is zero (the reverse cumulative sum of ``out *
    grad``, divided by the input; the same bits) without its test for
    zeros, a host sync each call: 512 a W=2 step of rwkv6-3b, which kept
    the host from running ahead of the card.  A zero decay makes the
    chunked form's ``k / a`` infinite in the forward already, so the
    other branch never gives a finite result there."""

    @staticmethod
    def forward(ctx, w):
        a = torch.cumprod(w, dim=1)
        ctx.save_for_backward(w, a)
        return a

    @staticmethod
    def backward(ctx, grad):
        w, a = ctx.saved_tensors
        return torch.flip(torch.cumsum(torch.flip(a * grad, [1]), 1), [1]) / w


def rwkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                 ct: int = 64) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked linear-attention form of the recurrence, as the
    reference writes it (T % ct == 0; the strict lower triangle by a
    multiplied mask); the training forward, under autograd (its cumulative
    decay through ``_Cumprod``).  Same shapes and dtypes as
    ``rwkv_recurrence``."""
    B, T, H, hd = r.shape
    nc = T // ct

    def chunks(x):
        return x.float().reshape(B, nc, ct, H, hd).transpose(0, 1)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w)
    uf = u.float()
    ii = torch.arange(ct, device=r.device)
    strict_lower = (ii[:, None] > ii[None, :]).float()
    S = state.float()
    ys = []
    for c in range(nc):
        r_, k_, v_, w_ = rc[c], kc[c], vc[c], wc[c]         # (B, ct, H, hd)
        a = _Cumprod.apply(w_)
        a_prev = torch.cat([torch.ones_like(a[:, :1]), a[:, :-1]], dim=1)
        rq = r_ * a_prev
        kd = k_ / a
        att = torch.einsum("bihd,bjhd->bhij", rq, kd) * strict_lower
        diag = torch.sum(r_ * (uf * k_), dim=-1)            # (B, ct, H)
        ys.append(torch.einsum("bhij,bjhd->bihd", att, v_)
                  + torch.einsum("bihk,bhkv->bihv", rq, S)
                  + diag[..., None] * v_)
        a_last = a[:, -1]                                   # (B, H, hd)
        S = (a_last[..., None] * S
             + torch.einsum("bjhk,bjhv->bhkv", kd * a_last[:, None], v_))
    y = torch.stack(ys, dim=1).reshape(B, T, H, hd)
    return y.to(r.dtype), S.to(r.dtype)


def time_mix(p: dict, x: torch.Tensor, cfg, state: torch.Tensor,
             x_prev: torch.Tensor | None = None, use_kernel: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """RWKV6's attention replacement.  x: (B, T, d).  Returns (out (B, T,
    d), the new state)."""
    B, T, d = x.shape
    H, hd = cfg.n_heads, cfg.hd
    xr = token_shift(x, p["mu_r"], x_prev)
    xk = token_shift(x, p["mu_k"], x_prev)
    xv = token_shift(x, p["mu_v"], x_prev)
    xg = token_shift(x, p["mu_g"], x_prev)
    xw = token_shift(x, p["mu_w"], x_prev)

    r = matmul(xr, p["w_r"]).reshape(B, T, H, hd)
    k = matmul(xk, p["w_k"]).reshape(B, T, H, hd)
    v = matmul(xv, p["w_v"]).reshape(B, T, H, hd)
    g = F.silu(matmul(xg, p["w_g"]))
    # data-dependent decay (Finch): w = exp(-exp(w0 + tanh(x Wa) Wb))
    dd = torch.tanh(xw.float() @ p["wa"].float())
    dd = dd @ p["wb"].float()
    logw = p["w0"].float() + dd                               # (B, T, d)
    w = torch.exp(-torch.exp(logw)).reshape(B, T, H, hd).to(r.dtype)

    if use_kernel:
        y, state = scan_ops.rwkv_scan(r, k, v, w, p["u"], state)
    elif T % 64 == 0 and T > 1:
        y, state = rwkv_chunked(r, k, v, w, p["u"], state)
    else:
        y, state = rwkv_recurrence(r, k, v, w, p["u"], state)
    y = rms_norm(y.reshape(B, T, d), p["ln_x"], cfg.norm_eps) * g
    return matmul(y, p["w_o"]), state


def channel_mix(p: dict, x: torch.Tensor,
                x_prev: torch.Tensor | None = None) -> torch.Tensor:
    xk = token_shift(x, p["mu_ck"], x_prev)
    xr = token_shift(x, p["mu_cr"], x_prev)
    k = torch.square(F.relu(matmul(xk, p["ck"])))
    return torch.sigmoid(matmul(xr, p["cr"])) * matmul(k, p["cv"])
