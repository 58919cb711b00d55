"""Wrappers of the fused agg+opt CUDA kernels over flat vectors.

The counterpart of ``repro/kernels/agg_opt/ops.py``, one wrapper per TPU
kernel: ``fused_agg_opt`` (``agg_opt_chunks``, Nesterov),
``fused_multi_agg_opt`` (``multi_agg_opt_chunks``, Nesterov over stacked
workers), ``fused_sgd_opt`` (``sgd_opt_chunks``), ``fused_adam_opt``
(``adam_opt_chunks``) and ``fused_dequant_agg_opt``
(``dequant_agg_opt_chunks``, the int8 wire's tail); SGD and Adam take
``g`` pre-aggregated ``(n,)`` or stacked ``(W, n)`` and fold the worker
mean into the pass.  A bf16 group may hand the rules an f32 ``g`` (the
int8 wire's decoded mean).  Vectors are padded to whole chunks
(chunk_elems rounded down to a multiple of 128, at least 128: the rules
are elementwise, so the blocking does not change a bit) and handed to the
kernel as (n_chunks, chunk_elems); the dequant kernel's chunk is the
wire's own, since each carries one scale.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel, and a library that cannot be built or loaded raises.
``LAUNCHES`` counts the kernel launches of each entry point (plain-version
calls do not count).  Adam's slots m, v, k1, k2 are updated in place on
both devices (as PyTorch's own optimizers do; at W = 4 on llama3.2-1b that
keeps four 4.9 GB vectors off the card) and returned; p' is a new tensor.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from .ref import (adam_opt_ref, agg_opt_ref, dequant_agg_opt_ref,
                  multi_agg_opt_ref, sgd_opt_ref)

_LANE = 128
# (state dtype, gradient dtype) -> the kernels' dtype code
_DTYPE_CODE = {(torch.float32, torch.float32): 0,
               (torch.bfloat16, torch.bfloat16): 1,
               (torch.bfloat16, torch.float32): 2}

LAUNCHES = {"agg_opt_chunks": 0, "multi_agg_opt_chunks": 0,
            "sgd_opt_chunks": 0, "adam_opt_chunks": 0,
            "dequant_agg_opt_chunks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("agg_opt")
    if not getattr(lib, "_declared", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        for name, args in (
                ("agg_opt_chunks", [vp] * 5 + [i64, i32, i32, f32, f32, vp]),
                ("multi_agg_opt_chunks",
                 [vp] * 5 + [i64, i32, i32, i32, f32, f32, vp]),
                ("sgd_opt_chunks", [vp] * 3 + [i64, i32, i32, i32, f32, vp]),
                ("adam_opt_chunks",
                 [vp] * 7 + [i64, i32, i32, i32] + [f32] * 6 + [vp]),
                ("dequant_agg_opt_chunks",
                 [vp] * 7 + [i64, i32, i64, i64, i32] + [f32] * 3 + [vp])):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i32
        lib._declared = True
    return lib


def _check_vec(name: str, t: torch.Tensor, p: torch.Tensor, dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != p.device:
        raise ValueError(f"{name} is on {t.device}, p on {p.device}")


def _check(p, g, state=(), f32_state=()) -> bool:
    """Check p (n,), g (n,) or (W, n) in p's dtype (or f32 in a bf16
    group), the group-dtype state vectors and the f32 state vectors;
    return whether g is stacked."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p.device}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p: dtype {p.dtype} is not float32/bfloat16")
    _check_vec("p", p, p, p.dtype)
    if p.dim() != 1:
        raise ValueError(f"p must be a flat vector, got {tuple(p.shape)}")
    _check_vec("g", g, p, torch.float32 if g.dtype == torch.float32
               else p.dtype)
    stacked = g.dim() == 2
    if (tuple(g.shape[1:] if stacked else g.shape) != tuple(p.shape)
            or g.shape[0] < 1):
        raise ValueError(f"g shape {tuple(g.shape)} is neither "
                         f"{tuple(p.shape)} nor (W, {p.numel()})")
    for i, t in enumerate(state):
        _check_vec(f"state[{i}]", t, p, p.dtype)
    for i, t in enumerate(f32_state):
        _check_vec(f"f32 state[{i}]", t, p, torch.float32)
    for t in (*state, *f32_state):
        if t.shape != p.shape:
            raise ValueError(f"state {tuple(t.shape)} != p {tuple(p.shape)}")
    ptrs = [t.data_ptr() for t in (p, *state, *f32_state)]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("p and the state vectors must not alias")
    return stacked


def _chunked(v: torch.Tensor, ce: int) -> torch.Tensor:
    """(..., n) -> (..., n_chunks, ce), zero-padded to whole chunks (a
    copy when n is not whole chunks, else a view)."""
    n = v.shape[-1]
    pad = -(-n // ce) * ce - n
    if pad:
        v = F.pad(v, (0, pad))
    out = v.reshape(*v.shape[:-1], -1, ce)
    if out.data_ptr() % 16:
        raise ValueError("vector is not 16-byte aligned")
    return out


def _lane(chunk_elems: int) -> int:
    return max(_LANE, (chunk_elems // _LANE) * _LANE)


def _call(name: str, device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _launch(name: str, pc, gc, mc, lr: float, momentum: float,
            n_workers: int):
    nc, ce = pc.shape
    p2, m2 = torch.empty_like(pc), torch.empty_like(mc)
    args = [pc.data_ptr(), gc.data_ptr(), mc.data_ptr(), p2.data_ptr(),
            m2.data_ptr(), nc, ce]
    if name == "multi_agg_opt_chunks":
        args.append(n_workers)
    _call(name, pc.device, *args, _DTYPE_CODE[pc.dtype, gc.dtype], lr,
          momentum)
    return p2, m2


def fused_agg_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                  lr: float, momentum: float, chunk_elems: int = 8192):
    """Flat fused Nesterov update. p/g/m: (n,). Returns (p', m')."""
    if _check(p, g, (m,)):
        raise ValueError("fused_agg_opt takes a pre-aggregated g; stacked "
                         "workers go to fused_multi_agg_opt")
    if p.device.type == "cpu":
        return agg_opt_ref(p, g, m, lr=lr, momentum=momentum)
    ce = _lane(chunk_elems)
    n = p.numel()
    p2, m2 = _launch("agg_opt_chunks", _chunked(p, ce), _chunked(g, ce),
                     _chunked(m, ce), lr, momentum, 1)
    return p2.view(-1)[:n], m2.view(-1)[:n]


def fused_multi_agg_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                        lr: float, momentum: float, chunk_elems: int = 8192):
    """Tall aggregation: g is (W, n) worker gradients; the worker mean and
    the Nesterov update run in one pass per chunk. Returns (p', m')."""
    if not _check(p, g, (m,)):
        raise ValueError(f"g must be (W, n), got {tuple(g.shape)}")
    if p.device.type == "cpu":
        return multi_agg_opt_ref(p, g, m, lr=lr, momentum=momentum)
    ce = _lane(chunk_elems)
    n = p.numel()
    p2, m2 = _launch("multi_agg_opt_chunks", _chunked(p, ce),
                     _chunked(g, ce), _chunked(m, ce), lr, momentum,
                     g.shape[0])
    return p2.view(-1)[:n], m2.view(-1)[:n]


def fused_sgd_opt(p: torch.Tensor, g: torch.Tensor, *, lr: float,
                  chunk_elems: int = 8192) -> torch.Tensor:
    """Flat fused SGD update; g is (n,) or stacked (W, n), averaged over
    the workers in the same pass. Returns p'."""
    stacked = _check(p, g)
    if p.device.type == "cpu":
        return sgd_opt_ref(p, g, lr=lr)
    ce = _lane(chunk_elems)
    n = p.numel()
    pc, gc = _chunked(p, ce), _chunked(g, ce)
    p2 = torch.empty_like(pc)
    _call("sgd_opt_chunks", p.device, pc.data_ptr(), gc.data_ptr(),
          p2.data_ptr(), pc.shape[0], ce, g.shape[0] if stacked else 1,
          _DTYPE_CODE[p.dtype, g.dtype], lr)
    return p2.view(-1)[:n]


def fused_adam_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, *,
                   lr: float, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, chunk_elems: int = 8192):
    """Flat fused Adam update with per-position bias-correction state
    k1/k2 (f32); g is (n,) or stacked (W, n), averaged over the workers in
    the same pass.  m, v, k1, k2 are updated in place.  Returns
    (p', m, v, k1, k2)."""
    stacked = _check(p, g, (m, v), (k1, k2))
    slots = (m, v, k1, k2)
    if p.device.type == "cpu":
        new = adam_opt_ref(p, g, m, v, k1, k2, lr=lr, b1=b1, b2=b2, eps=eps)
        for s, s2 in zip(slots, new[1:]):
            s.copy_(s2)
        return (new[0], *slots)
    ce = _lane(chunk_elems)
    n = p.numel()
    pc, gc = _chunked(p, ce), _chunked(g, ce)
    # whole chunks: views the kernel updates in place; else padded copies,
    # copied back below
    sc = [_chunked(s, ce) for s in slots]
    p2 = torch.empty_like(pc)
    _call("adam_opt_chunks", p.device, pc.data_ptr(), gc.data_ptr(),
          *(s.data_ptr() for s in sc), p2.data_ptr(), pc.shape[0], ce,
          g.shape[0] if stacked else 1, _DTYPE_CODE[p.dtype, g.dtype], lr,
          b1, 1 - b1,
          b2, 1 - b2, eps)
    if pc.numel() != n:
        for s, c in zip(slots, sc):
            s.copy_(c.view(-1)[:n])
    return (p2.view(-1)[:n], *slots)


def fused_dequant_agg_opt(p: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, g_own: torch.Tensor,
                          m: torch.Tensor, *, lr: float, momentum: float,
                          inv_n: float, chunk_elems: int = 8192):
    """Fused int8-wire dequant + mean + Nesterov: ``g = (q * s + g_own) *
    inv_n`` per chunk of ``chunk_elems`` (the wire's chunk, one scale
    each), then the update.  p, m: (n,); q: (n,) int8; scales: (n/ce,)
    f32; g_own: (n,) in p's dtype, or the stacked (S, n) gradient buffer,
    whose block diagonal (shard j's run of row j, n/S a multiple of
    chunk_elems) the kernel reads in place.  Returns (p', m')."""
    stacked = _check(p, g_own, (m,))
    if g_own.dtype != p.dtype:
        raise TypeError(f"g_own: dtype {g_own.dtype}, want {p.dtype}")
    n, ce = p.numel(), chunk_elems
    if ce < 1 or n % ce:
        raise ValueError(f"fused_dequant_agg_opt takes whole chunks: n={n}, "
                         f"chunk_elems={ce}")
    S = g_own.shape[0] if stacked else 1
    L = n // S
    if S * L != n or L % ce:
        raise ValueError(f"the stacked g_own {tuple(g_own.shape)} does not "
                         f"split into {S} shards of whole chunks")
    _check_vec("q", q, p, torch.int8)
    _check_vec("scales", scales, p, torch.float32)
    if q.shape != p.shape or tuple(scales.shape) != (n // ce,):
        raise ValueError(f"q {tuple(q.shape)} / scales "
                         f"{tuple(scales.shape)} do not match p ({n},) in "
                         f"chunks of {ce}")
    if p.device.type == "cpu":
        return dequant_agg_opt_ref(p, q, scales, g_own, m, lr=lr,
                                   momentum=momentum, inv_n=inv_n,
                                   chunk_elems=ce)
    if ce % 4:
        raise ValueError(f"the CUDA kernel takes chunks of a multiple of 4 "
                         f"elements, got {ce}")
    pc, qc, gc, mc = (_chunked(t, ce) for t in (p, q, g_own, m))
    p2, m2 = torch.empty_like(pc), torch.empty_like(mc)
    _call("dequant_agg_opt_chunks", p.device, pc.data_ptr(), qc.data_ptr(),
          scales.data_ptr(), gc.data_ptr(), mc.data_ptr(), p2.data_ptr(),
          m2.data_ptr(), n // ce, ce, L, n if stacked else 0,
          _DTYPE_CODE[p.dtype, p.dtype], lr, momentum, inv_n)
    return p2.view(-1), m2.view(-1)
