"""Wrappers of the fused agg+opt CUDA kernels over flat vectors.

The counterpart of ``repro/kernels/agg_opt/ops.py``, one wrapper per TPU
kernel: ``fused_agg_opt`` (``agg_opt_chunks``, Nesterov),
``fused_multi_agg_opt`` (``multi_agg_opt_chunks``, Nesterov over stacked
workers), ``fused_sgd_opt`` (``sgd_opt_chunks``), ``fused_adam_opt``
(``adam_opt_chunks``), ``fused_dequant_agg_opt``
(``dequant_agg_opt_chunks``, the int8 wire's tail) and
``fused_health_scan`` (``health_chunks``, the sanity gate's sum of
squares); SGD and Adam take ``g`` pre-aggregated ``(n,)`` or stacked
``(W, n)`` and fold the worker mean into the pass.  The stacked rules take an
optional ``divisor``, a one-element f32 tensor on the card that the mean
divides by instead of W (the live count of an elastic or gated step).  A
bf16 group may hand the rules an f32 ``g`` (the int8 wire's decoded mean).
The rules' kernels take the vectors as they are, in chunks of chunk_elems
rounded down to a multiple of 128 (at least 128: the rules are
elementwise, so the blocking does not change a bit), the last chunk
possibly ragged.  A stacked ``g`` may be a view whose rows lie further
apart than ``n`` (``g.stride(0)``, the row stride the kernels take): the
windowed exchange hands a window's strip of the (W, padded) buffer in
place.  Every row must start 16 bytes aligned; a contiguous ``g`` whose
rows do not (n not a multiple of 16 bytes) is the one input still padded
by a copy.  With ``p_out`` (the windowed exchange's form) the rules write
p' there and update their slots in place.  The dequant kernel takes whole
chunks of the wire's own size (each carries one scale), as runs: a
window's strip of every shard, p's runs and the owners' rows read in
place; the health kernel takes whole chunks (a zero-padded copy
otherwise).

The Nesterov, Adam and int8-tail wrappers take ``weight_decay`` (``g +
wd * p`` before the rule, ``ref.decayed``; 0, the default, leaves the term
out), rounded to f32 on the host as ``lr`` and ``momentum`` are.

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
                  health_chunks_ref, multi_agg_opt_ref, own_strips,
                  sgd_opt_ref)

_LANE = 128
# (state dtype, gradient dtype) -> the kernels' dtype code
_DTYPE_CODE = {(torch.float32, torch.float32): 0,
               (torch.bfloat16, torch.bfloat16): 1,
               (torch.bfloat16, torch.float32): 2}

LAUNCHES = {"agg_opt_chunks": 0, "multi_agg_opt_chunks": 0,
            "sgd_opt_chunks": 0, "adam_opt_chunks": 0,
            "dequant_agg_opt_chunks": 0, "health_chunks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("agg_opt")
    if not getattr(lib, "_declared", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        i64 = ctypes.c_longlong
        for name, args in (
                ("agg_opt_chunks",
                 [vp] * 5 + [i64, i32, i32, f32, f32, f32, vp]),
                ("multi_agg_opt_chunks",
                 [vp] * 5 + [i64, i32, i32, i64, i32, f32, f32, f32, vp,
                             vp]),
                ("sgd_opt_chunks",
                 [vp] * 3 + [i64, i32, i32, i64, i32, f32, vp, vp]),
                ("adam_opt_chunks",
                 [vp] * 7 + [i64, i32, i32, i64, i32] + [f32] * 7
                 + [vp, vp]),
                ("dequant_agg_opt_chunks",
                 [vp] * 7 + [i64, i32, i64, i64, i64, i32] + [f32] * 4
                 + [vp, vp]),
                ("health_chunks", [vp] * 2 + [i64, i32, i32, vp])):
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


def _check(p, g, state=(), f32_state=(), p_out=None) -> bool:
    """Check p (n,), g (n,) or (W, n) in p's dtype (or f32 in a bf16
    group; a stacked g's rows may lie any distance >= n apart), the
    group-dtype state vectors, the f32 state vectors and ``p_out``;
    return whether g is stacked."""
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p.device}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p: dtype {p.dtype} is not float32/bfloat16")
    _check_vec("p", p, p, p.dtype)
    if p.dim() != 1:
        raise ValueError(f"p must be a flat vector, got {tuple(p.shape)}")
    stacked = g.dim() == 2
    g_dtype = torch.float32 if g.dtype == torch.float32 else p.dtype
    if stacked:
        _check_vec("g", g[0], p, g_dtype)
        if g.shape[0] > 1 and g.stride(0) < g.shape[1]:
            raise ValueError(f"g's rows overlap: stride {g.stride()}")
    else:
        _check_vec("g", g, p, g_dtype)
    if (tuple(g.shape[1:] if stacked else g.shape) != tuple(p.shape)
            or g.shape[0] < 1):
        raise ValueError(f"g shape {tuple(g.shape)} is neither "
                         f"{tuple(p.shape)} nor (W, {p.numel()})")
    if p_out is not None:
        _check_vec("p_out", p_out, p, p.dtype)
        if p_out.shape != p.shape:
            raise ValueError(f"p_out {tuple(p_out.shape)} != p "
                             f"{tuple(p.shape)}")
    for i, t in enumerate(state):
        _check_vec(f"state[{i}]", t, p, p.dtype)
    for i, t in enumerate(f32_state):
        _check_vec(f"f32 state[{i}]", t, p, torch.float32)
    for t in (*state, *f32_state):
        if t.shape != p.shape:
            raise ValueError(f"state {tuple(t.shape)} != p {tuple(p.shape)}")
    ptrs = [t.data_ptr() for t in (p, *state, *f32_state)
            + ((p_out,) if p_out is not None else ())]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("p, p_out and the state vectors must not alias")
    return stacked


def _divisor_ptr(divisor, p: torch.Tensor, stacked: bool):
    """The kernels' divisor argument: None (divide by W) or the address of
    a one-element f32 tensor on p's device, for stacked g only."""
    if divisor is None:
        return None
    if not stacked:
        raise ValueError("a divisor divides the mean of stacked workers; "
                         "g is pre-aggregated")
    _check_vec("divisor", divisor, p, torch.float32)
    if divisor.numel() != 1:
        raise ValueError(f"divisor must hold one value, got "
                         f"{tuple(divisor.shape)}")
    return divisor.data_ptr()


def _chunked(v: torch.Tensor, ce: int) -> torch.Tensor:
    """(..., n) -> (..., n_chunks, ce), zero-padded to whole chunks (a
    copy when n is not whole chunks, else a view)."""
    n = v.shape[-1]
    pad = -(-n // ce) * ce - n
    if pad:
        v = F.pad(v, (0, pad))
    out = v.reshape(*v.shape[:-1], -1, ce)
    _check_aligned(out)
    return out


def _check_aligned(v: torch.Tensor) -> None:
    if v.data_ptr() % 16:
        raise ValueError("vector is not 16-byte aligned")


def _rows(g: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(g, row stride in elements) as the rules' kernels read it: a
    stacked g in place, its rows ``g.stride(0)`` apart, each 16 bytes
    aligned; a contiguous one whose rows are not is padded (a copy) to
    rows of a multiple of 16 bytes.  A pre-aggregated g: stride n."""
    _check_aligned(g)
    if g.dim() == 1:
        return g, g.numel()
    W, n = g.shape
    stride = g.stride(0) if W > 1 else n
    if (stride * g.element_size()) % 16:
        if not g.is_contiguous():
            raise ValueError(f"the rows of g (stride {stride}) do not "
                             f"start 16 bytes aligned")
        per = 16 // g.element_size()
        g = F.pad(g, (0, -(-n // per) * per - n))
        stride = g.shape[1]
    return g, stride


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


def _nesterov(name: str, p, g, m, lr: float, momentum: float,
              weight_decay: float, chunk_elems: int, divisor_ptr, p_out):
    """Launch a Nesterov kernel; with ``p_out`` m is updated in place."""
    for t in (p, m):
        _check_aligned(t)
    gk, stride = _rows(g)
    if p_out is None:
        p2, m2 = torch.empty_like(p), torch.empty_like(m)
    else:
        p2, m2 = p_out, m
    args = [p.data_ptr(), gk.data_ptr(), m.data_ptr(), p2.data_ptr(),
            m2.data_ptr(), p.numel(), _lane(chunk_elems)]
    if name == "multi_agg_opt_chunks":
        args += [g.shape[0], stride]
    args += [_DTYPE_CODE[p.dtype, g.dtype], lr, momentum, weight_decay]
    if name == "multi_agg_opt_chunks":
        args.append(divisor_ptr)
    _call(name, p.device, *args)
    return p2, m2


def _plain_nesterov(ref, p_out, m, *args, **kw):
    """A plain Nesterov version's (p', m'), written into p_out and m when
    ``p_out`` is given."""
    p2, m2 = ref(*args, **kw)
    if p_out is None:
        return p2, m2
    p_out.copy_(p2)
    m.copy_(m2)
    return p_out, m


def fused_agg_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                  lr: float, momentum: float, chunk_elems: int = 8192,
                  p_out: torch.Tensor | None = None,
                  weight_decay: float = 0.0):
    """Flat fused Nesterov update. p/g/m: (n,). Returns (p', m'); with
    ``p_out``, p' is written there and m updated in place."""
    if _check(p, g, (m,), p_out=p_out):
        raise ValueError("fused_agg_opt takes a pre-aggregated g; stacked "
                         "workers go to fused_multi_agg_opt")
    if p.device.type == "cpu":
        return _plain_nesterov(agg_opt_ref, p_out, m, p, g, m, lr=lr,
                               momentum=momentum, weight_decay=weight_decay)
    return _nesterov("agg_opt_chunks", p, g, m, lr, momentum, weight_decay,
                     chunk_elems, None, p_out)


def fused_multi_agg_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                        lr: float, momentum: float, chunk_elems: int = 8192,
                        divisor: torch.Tensor | None = None,
                        p_out: torch.Tensor | None = None,
                        weight_decay: float = 0.0):
    """Tall aggregation: g is (W, n) worker gradients, its rows
    ``g.stride(0)`` apart; the worker mean (over W, or ``divisor``) and the
    Nesterov update run in one pass per chunk.  Returns (p', m'); with
    ``p_out``, p' is written there and m updated in place."""
    if not _check(p, g, (m,), p_out=p_out):
        raise ValueError(f"g must be (W, n), got {tuple(g.shape)}")
    dptr = _divisor_ptr(divisor, p, True)
    if p.device.type == "cpu":
        return _plain_nesterov(multi_agg_opt_ref, p_out, m, p, g, m, lr=lr,
                               momentum=momentum, divisor=divisor,
                               weight_decay=weight_decay)
    return _nesterov("multi_agg_opt_chunks", p, g, m, lr, momentum,
                     weight_decay, chunk_elems, dptr, p_out)


def fused_sgd_opt(p: torch.Tensor, g: torch.Tensor, *, lr: float,
                  chunk_elems: int = 8192,
                  divisor: torch.Tensor | None = None,
                  p_out: torch.Tensor | None = None) -> torch.Tensor:
    """Flat fused SGD update; g is (n,) or stacked (W, n) (rows
    ``g.stride(0)`` apart), averaged over the workers (divided by W, or
    ``divisor``) in the same pass.  Returns p' (``p_out`` when given)."""
    stacked = _check(p, g, p_out=p_out)
    dptr = _divisor_ptr(divisor, p, stacked)
    if p.device.type == "cpu":
        p2 = sgd_opt_ref(p, g, lr=lr, divisor=divisor)
        return p2 if p_out is None else p_out.copy_(p2)
    _check_aligned(p)
    gk, stride = _rows(g)
    p2 = torch.empty_like(p) if p_out is None else p_out
    _call("sgd_opt_chunks", p.device, p.data_ptr(), gk.data_ptr(),
          p2.data_ptr(), p.numel(), _lane(chunk_elems),
          g.shape[0] if stacked else 1, stride,
          _DTYPE_CODE[p.dtype, g.dtype], lr, dptr)
    return p2


def fused_adam_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor, *,
                   lr: float, b1: float = 0.9, b2: float = 0.999,
                   eps: float = 1e-8, chunk_elems: int = 8192,
                   divisor: torch.Tensor | None = None,
                   p_out: torch.Tensor | None = None,
                   weight_decay: float = 0.0):
    """Flat fused Adam update with per-position bias-correction state
    k1/k2 (f32); g is (n,) or stacked (W, n) (rows ``g.stride(0)``
    apart), averaged over the workers (divided by W, or ``divisor``) in
    the same pass.  m, v, k1, k2 are updated in place.  Returns (p', m, v,
    k1, k2), p' in ``p_out`` when given."""
    stacked = _check(p, g, (m, v), (k1, k2), p_out=p_out)
    dptr = _divisor_ptr(divisor, p, stacked)
    slots = (m, v, k1, k2)
    if p.device.type == "cpu":
        new = adam_opt_ref(p, g, m, v, k1, k2, lr=lr, b1=b1, b2=b2, eps=eps,
                           divisor=divisor, weight_decay=weight_decay)
        for s, s2 in zip(slots, new[1:]):
            s.copy_(s2)
        return (new[0] if p_out is None else p_out.copy_(new[0]), *slots)
    for t in (p, *slots):
        _check_aligned(t)
    gk, stride = _rows(g)
    p2 = torch.empty_like(p) if p_out is None else p_out
    _call("adam_opt_chunks", p.device, p.data_ptr(), gk.data_ptr(),
          *(s.data_ptr() for s in slots), p2.data_ptr(), p.numel(),
          _lane(chunk_elems), g.shape[0] if stacked else 1, stride,
          _DTYPE_CODE[p.dtype, g.dtype], lr, b1, 1 - b1, b2, 1 - b2, eps,
          weight_decay, dptr)
    return (p2, *slots)


def _runs_of(t: torch.Tensor, name: str) -> torch.Tensor:
    """A (R, Lr) view of runs: unit inner stride, rows non-overlapping."""
    if t.dim() != 2 or t.stride(1) != 1 or (
            t.shape[0] > 1 and t.stride(0) < t.shape[1]):
        raise ValueError(f"{name} {tuple(t.shape)} (strides {t.stride()}) "
                         f"is not a view of non-overlapping unit-stride "
                         f"runs")
    return t


def _dequant_runs(p, g_own, m, p_out, ce):
    """(p, g_own, m, p_out) as (R, Lr) run views: a 2-D p as it is (its
    runs, a window's strip of every shard); a flat p with a flat g_own as
    one run; a flat p with the stacked (S, n) g_own as S shards, g_own's
    run j its block diagonal (shard j's run of row j, read in place)."""
    if p.dim() == 2:
        if tuple(g_own.shape) != tuple(p.shape):
            raise ValueError(f"g_own {tuple(g_own.shape)} is not p's runs "
                             f"{tuple(p.shape)}")
        return p, g_own, m, p_out
    if p.dim() != 1:
        raise ValueError(f"p must be (n,) or (R, Lr), got {tuple(p.shape)}")
    n = p.numel()
    if g_own.dim() == 1:
        S, own = 1, g_own.view(1, n)
    else:
        S = g_own.shape[0]
        L = n // S
        if tuple(g_own.shape) != (S, n) or S * L != n or L % ce:
            raise ValueError(f"the stacked g_own {tuple(g_own.shape)} does "
                             f"not split into {S} shards of whole chunks")
        own = own_strips(g_own)
    L = n // S
    return (p.view(S, L), own, m.view(S, L),
            None if p_out is None else p_out.view(S, L))


def fused_dequant_agg_opt(p: torch.Tensor, q: torch.Tensor,
                          scales: torch.Tensor, g_own: torch.Tensor,
                          m: torch.Tensor, *, lr: float, momentum: float,
                          inv_n: float, chunk_elems: int = 8192,
                          divisor: torch.Tensor | None = None,
                          p_out: torch.Tensor | None = None,
                          weight_decay: float = 0.0):
    """Fused int8-wire dequant + mean + Nesterov: ``g = (q * s + g_own) *
    inv_n`` per chunk of ``chunk_elems`` (the wire's chunk, one scale
    each), or ``/ divisor`` (a one-element f32 tensor on p's device, the
    sanity gate's live count), then the update.  p, m: (n,), or (R, Lr)
    runs whose rows lie ``p.stride(0)`` apart (a window's strip of every
    shard, read in place; Lr whole chunks); g_own: p's shape (its rows any
    distance apart: the block diagonal of a window), or for p (n,) the
    stacked (S, n) gradient buffer, read on its block diagonal (shard j's
    run of row j, n/S whole chunks); q: the R*Lr codes packed, int8;
    scales: one f32 a chunk.  Returns (p', m'), new and contiguous; with
    ``p_out`` (p's shape and strides) p' is written there and m updated
    in place."""
    ce = chunk_elems
    if ce < 1:
        raise ValueError(f"chunk_elems must be positive, got {ce}")
    if p.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"p: dtype {p.dtype} is not float32/bfloat16")
    pr, own, mr, por = _dequant_runs(p, g_own, m, p_out, ce)
    R, Lr = pr.shape
    for name, t in (("p", pr), ("g_own", own), ("m", mr)) + (
            (("p_out", por),) if por is not None else ()):
        _runs_of(t, name)
        if t.dtype != p.dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, want {p.dtype}")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
    for name, t in (("m", mr), ("p_out", por)):
        if t is not None and (t.shape != pr.shape
                              or t.stride() != pr.stride()):
            raise ValueError(f"{name} {tuple(t.shape)} (strides "
                             f"{t.stride()}) is not laid out as p "
                             f"{tuple(pr.shape)} ({pr.stride()})")
    if por is None and not pr.is_contiguous():
        raise ValueError("p's runs are not contiguous: pass p_out")
    if Lr % ce:
        raise ValueError(f"fused_dequant_agg_opt takes whole chunks: runs of "
                         f"{Lr}, chunk_elems={ce}")
    n = R * Lr
    _check_vec("q", q, p, torch.int8)
    _check_vec("scales", scales, p, torch.float32)
    if tuple(q.shape) != (n,) or tuple(scales.shape) != (n // ce,):
        raise ValueError(f"q {tuple(q.shape)} / scales "
                         f"{tuple(scales.shape)} do not match {n} elements "
                         f"in chunks of {ce}")
    ptrs = [t.data_ptr() for t in (pr, mr) + ((por,) if por is not None
                                              else ())]
    if len(set(ptrs)) != len(ptrs):
        raise ValueError("p, p_out and m must not alias")
    dptr = _divisor_ptr(divisor, p, True)
    if p.device.type == "cpu":
        p2, m2 = dequant_agg_opt_ref(pr, q, scales, own, mr, lr=lr,
                                     momentum=momentum, inv_n=inv_n,
                                     chunk_elems=ce, divisor=divisor,
                                     weight_decay=weight_decay)
        if por is None:
            return p2.view(p.shape), m2.view(m.shape)
        por.copy_(p2)
        mr.copy_(m2)
        return p_out, m
    if ce % 4:
        raise ValueError(f"the CUDA kernel takes chunks of a multiple of 4 "
                         f"elements, got {ce}")
    vec = 4 * p.element_size()
    for t in (pr, own, mr) + ((por,) if por is not None else ()):
        if t.data_ptr() % vec or (t.stride(0) * t.element_size()) % vec:
            raise ValueError("a run of p, g_own, m or p_out does not start "
                             "on a 4-element vector boundary")
    _check_aligned(q)
    if por is None:
        por, m_out = torch.empty_like(pr), torch.empty_like(mr)
    else:
        m_out = mr
    _call("dequant_agg_opt_chunks", p.device, pr.data_ptr(), q.data_ptr(),
          scales.data_ptr(), own.data_ptr(), mr.data_ptr(), por.data_ptr(),
          m_out.data_ptr(), n // ce, ce, Lr, pr.stride(0), own.stride(0),
          _DTYPE_CODE[p.dtype, p.dtype], lr, momentum, inv_n, weight_decay,
          dptr)
    if p_out is not None:
        return p_out, m
    return por.view(p.shape), m_out.view(m.shape)


def fused_health_scan(g: torch.Tensor, *, chunk_elems: int = 8192
                      ) -> torch.Tensor:
    """f32 sum of squares of ``g`` through the per-chunk health pass: a
    0-dim tensor for g (n,), and (W,) for stacked g (W, n), one launch
    over all W rows' chunks, then each row's partials summed (a
    ``torch.sum``, outside the kernel, as the reference's ``jnp.sum``).
    g is f32 or bf16; the zero pad to whole chunks adds exactly 0; NaN and
    Inf anywhere in a row propagate to its sum, so ``isfinite`` of the
    result is the whole push's finiteness and its root the flat norm."""
    if g.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {g.device}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"g: dtype {g.dtype} is not float32/bfloat16")
    if not g.is_contiguous():
        raise ValueError("g must be contiguous")
    if g.dim() not in (1, 2) or g.shape[-1] < 1:
        raise ValueError(f"g must be (n,) or (W, n), got {tuple(g.shape)}")
    ce = _lane(chunk_elems)
    partials = health_partials(_chunked(g, ce).reshape(-1, ce))
    if g.dim() == 1:
        return partials.sum()
    return partials.view(g.shape[0], -1).sum(1)


def health_partials(rows: torch.Tensor) -> torch.Tensor:
    """``health_chunks`` itself: rows (n_chunks, chunk_elems), f32 or bf16,
    chunk_elems a multiple of 4 -> (n_chunks,) f32 sums of squares, one
    launch (the plain version on the CPU)."""
    if rows.dim() != 2 or rows.shape[1] % 4 or not rows.is_contiguous():
        raise ValueError(f"rows must be contiguous (n_chunks, chunk_elems) "
                         f"with chunk_elems a multiple of 4, got "
                         f"{tuple(rows.shape)}")
    if rows.device.type == "cpu":
        return health_chunks_ref(rows)
    if rows.data_ptr() % 16:
        raise ValueError("rows are not 16-byte aligned")
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=rows.device)
    _call("health_chunks", rows.device, rows.data_ptr(), out.data_ptr(),
          rows.shape[0], rows.shape[1], _DTYPE_CODE[rows.dtype, rows.dtype])
    return out
