"""Wrappers of the fused agg+opt CUDA kernel over flat vectors.

The counterpart of ``repro/kernels/agg_opt/ops.py``: vectors are padded to
whole chunks (chunk_elems rounded down to a multiple of 128, at least 128)
and handed to the kernel as (n_chunks, chunk_elems).  A CPU tensor takes the
plain version in ``ref.py``; a CUDA tensor launches the kernel, and a
library that cannot be built or loaded raises.  ``LAUNCHES`` counts the
kernel launches of each entry point (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import _build
from .ref import agg_opt_ref, multi_agg_opt_ref

_LANE = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"agg_opt_chunks": 0, "multi_agg_opt_chunks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("agg_opt")
    if not getattr(lib, "_declared", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.agg_opt_chunks.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong,
                                       i32, i32, f32, f32, vp]
        lib.agg_opt_chunks.restype = i32
        lib.multi_agg_opt_chunks.argtypes = [vp, vp, vp, vp, vp,
                                             ctypes.c_longlong, i32, i32, i32,
                                             f32, f32, vp]
        lib.multi_agg_opt_chunks.restype = i32
        lib._declared = True
    return lib


def _check(p, g, m, stacked: bool) -> None:
    if p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {p.device}")
    for name, t in (("p", p), ("g", g), ("m", m)):
        if t.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: dtype {t.dtype} is not float32/bfloat16")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != p.device:
            raise ValueError(f"{name} is on {t.device}, p on {p.device}")
    if g.dtype != p.dtype or m.dtype != p.dtype:
        raise TypeError(f"p/g/m dtypes differ: {p.dtype}/{g.dtype}/{m.dtype}")
    if p.dim() != 1 or m.shape != p.shape:
        raise ValueError(f"p and m must be equal flat vectors: "
                         f"{tuple(p.shape)} vs {tuple(m.shape)}")
    if stacked and (g.dim() != 2 or g.shape[0] < 1):
        raise ValueError(f"g must be (W, n), got {tuple(g.shape)}")
    want = (g.shape[0], *p.shape) if stacked else tuple(p.shape)
    if tuple(g.shape) != want:
        raise ValueError(f"g shape {tuple(g.shape)} != {want}")


def _chunked(v: torch.Tensor, ce: int) -> torch.Tensor:
    """(..., n) -> (..., n_chunks, ce), zero-padded to whole chunks."""
    n = v.shape[-1]
    pad = -(-n // ce) * ce - n
    if pad:
        v = F.pad(v, (0, pad))
    out = v.reshape(*v.shape[:-1], -1, ce)
    if out.data_ptr() % 16:
        raise ValueError("vector is not 16-byte aligned")
    return out


def _launch(name: str, pc, gc, mc, lr: float, momentum: float,
            n_workers: int):
    nc, ce = pc.shape
    p2, m2 = torch.empty_like(pc), torch.empty_like(mc)
    lib = _lib()
    args = [pc.data_ptr(), gc.data_ptr(), mc.data_ptr(), p2.data_ptr(),
            m2.data_ptr(), nc, ce]
    if name == "multi_agg_opt_chunks":
        args.append(n_workers)
    with torch.cuda.device(pc.device):
        stream = torch.cuda.current_stream(pc.device).cuda_stream
        err = getattr(lib, name)(*args, _DTYPE_CODE[pc.dtype], lr, momentum,
                                 stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1
    return p2, m2


def fused_agg_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                  lr: float, momentum: float, chunk_elems: int = 8192):
    """Flat fused Nesterov update. p/g/m: (n,). Returns (p', m')."""
    _check(p, g, m, stacked=False)
    if p.device.type == "cpu":
        return agg_opt_ref(p, g, m, lr=lr, momentum=momentum)
    ce = max(_LANE, (chunk_elems // _LANE) * _LANE)
    n = p.numel()
    p2, m2 = _launch("agg_opt_chunks", _chunked(p, ce), _chunked(g, ce),
                     _chunked(m, ce), lr, momentum, 1)
    return p2.view(-1)[:n], m2.view(-1)[:n]


def fused_multi_agg_opt(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, *,
                        lr: float, momentum: float, chunk_elems: int = 8192):
    """Tall aggregation: g is (W, n) worker gradients; the worker mean and
    the Nesterov update run in one pass per chunk. Returns (p', m')."""
    _check(p, g, m, stacked=True)
    if p.device.type == "cpu":
        return multi_agg_opt_ref(p, g, m, lr=lr, momentum=momentum)
    ce = max(_LANE, (chunk_elems // _LANE) * _LANE)
    n = p.numel()
    p2, m2 = _launch("multi_agg_opt_chunks", _chunked(p, ce),
                     _chunked(g, ce), _chunked(m, ce), lr, momentum,
                     g.shape[0])
    return p2.view(-1)[:n], m2.view(-1)[:n]
