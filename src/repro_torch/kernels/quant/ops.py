"""Wrappers of the int8 wire codec's CUDA kernels over flat vectors.

The counterpart of ``repro/kernels/quant/ops.py``: ``quantize_int8``
(``quantize_chunks``) and ``dequantize_int8`` (``dequantize_chunks``).  A
vector of whole chunks is handed to the kernel as (n_chunks, chunk_elems);
the chunk is the codec's unit (one scale each), so unlike the agg_opt
wrappers these never re-block it.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel, and a library that cannot be built or loaded raises.  The
kernels take a chunk of a multiple of 4 elements, at most 16384 (64 KB of
f32, the 32 KB chunk of a bf16 group); a CUDA vector of other chunks
raises.  ``LAUNCHES`` counts the kernel launches of each entry point
(plain-version calls do not count).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import dequantize_int8_ref, quantize_int8_ref

MAX_CHUNK = 16384

LAUNCHES = {"quantize_chunks": 0, "dequantize_chunks": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("quant")
    if not getattr(lib, "_declared", False):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for name in ("quantize_chunks", "dequantize_chunks"):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = [vp] * 3 + [i64, i32, vp], i32
        lib._declared = True
    return lib


def _check(name: str, t: torch.Tensor, dtype, n: int, chunk_elems: int):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, want {dtype}")
    if t.dim() != 1 or t.numel() != n:
        raise ValueError(f"{name} must be a flat vector of {n}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if chunk_elems < 1 or n % chunk_elems:
        raise ValueError(f"the int8 wire encodes whole chunks: {name} has "
                         f"{n} elements, chunk_elems {chunk_elems}")


def _check_kernel(chunk_elems: int, *ts: torch.Tensor) -> None:
    if chunk_elems % 4 or chunk_elems > MAX_CHUNK:
        raise ValueError(f"the CUDA codec takes chunks of a multiple of 4 "
                         f"elements, at most {MAX_CHUNK}; got {chunk_elems}")
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("vector is not 16-byte aligned")


def _call(name: str, device, *args) -> None:
    lib = _lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def quantize_int8(x: torch.Tensor, *, chunk_elems: int):
    """(n,) f32 -> ((n,) int8 payload, (n/ce,) f32 per-chunk scales).
    Finite inputs: the kernel drops a NaN from a chunk's amax where the
    plain version propagates it."""
    _check("x", x, torch.float32, x.numel(), chunk_elems)
    if x.device.type == "cpu":
        return quantize_int8_ref(x, chunk_elems)
    nc = x.numel() // chunk_elems
    q = torch.empty(x.numel(), dtype=torch.int8, device=x.device)
    scales = torch.empty(nc, dtype=torch.float32, device=x.device)
    if nc:
        _check_kernel(chunk_elems, x, q)
        _call("quantize_chunks", x.device, x.data_ptr(), q.data_ptr(),
              scales.data_ptr(), nc, chunk_elems)
    return q, scales


def dequantize_int8(q: torch.Tensor, scales: torch.Tensor, *,
                    chunk_elems: int) -> torch.Tensor:
    """((n,) int8, (n/ce,) f32) -> (n,) f32."""
    _check("q", q, torch.int8, q.numel(), chunk_elems)
    nc = q.numel() // chunk_elems
    _check("scales", scales, torch.float32, nc, 1)
    if scales.device != q.device:
        raise ValueError(f"scales on {scales.device}, q on {q.device}")
    if q.device.type == "cpu":
        return dequantize_int8_ref(q, scales, chunk_elems)
    x = torch.empty(q.numel(), dtype=torch.float32, device=q.device)
    if nc:
        _check_kernel(chunk_elems, q, x)
        _call("dequantize_chunks", q.device, q.data_ptr(),
              scales.data_ptr(), x.data_ptr(), nc, chunk_elems)
    return x
