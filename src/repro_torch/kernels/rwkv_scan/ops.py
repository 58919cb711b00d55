"""Wrapper of the RWKV6 chunked-scan kernel (``repro/kernels/rwkv_scan/
ops.py``): the prefill's time-mix recurrence.

``rwkv_scan(r, k, v, w, u, state)`` takes the model layout, r/k/v/w
``(B, T, H, hd)``, u ``(H, hd)`` and state ``(B, H, hd, hd)`` f32, and
returns ``(y (B, T, H, hd) in r's dtype, the final state f32)``, from the
given state and for any T >= 1 (a ragged last chunk included; the
reference's wrapper drops the state when ``T % 64 == 0`` and falls back to
a sequential scan otherwise).  The kernel reads that layout in place.  A
CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel, and a library that cannot be built or loaded raises.  The
kernel takes r, k, v, w of one dtype, f32 or bf16, hd 64, and u of any
float dtype (converted to f32 first, exactly for f32 and bf16).  It loads
r, k, v and w with TMA tensor copies and the state and y 16 bytes (y in
bf16: 8) at a time, so r, k, v, w, y and the state must be 16-byte
aligned: a view that is not (a storage offset that is not a multiple of 16
bytes) raises ``ValueError``; the wrapper does not copy it.  The model's
inputs are fresh matmul outputs reshaped, so they are aligned.

There is no backward kernel (the reference has none either, and
``jax.grad`` through its ``pallas_call`` fails: ROADMAP.md queue C), so a
call that autograd would record (grad enabled and an input that requires
grad) raises; training takes autograd of ``models/rwkv.py::rwkv_chunked``,
as the reference trains rwkv6-3b.

The kernel sums in another order than the plain version (fmaf chains, not
matrix products), so it is held to a tolerance: f32 within 1e-5 *
max(1, max|want|) (measured on an H100: at most 4.1e-7 of max|want| at the
serving shape and on the edge cases), bf16 outputs within 1e-2 *
max(1, max|want|) (one bf16 rounding of y either side of a boundary;
measured 1.6e-3).  Under strong decay (a uniform w <= 0.25, or 0.1 on
some channels) the chunked form's cumulative decay underflows: both return
inf and NaN in the same places, where the recurrence is finite
(``ref.py``).  ``LAUNCHES`` counts the kernel's launches (plain-version
calls do not).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import rwkv_scan_ref

CT = 64                      # tokens per chunk
HD = 64                      # the head dim the kernel takes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"rwkv_scan_kernel": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("rwkv_scan")
    if not getattr(lib, "_declared", False):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rwkv_scan.argtypes = [vp] * 8 + [i32] * 5 + [vp]
        lib.rwkv_scan.restype = i32
        lib.rwkv_scan_occupancy.argtypes = [i32, vp, vp]
        lib.rwkv_scan_occupancy.restype = i32
        lib._declared = True
    return lib


def _check(r, k, v, w, u, state) -> None:
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}: want four "
                         f"(B, T, H, hd)")
    B, T, H, hd = r.shape
    if T < 1:
        raise ValueError("rwkv_scan takes T >= 1 tokens")
    if tuple(u.shape) != (H, hd) or tuple(state.shape) != (B, H, hd, hd):
        raise ValueError(f"u {tuple(u.shape)}, state {tuple(state.shape)}: "
                         f"want ({H}, {hd}) and ({B}, {H}, {hd}, {hd})")
    devs = {t.device for t in (r, k, v, w, u, state)}
    if len(devs) != 1:
        raise ValueError(
            f"inputs on several devices: {sorted(map(str, devs))}")
    if r.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {r.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, w, u, state)):
        raise NotImplementedError(
            "rwkv_scan_kernel has no backward kernel (nor has the "
            "reference's, ROADMAP.md queue C): training goes through "
            "autograd of models/rwkv.py::rwkv_chunked; call the kernel "
            "under torch.no_grad() or torch.inference_mode()")


def rwkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, state: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The RWKV6 recurrence over T tokens from ``state`` (w the decay in
    (0, 1), u the bonus).  Returns (y in r's dtype, final state f32)."""
    _check(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv_scan_ref(r, k, v, w, u, state, ct=CT)
    B, T, H, hd = r.shape
    if not (r.dtype == k.dtype == v.dtype == w.dtype
            and r.dtype in DTYPES):
        raise TypeError(f"the kernel takes f32 or bf16 r, k, v, w of one "
                        f"dtype; got {r.dtype}, {k.dtype}, {v.dtype}, "
                        f"{w.dtype}")
    if state.dtype != torch.float32:
        raise TypeError(f"the kernel takes an f32 state, got {state.dtype}")
    if hd != HD:
        raise ValueError(f"the kernel takes head_dim {HD}, got {hd}")
    if not all(t.is_contiguous() for t in (r, k, v, w, state)):
        raise ValueError("r, k, v, w and state must be contiguous")
    y = torch.empty_like(r)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("y", y),
                    ("state", state)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned (data_ptr "
                             f"{t.data_ptr():#x}): the kernel's tensor "
                             f"copies and 16-byte stores need it")
    uf = u.float().contiguous()
    s_out = torch.empty_like(state)
    lib = _lib()
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        err = lib.rwkv_scan(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), uf.data_ptr(), state.data_ptr(),
                            y.data_ptr(), s_out.data_ptr(), B, T, H, hd,
                            DTYPES[r.dtype], stream)
    if err:
        raise RuntimeError(f"rwkv_scan_kernel launch failed: cudaError {err}")
    LAUNCHES["rwkv_scan_kernel"] += 1
    return y, s_out


def launch_shape(B: int, H: int, dtype: torch.dtype) -> dict:
    """How the kernel launches for r of ``dtype`` with B rows and H heads on
    the current card: grid (H, B), threads and dynamic shared memory bytes
    a block, and the blocks resident on one SM, as the CUDA runtime
    computes them."""
    threads, smem = ctypes.c_int(0), ctypes.c_int(0)
    blocks = _lib().rwkv_scan_occupancy(DTYPES[dtype], ctypes.byref(threads),
                                        ctypes.byref(smem))
    if blocks < 0:
        raise RuntimeError("rwkv_scan_occupancy failed")
    return {"grid": (H, B), "threads": threads.value,
            "smem_bytes": smem.value, "blocks_per_sm": blocks}
