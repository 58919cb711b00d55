"""Wrapper of the flash sliding-window GQA attention kernel
(``repro/kernels/swa_attn/ops.py``): the prefill's attention.

``swa_attention(q, k, v, window=)`` takes the model layout, q
``(B, T, nh, hd)`` and k/v ``(B, T, kv, hd)``, and returns ``(B, T, nh,
hd)`` in q's dtype.  The kernel reads that layout in place (no transposed
or padded copy: the TPU wrapper pads hd to 128 in HBM, the card pads it in
shared memory only).  A CPU tensor takes the plain version in ``ref.py``;
a CUDA tensor launches the kernel, and a library that cannot be built or
loaded raises.  The kernel takes f32 or bf16 (q, k and v of one dtype),
hd <= 128 and nh a multiple of kv.

The kernel runs its products on the tensor cores in 3xTF32 (each f32
operand split into two TF32 parts, three products a product: f32
accuracy, ``csrc/swa_attn.cu``) and sums the dot products and the online
softmax in another order than the plain version (64-key tiles, 8-column
k-steps; the plain version one einsum over 1024-key blocks), so it is held
to a tolerance: f32 within 2e-5 * max(1, max|want|) (the reference's own
bound; ``tests/test_torch_swa_tf32x3.py`` holds a CPU emulation of the
3xTF32 arithmetic within half of it), bf16 within 3e-2 (the kernel casts q
to f32 before it scales it, the plain version scales in bf16).
``LAUNCHES`` counts the kernel's launches (plain-version calls do not).
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import swa_attention_ref

MAX_HD = 128
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = {"swa_attention_kernel": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("swa_attn")
    if not getattr(lib, "_declared", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.swa_attention.argtypes = [vp] * 4 + [i32] * 7 + [f32, vp]
        lib.swa_attention.restype = i32
        lib.swa_attention_occupancy.argtypes = [i32]
        lib.swa_attention_occupancy.restype = i32
        lib._declared = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, T, nh, hd) and two "
                         f"(B, T, kv, hd)")
    B, T, nh, hd = q.shape
    if k.shape[:2] != (B, T) or k.shape[3] != hd or nh % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not match (nh a multiple of kv)")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def swa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """Causal (sliding-window: a query at p sees keys in (p - window, p];
    0 = full causal) GQA attention.  Returns (B, T, nh, hd) in q.dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2),
                                 window=window).transpose(1, 2)
    B, T, nh, hd = q.shape
    kv = k.shape[2]
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes f32 or bf16 q, k, v of one dtype; "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd > MAX_HD:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HD}, got {hd}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.swa_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                o.data_ptr(), B, T, nh, kv, hd, int(window),
                                DTYPES[q.dtype], hd ** -0.5, stream)
    if err:
        raise RuntimeError(f"swa_attention_kernel launch failed: cudaError "
                           f"{err}")
    LAUNCHES["swa_attention_kernel"] += 1
    return o


def occupancy(hd: int) -> int:
    """Blocks of the f32 kernel (8 warps each) resident on one SM of the
    current card at head_dim ``hd``, as the CUDA runtime computes it."""
    return int(_lib().swa_attention_occupancy(int(hd)))
