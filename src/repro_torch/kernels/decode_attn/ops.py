"""Wrapper of the one-token GQA decode attention kernel
(``repro/kernels/decode_attn/ops.py``): the serving hot loop.

``decode_attention(q, k, v, pos, q_pos, window=)`` takes the decode token's
queries q ``(B, 1, nh, hd)``, one layer's ring cache k/v ``(B, C, kv, hd)``
with the global position of each slot in ``pos`` ``(B, C)`` int32 (-1 =
empty), and the queries' positions ``q_pos`` ``(B,)``; it returns ``(B, 1,
nh, hd)`` in q's dtype.  A slot is attended when it is filled, not after
the query and, with ``window`` > 0, within (q_pos - window, q_pos]: the
ring's rotation and eviction need no special handling.

A CPU tensor takes the plain version in ``ref.py``; a CUDA tensor launches
the kernel, and a library that cannot be built or loaded raises.  The
kernel reads the cache in place in its own dtype (bf16 or f32) and q in
f32 or bf16; hd <= 128, nh / kv <= 8.  It is flash-decoding in one launch:
the cache is cut into ``n_split`` splits of ``split_len(B, C, kv)`` slots,
one block each, and the last block of each (row, KV head) to finish
combines the splits' partials in split order, so two calls on the same
inputs give the same bits.  It sums in another order than the plain
version (16-slot chunks a warp, four warps, then the splits; the plain
version one einsum over 1024-slot blocks), so it is held within 3e-5 (the
reference's own bound) for f32 q, 3e-2 for bf16 q.  A row with no attended
slot gives 0.  ``LAUNCHES`` counts the kernel's launches (plain-version
calls do not).

Two buffers serve the combine.  The scratch, ``B * kv * n_split * G * (hd
+ 2)`` f32 (each split's running max and sum a head and its unnormalised
output), is taken from ``torch.empty`` at each call (the caching allocator:
no launch).  The arrival counters, ``B * kv`` int32 a device, are zeroed
once when they are made (or grown) and kept in ``_COUNTERS``: the kernel's
last block of each (row, KV head) sets its counter back to 0.  Calls on two
streams of one device at once would share the counters and are not
supported.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .ref import decode_attention_ref

MAX_HD = 128
MAX_GROUP = 8
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_SLOTS = 64       # a split is a multiple of this many slots
TARGET_BLOCKS = 264    # two blocks for each of the H100's 132 SMs
MAX_SPLITS = 256       # the kernel's bounds (kMaxSplit, kMaxL)
MAX_SPLIT_LEN = 4096

LAUNCHES = {"decode_attention_kernel": 0}
_COUNTERS: dict[torch.device, torch.Tensor] = {}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attn")
    if not getattr(lib, "_declared", False):
        vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.decode_attention.argtypes = ([vp] * 8 + [i32] * 8
                                         + [f32, i32, vp])
        lib.decode_attention.restype = i32
        lib._declared = True
    return lib


def split_len(B: int, C: int, kv: int) -> int:
    """Slots a split: a multiple of SPLIT_SLOTS, so that the (split, KV
    head, row) grid has about TARGET_BLOCKS blocks (at most MAX_SPLITS
    splits of at most MAX_SPLIT_LEN slots).  A function of the shape
    alone."""
    want = min(MAX_SPLITS, -(-TARGET_BLOCKS // (B * kv)))
    chunks = -(-C // SPLIT_SLOTS)
    L = SPLIT_SLOTS * -(-chunks // want)
    while L > MAX_SPLIT_LEN:
        want += 1
        L = SPLIT_SLOTS * -(-chunks // want)
    return L


def _counters(device: torch.device, n: int) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _check(q, k, v, pos, q_pos) -> None:
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B, 1, nh, hd) and two "
                         f"(B, C, kv, hd)")
    B, _, nh, hd = q.shape
    C, kv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or nh % kv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)} do "
                         f"not match (nh a multiple of kv)")
    if tuple(pos.shape) != (B, C) or q_pos.numel() != B:
        raise ValueError(f"pos {tuple(pos.shape)} is not (B, C) = {(B, C)} "
                         f"or q_pos {tuple(q_pos.shape)} has not B entries")
    if len({t.device for t in (q, k, v, pos, q_pos)}) != 1:
        raise ValueError("q, k, v, pos and q_pos lie on different devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, q_pos: torch.Tensor, *,
                     window: int = 0) -> torch.Tensor:
    """One decode token against a position-tagged ring cache.  Returns
    (B, 1, nh, hd) in q.dtype."""
    _check(q, k, v, pos, q_pos)
    B, _, nh, hd = q.shape
    C, kv = k.shape[1], k.shape[2]
    G = nh // kv
    if q.device.type == "cpu":
        return decode_attention_ref(q.reshape(B, kv, G, hd), k, v, pos,
                                    q_pos.reshape(B, 1),
                                    window=window).reshape(B, 1, nh, hd)
    if q.dtype not in DTYPES or k.dtype not in DTYPES or v.dtype != k.dtype:
        raise TypeError(f"the kernel takes f32 or bf16 q and a cache of one "
                        f"f32 or bf16 dtype; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if pos.dtype != torch.int32 or q_pos.dtype != torch.int32:
        raise TypeError(f"pos and q_pos must be int32, got {pos.dtype}, "
                        f"{q_pos.dtype}")
    if hd > MAX_HD or G > MAX_GROUP:
        raise ValueError(f"the kernel takes head_dim <= {MAX_HD} and nh/kv "
                         f"<= {MAX_GROUP}; got {hd}, {G}")
    if C > MAX_SPLITS * MAX_SPLIT_LEN:
        raise ValueError(f"the kernel takes at most "
                         f"{MAX_SPLITS * MAX_SPLIT_LEN} cache slots, got {C}")
    if not all(t.is_contiguous() for t in (q, k, v, pos, q_pos)):
        raise ValueError("q, k, v, pos and q_pos must be contiguous")
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    L = split_len(B, C, kv)
    n_split = -(-C // L)
    part = torch.empty(B * kv * n_split * G * (hd + 2), dtype=torch.float32,
                       device=q.device)
    counters = _counters(q.device, B * kv)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            q_pos.data_ptr(), o.data_ptr(), part.data_ptr(),
            counters.data_ptr(), B, C, nh, kv, hd, int(window),
            DTYPES[q.dtype], DTYPES[k.dtype], hd ** -0.5, L, stream)
    if err:
        raise RuntimeError(f"decode_attention_kernel launch failed: "
                           f"cudaError {err}")
    LAUNCHES["decode_attention_kernel"] += 1
    return o
