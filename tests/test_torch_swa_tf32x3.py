"""The 3xTF32 arithmetic of the prefill attention kernel, emulated on the
CPU, against the port's plain f32 version.

``kernels/swa_attn/csrc/swa_attn.cu`` runs Q K^T and P V on the tensor
cores in TF32 (10 mantissa bits) at f32 accuracy: each operand x is split
into hi = rna_tf32(x) (round to nearest, ties away from zero) and lo = x -
hi, which the mma reads as TF32 (rz_tf32: its 13 low bits dropped); a . b
is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, and the sums are f32.
``swa_tf32x3`` below repeats that arithmetic in plain PyTorch, with the
kernel's online softmax over 64-key tiles (-1e30 for a masked score, the
normaliser clamped at 1e-30), and the tests hold it within half of the
kernel's f32 tolerance, 2e-5 * max(1, max|want|), of
``swa_attention_ref``.  Each product of two TF32 values is exact in f32;
the order of the f32 sums is not the tensor cores' own, so this bounds
the design's error, not the card's bits (the card is held against the
plain version in tests/test_torch_gpu.py and chip_smoke.py).

At a serving length, by hand (h2o-danube-3-4b: T 4608, window 4096):

    PYTHONPATH=src python tests/test_torch_swa_tf32x3.py --T 4608 \\
        --window 4096 --heads 2 --hd 120
"""
import argparse

import numpy as np
import pytest
import torch

from repro_torch.kernels.swa_attn import swa_attention_ref

SWA_RTOL = 2e-5        # the kernel's f32 tolerance (kernels/swa_attn/ops.py)
BLOCK_K = 64           # keys a tile of the kernel
NEG_INF = -1e30


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as cvt.rna.tf32.f32 does for finite x: add half an ulp of TF32
    to the magnitude's bits, then clear the 13 low bits."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def rz_tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 toward zero: the 13 low bits cleared, as the mma
    reads an f32 register given as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = rna_tf32(x)
    return hi, rz_tf32(x - hi)


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma chain: lo.hi, then + hi.lo, then + hi.hi."""
    ah, al = split(a)
    bh, bl = split(b)
    out = al @ bh
    out = out + ah @ bl
    return out + ah @ bh


def swa_tf32x3(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               window: int) -> torch.Tensor:
    """The kernel's arithmetic on the model layout q (B, T, nh, hd), k/v
    (B, T, kv, hd), f32 or bf16; returns f32 (B, T, nh, hd)."""
    B, T, nh, hd = q.shape
    G = nh // k.shape[2]
    qf = (q.float() * np.float32(hd ** -0.5)).transpose(1, 2)
    kf = k.float().repeat_interleave(G, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, dim=2).transpose(1, 2)
    qp = torch.arange(T)[:, None]
    m = torch.full((B, nh, T, 1), NEG_INF)
    l = torch.zeros((B, nh, T, 1))
    acc = torch.zeros((B, nh, T, hd))
    for k0 in range(0, T, BLOCK_K):
        kt, vt = kf[:, :, k0:k0 + BLOCK_K], vf[:, :, k0:k0 + BLOCK_K]
        kp = torch.arange(k0, k0 + kt.shape[2])[None, :]
        ok = kp <= qp
        if window > 0:
            ok &= kp > qp - window
        s = torch.where(ok, matmul3(qf, kt.transpose(-1, -2)), NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + matmul3(p, vt)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).transpose(1, 2)


def errors(T: int, nh: int, kv: int, hd: int, window: int, dtype,
           seed: int = 0) -> tuple[float, float]:
    """(max |emulation - plain|, the tolerance's scale max(1, max|want|))
    on inputs drawn with numpy; bf16 inputs reach both as the same f32."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, T, h, hd),
                                                    dtype=np.float32))
               .to(dtype) for h in (nh, kv, kv))
    got = swa_tf32x3(q, k, v, window)
    want = swa_attention_ref(q.float().transpose(1, 2),
                             k.float().transpose(1, 2),
                             v.float().transpose(1, 2),
                             window=window).transpose(1, 2)
    return (float((got - want).abs().max()),
            max(1.0, float(want.abs().max())))


def test_rna_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    x = torch.tensor([one + 2.0 ** -11, one + 2.0 ** -12, -(one + 2.0 ** -11),
                      one + 3 * 2.0 ** -11, 0.0, 2.0 ** -20],
                     dtype=torch.float32)
    want = torch.tensor([one + 2.0 ** -10, one, -(one + 2.0 ** -10),
                         one + 2 * 2.0 ** -10, 0.0, 2.0 ** -20])
    assert torch.equal(rna_tf32(x), want)
    assert torch.equal(rz_tf32(x[:4]), torch.tensor(
        [one, one, -one, one + 2.0 ** -10]))
    third = torch.tensor([1 / 3], dtype=torch.float32)
    hi, lo = split(third)
    assert abs(float(hi) + float(lo) - float(third)) <= 2.0 ** -21 / 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 1, 100])
@pytest.mark.parametrize("T,nh,kv,hd", [(600, 4, 2, 64), (333, 4, 1, 120)])
def test_tf32x3_within_half_the_kernel_tolerance(T, nh, kv, hd, window,
                                                 dtype):
    err, scale = errors(T, nh, kv, hd, window, dtype, seed=T + window)
    assert err <= 0.5 * SWA_RTOL * scale, (err, scale)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=4608)
    ap.add_argument("--window", type=int, default=4096)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--hd", type=int, default=120)
    args = ap.parse_args()
    for dtype in (torch.float32, torch.bfloat16):
        err, scale = errors(args.T, args.heads, 1, args.hd, args.window,
                            dtype)
        print(f"T {args.T} window {args.window} heads {args.heads} hd "
              f"{args.hd} {dtype}: max_abs {err:.3e}, scale {scale:.3f}, "
              f"half the tolerance {0.5 * SWA_RTOL * scale:.3e}, ratio "
              f"{err / (SWA_RTOL * scale):.4f} of the tolerance")


if __name__ == "__main__":
    main()
