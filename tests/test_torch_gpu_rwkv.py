"""The RWKV6 chunked-scan kernel (B8, ``kernels/rwkv_scan/csrc/
rwkv_scan.cu``) against its plain version on the card.  The tests skip
without a card.  This file imports no JAX, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_rwkv.py

Tolerances (``kernels/rwkv_scan/ops.py``): the kernel sums in another
order than the plain version, which computes the same a, rq and kd bit for
bit.  f32 within 1e-5 * max(1, max|want|); bf16 inputs give bf16 y within
1e-2 * max(1, max|want|) (one bf16 rounding either side of a boundary,
2^-7 relative) and an f32 state within the f32 bound.  Under strong decay
(a uniform w of 0.1, or 0.1 on channels 0-31 and the model's decay on the
rest) both return inf and NaN in the same places.  Two calls give the same
bits; a view that is not 16-byte aligned raises.
"""
import pytest
import torch

from repro_torch.kernels import rwkv_scan as scan

F32_TOL, BF16_TOL = 1e-5, 1e-2


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(B, T, H, seed, *, dtype=torch.float32, zero_state=False,
            w_value=None, mixed=False):
    """r, k, v ~ N(0, 0.5); the model's decay exp(-exp(w0 + tanh-LoRA)),
    w0 spread over [-6, -4.5] as rwkv6-3b's init, with N(0, 0.5) for the
    LoRA term (or a uniform ``w_value``; ``mixed``: 0.1 on channels 0-31);
    u ~ N(0, 0.5); a state ~ N(0, 0.3) or zero."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=gen)

    r, k, v = (randn(B, T, H, 64) * 0.5 for _ in range(3))
    if w_value is None:
        w0 = torch.linspace(-6.0, -4.5, H * 64, device="cuda").reshape(H, 64)
        w = torch.exp(-torch.exp(w0 + randn(B, T, H, 64) * 0.5))
    else:
        w = torch.full((B, T, H, 64), w_value, device="cuda")
    if mixed:
        w[..., :32] = 0.1
    u = randn(H, 64) * 0.5
    S = (torch.zeros(B, H, 64, 64, device="cuda") if zero_state
         else randn(B, H, 64, 64) * 0.3)
    return (*(x.to(dtype) for x in (r, k, v, w)), u, S)


def _plain(r, k, v, w, u, S):
    return scan.rwkv_scan_ref(r, k, v, w, u, S)


def _err(got, want):
    return (float((got.float() - want.float()).abs().max())
            / max(1.0, float(want.float().abs().max())))


@pytest.mark.gpu
@pytest.mark.parametrize("B,T,H,dtype,zero_state", [
    (8, 2048, 40, torch.float32, True),      # the serving shape
    (8, 2048, 40, torch.float32, False),
    (2, 1, 40, torch.float32, False),         # one token
    (2, 40, 40, torch.float32, False),        # one ragged chunk
    (2, 100, 40, torch.float32, False),       # a full and a ragged chunk
    (3, 257, 5, torch.float32, False),
    (2, 100, 40, torch.bfloat16, False),
    (2, 2048, 4, torch.bfloat16, True),
    (1, 64, 1, torch.float32, False),         # one full chunk, one block
    (1, 128, 1, torch.float32, False),
    (1, 2048, 1, torch.float32, False),
    (1, 64, 1, torch.bfloat16, False),
    (1, 128, 1, torch.bfloat16, False),
    (1, 2048, 1, torch.bfloat16, False),
])
def test_cuda_rwkv_scan_matches_plain(B, T, H, dtype, zero_state):
    _need_card()
    inputs = _inputs(B, T, H, seed=B * T + H, dtype=dtype,
                     zero_state=zero_state)
    scan.reset_launches()
    y, s = scan.rwkv_scan(*inputs)
    torch.cuda.synchronize()
    assert scan.LAUNCHES["rwkv_scan_kernel"] == 1
    want_y, want_s = _plain(*inputs)
    assert y.dtype == dtype and s.dtype == torch.float32
    assert y.shape == want_y.shape and s.shape == want_s.shape
    y_tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert _err(y, want_y) <= y_tol
    assert _err(s, want_s) <= F32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("w_value", [0.3, 0.1])
def test_cuda_rwkv_scan_strong_decay_same_places(w_value):
    """w 0.3: finite, as the recurrence.  w 0.1: the cumulative decay
    underflows; kernel and plain version put inf and NaN in the same
    places and agree on the finite entries."""
    _need_card()
    inputs = _inputs(2, 130, 4, seed=7, w_value=w_value)
    y, s = scan.rwkv_scan(*inputs)
    want_y, want_s = _plain(*inputs)
    for got, want in ((y, want_y), (s, want_s)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
        fin = torch.isfinite(want)
        if fin.any():               # w 0.1: the state is all inf and NaN
            assert _err(got[fin], want[fin]) <= F32_TOL
    assert bool(torch.isfinite(y).all()) == (w_value >= 0.3)


@pytest.mark.gpu
@pytest.mark.parametrize("T", [130, 2048])
def test_cuda_rwkv_scan_mixed_decay_same_places(T):
    """0.1 on channels 0-31, the model's decay on the rest: finite and inf
    kd meet in one chunk (and in one lane: it takes channels c and c + 32)."""
    _need_card()
    inputs = _inputs(2, T, 4, seed=8, mixed=True)
    y, s = scan.rwkv_scan(*inputs)
    want_y, want_s = _plain(*inputs)
    for got, want in ((y, want_y), (s, want_s)):
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        assert torch.equal(got[torch.isinf(got)], want[torch.isinf(want)])
        fin = torch.isfinite(want)
        assert fin.any() and not fin.all()
        assert _err(got[fin], want[fin]) <= F32_TOL


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rwkv_scan_two_calls_bitwise(dtype):
    """No atomics and a fixed order: the serving shape twice, the same
    bits."""
    _need_card()
    inputs = _inputs(8, 2048, 40, seed=3, dtype=dtype)
    y, s = scan.rwkv_scan(*inputs)
    y2, s2 = scan.rwkv_scan(*inputs)
    assert torch.equal(y, y2) and torch.equal(s, s2)


@pytest.mark.gpu
def test_cuda_rwkv_scan_rejects_what_it_does_not_take():
    _need_card()
    r, k, v, w, u, S = _inputs(1, 8, 2, seed=1)
    with pytest.raises(TypeError, match="one dtype"):
        scan.rwkv_scan(r, k, v.bfloat16(), w, u, S)
    with pytest.raises(TypeError, match="f32 state"):
        scan.rwkv_scan(r, k, v, w, u, S.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        scan.rwkv_scan(r.transpose(2, 3).contiguous().transpose(2, 3), k, v,
                       w, u, S)
    buf = torch.zeros(r.numel() + 1, device="cuda")
    shifted = buf[1:].view(r.shape)           # storage offset 1: 4 bytes off
    assert shifted.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        scan.rwkv_scan(shifted, k, v, w, u, S)
    r2 = torch.zeros(1, 8, 2, 32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        scan.rwkv_scan(r2, r2, r2, r2, torch.zeros(2, 32, device="cuda"),
                       torch.zeros(1, 2, 32, 32, device="cuda"))
