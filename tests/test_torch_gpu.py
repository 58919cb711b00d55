"""Tests that need a CUDA card: the port's kernels against their plain
versions on the card.  They skip without a card.  This file imports no JAX,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                             multi_agg_opt_ref, sgd_opt_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_bitwise(W, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(W)
    n = 8192 * 5 + 77
    p, m = (torch.randn(n, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    g = torch.randn(W, n, device="cuda", generator=gen).to(dtype)
    ops.reset_launches()
    if W == 1:
        got = ops.fused_agg_opt(p, g[0], m, lr=0.05, momentum=0.9)
        want = agg_opt_ref(p, g[0], m, lr=0.05, momentum=0.9)
    else:
        got = ops.fused_multi_agg_opt(p, g, m, lr=0.05, momentum=0.9)
        want = multi_agg_opt_ref(p, g, m, lr=0.05, momentum=0.9)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _adam_inputs(W, n, dtype, seed):
    """p, g (W, n), m, v in ``dtype``; k1, k2 f32 with dead runs."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.randn(n, device="cuda", generator=gen).to(dtype)
    g = (torch.randn(W, n, device="cuda", generator=gen) * 1e-2).to(dtype)
    g[:, ::7] = 0
    m = (torch.randn(n, device="cuda", generator=gen) * 1e-2).to(dtype)
    v = (torch.rand(n, device="cuda", generator=gen) * 1e-4).to(dtype)
    k1 = torch.rand(n, device="cuda", generator=gen)
    k2 = torch.rand(n, device="cuda", generator=gen)
    k1[::5] = 0
    k2[::5] = 0
    return p, g, m, v, k1, k2


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8192 * 5, 8192 * 5 + 77])
def test_cuda_sgd_adam_match_plain_bitwise(W, dtype, n):
    """SGD and Adam, whole and ragged chunks: Adam's slots are updated in
    place and compared with the plain version run on clones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    p, g, m, v, k1, k2 = _adam_inputs(W, n, dtype, seed=10 * W + n % 7)
    gg = g[0] if W == 1 else g
    kw = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8)
    want = adam_opt_ref(p, gg, m, v, k1, k2, **kw)
    want_sgd = sgd_opt_ref(p, gg, lr=0.05)
    slots = tuple(t.clone() for t in (m, v, k1, k2))
    p0 = p.clone()
    ops.reset_launches()
    got = ops.fused_adam_opt(p, gg, *slots, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["adam_opt_chunks"] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    assert all(a is b for a, b in zip(got[1:], slots))
    assert torch.equal(p, p0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    got_sgd = ops.fused_sgd_opt(p, gg, lr=0.05)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["sgd_opt_chunks"] == 1
    assert sum(ops.LAUNCHES.values()) == 2
    assert torch.equal(got_sgd, want_sgd)
