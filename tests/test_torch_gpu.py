"""Tests that need a CUDA card: the port's kernels against their plain
versions on the card.  They skip without a card.  This file imports no JAX,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import agg_opt_ref, multi_agg_opt_ref


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
