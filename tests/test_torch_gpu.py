"""Tests that need a CUDA card: the port's kernels against their plain
versions on the card.  They skip without a card.  This file imports no JAX,
so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import StackedComm
from repro_torch.core.pipeline import pipelined_wire_exchange
from repro_torch.core.wire import WireFormat
from repro_torch.kernels import quant
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                             dequant_agg_opt_ref,
                                             multi_agg_opt_ref, sgd_opt_ref)
from repro_torch.optim.protocol import (AdamOptimizer, NesterovOptimizer,
                                        SGDOptimizer)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


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


def _codec_input(n_chunks, ce, seed):
    """Random chunks, one all-zero chunk, and a chunk of amax 127 (scale
    exactly 1) holding ties at .5 and the payload's ends +-127."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(n_chunks, ce, device="cuda", generator=gen) * 3
    x[1] = 0
    k = min(ce, 6)
    x[2, k:] = x[2, k:].clamp(-126, 126)
    x[2, :k] = torch.tensor([127.0, -127.0, 2.5, -3.5, 0.5, -0.5][:k])
    return x.reshape(-1)


@pytest.mark.gpu
@pytest.mark.parametrize("ce", [8192, 16384, 1000, 4])
def test_cuda_codec_matches_plain_bitwise(ce):
    """quantize_chunks and dequantize_chunks at the main path's chunk
    (8192), a bf16 group's (16384), a ragged one (not a multiple of 128)
    and the smallest the kernel takes."""
    _need_card()
    x = _codec_input(5 if ce > 4 else 700, ce, seed=ce)
    quant.reset_launches()
    q, s = quant.quantize_int8(x, chunk_elems=ce)
    d = quant.dequantize_int8(q, s, chunk_elems=ce)
    torch.cuda.synchronize()
    assert quant.LAUNCHES == {"quantize_chunks": 1, "dequantize_chunks": 1}
    q_ref, s_ref = quant.quantize_int8_ref(x, ce)
    assert q.dtype == torch.int8 and torch.equal(q, q_ref)
    assert torch.equal(s, s_ref)
    assert s[1] == 1.0 and torch.equal(q.view(-1, ce)[1], torch.zeros_like(
        q.view(-1, ce)[1]))
    k = min(ce, 6)
    assert q.view(-1, ce)[2, :k].tolist() == [127, -127, 2, -4, 0, 0][:k]
    assert torch.equal(d, quant.dequantize_int8_ref(q, s, ce))


@pytest.mark.gpu
def test_cuda_codec_rejects_what_it_does_not_take():
    _need_card()
    with pytest.raises(ValueError, match="multiple of 4"):
        quant.quantize_int8(torch.zeros(6, device="cuda"), chunk_elems=6)
    with pytest.raises(ValueError, match="at most"):
        quant.quantize_int8(torch.zeros(32768, device="cuda"),
                            chunk_elems=32768)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ce", [8192, 1000])
def test_cuda_dequant_agg_opt_matches_plain_bitwise(S, dtype, ce):
    """The int8 tail with the owner's rows contiguous (S = 1) or read on
    the block diagonal of the stacked (S, n) buffer in place."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(10 * S + ce % 7)
    n = S * 3 * ce
    p, m = (torch.randn(n, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    g = torch.randn(S, n, device="cuda", generator=gen).to(dtype)
    q, s = quant.quantize_int8(torch.randn(n, device="cuda", generator=gen),
                               chunk_elems=ce)
    own = g[0] if S == 1 else g
    kw = dict(lr=0.05, momentum=0.9, inv_n=1.0 / max(S, 3), chunk_elems=ce)
    ops.reset_launches()
    got = ops.fused_dequant_agg_opt(p, q, s, own, m, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_agg_opt_chunks"] == 1
    want = dequant_agg_opt_ref(p, q, s, own, m, **kw)
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("W", [1, 3])
def test_cuda_rules_take_an_f32_gradient_in_a_bf16_group(W):
    """The int8 wire hands SGD, Adam and (on the bf16/f16 wires) Nesterov
    its decoded mean in f32 while the group is bf16."""
    _need_card()
    n = 8192 * 3 + 77
    p, gs, m, v, k1, k2 = _adam_inputs(W, n, torch.bfloat16, seed=40 + W)
    g = torch.randn(W, n, device="cuda").float() * 1e-2
    g = g[0] if W == 1 else g
    kw = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8)
    want = adam_opt_ref(p, g, m, v, k1, k2, **kw)
    got = ops.fused_adam_opt(p, g, m.clone(), v.clone(), k1.clone(),
                             k2.clone(), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(ops.fused_sgd_opt(p, g, lr=0.05),
                       sgd_opt_ref(p, g, lr=0.05))
    if W == 1:
        for a, b in zip(ops.fused_agg_opt(p, g, m, lr=0.05, momentum=0.9),
                        agg_opt_ref(p, g, m, lr=0.05, momentum=0.9)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 3, 4])
@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_exchange_equals_cpu_bitwise(S, rule, dtype):
    """The stacked int8 exchange on the card (kernels) equals the same
    exchange on the CPU (plain versions) bitwise: p', slots', wire_ef'.
    It launches S quantizes (S - 1 on the push, none at S = 1, and the
    pull) and S - 2 dequantizes on the ring hops, one for the pull and,
    where the rule has no fused tail (SGD, Adam), one for the owner's
    partial; Nesterov's tail runs dequant_agg_opt_chunks for S > 1."""
    _need_card()
    ce = 1024
    n = S * 4 * ce
    gen = torch.Generator(device="cuda").manual_seed(S)
    p = torch.randn(n, device="cuda", generator=gen).to(dtype)
    g = (torch.randn(S, n, device="cuda", generator=gen) * 1e-2).to(dtype)
    r = torch.randn(n, device="cuda", generator=gen) * 1e-4
    opt = {"nesterov": NesterovOptimizer(), "sgd": SGDOptimizer(),
           "adam": AdamOptimizer()}[rule]
    coefs = (0.05, 0.9) if rule == "nesterov" else (3e-4,)
    slots = tuple(torch.rand(n, device="cuda", generator=gen)
                  .to(s.resolve_dtype(dtype)) * 1e-2 for s in opt.slots)
    wire = WireFormat("int8")

    def run(dev):
        fd = (opt.kernel_dequant_update(ce, coefs, 1.0 / S)
              if rule == "nesterov" else None)
        return pipelined_wire_exchange(
            StackedComm(S), g.to(dev), p.to(dev),
            tuple(t.to(dev).clone() for t in slots),
            opt.kernel_update(ce, coefs), wire, ce, r.to(dev), fd)

    ops.reset_launches()
    quant.reset_launches()
    got = run("cuda")
    torch.cuda.synchronize()
    n_deq = 1 if S == 1 else (S - 1 if rule == "nesterov" else S)
    assert quant.LAUNCHES == {"quantize_chunks": S,
                              "dequantize_chunks": n_deq}
    tail = {"nesterov": ("dequant_agg_opt_chunks" if S > 1
                         else "agg_opt_chunks"),
            "sgd": "sgd_opt_chunks", "adam": "adam_opt_chunks"}[rule]
    assert ops.LAUNCHES[tail] == 1 and sum(ops.LAUNCHES.values()) == 1
    want = run("cpu")
    p2, s2, r2 = got
    wp, ws, wr = want
    assert torch.equal(p2.cpu(), wp) and torch.equal(r2.cpu(), wr)
    for a, b in zip(s2, ws):
        assert torch.equal(a.cpu(), b)
