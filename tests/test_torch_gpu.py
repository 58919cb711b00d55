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
from repro_torch.kernels import decode_attn, quant, swa_attn
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                             dequant_agg_opt_ref,
                                             health_chunks_ref,
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
            opt.kernel_update(ce, coefs), wire, ce, r.to(dev).clone(), fd)

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


def _same_or_both_nan(a, b):
    """Bitwise equal where b is a number; NaN exactly where b is NaN (the
    card's NaN is canonical, the plain version's may carry a payload)."""
    nan = torch.isnan(b)
    return (torch.equal(torch.isnan(a), nan)
            and torch.equal(a[~nan], b[~nan]))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["f32", "bf16", "ragged", "nan", "inf",
                                  "overflow", "zero"])
@pytest.mark.parametrize("W", [1, 4])
def test_cuda_health_chunks_matches_plain_bitwise(case, W):
    """health_chunks' per-chunk partials and the wrapper's sums against
    the plain version on the same card: bitwise, NaN/Inf where it has
    them; ragged: n not whole chunks and a chunk of 896 elements."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(W + len(case))
    ce = 896 if case == "ragged" else (16384 if case == "bf16" else 8192)
    n = 5 * ce + (77 if case == "ragged" else 0)
    g = torch.randn(W, n, device="cuda", generator=gen)
    if case == "nan":
        g[-1, 3] = float("nan")
    elif case == "inf":
        g[0, ce + 5] = float("-inf")
    elif case == "overflow":
        g[-1, 2 * ce:2 * ce + 64] = 1e20
    elif case == "zero":
        g[:, ce:2 * ce] = 0
    if case == "bf16":
        g = g.bfloat16()
    ops.reset_launches()
    got = ops.fused_health_scan(g, chunk_elems=ce)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["health_chunks"] == 1
    assert sum(ops.LAUNCHES.values()) == 1
    rows = torch.nn.functional.pad(g, (0, -n % ce)).reshape(-1, ce)
    want_parts = health_chunks_ref(rows)
    parts = ops.health_partials(rows)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["health_chunks"] == 2
    assert _same_or_both_nan(parts, want_parts)
    want = want_parts.view(W, -1).sum(1)
    assert _same_or_both_nan(got, want)
    if case == "zero":
        assert (parts.view(W, -1)[:, 1] == 0).all()
    if case in ("inf", "overflow"):
        assert torch.isposinf(got).any()
    if W == 1:
        assert _same_or_both_nan(ops.fused_health_scan(g[0], chunk_elems=ce),
                                 want[0])


@pytest.mark.gpu
@pytest.mark.parametrize("W", [2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_device_divisor_matches_plain_and_the_w_path(W, dtype):
    """B2-B4 with the divisor read on the card: bitwise against their
    plain versions at a live count below W (row 1 zeroed, as the gate
    leaves it), and the same bits as the null-pointer path when the
    divisor holds W."""
    _need_card()
    n = 8192 * 3 + 77
    p, g, m, v, k1, k2 = _adam_inputs(W, n, dtype, seed=70 + W)
    g[1] = 0
    kw = dict(lr=3e-4, b1=0.9, b2=0.999, eps=1e-8)
    for live in (W - 1, W):
        d = torch.tensor([float(live)], device="cuda")
        ops.reset_launches()
        got = ops.fused_multi_agg_opt(p, g, m, lr=0.05, momentum=0.9,
                                      divisor=d)
        want = multi_agg_opt_ref(p, g, m, lr=0.05, momentum=0.9, divisor=d)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        got_sgd = ops.fused_sgd_opt(p, g, lr=0.05, divisor=d)
        assert torch.equal(got_sgd, sgd_opt_ref(p, g, lr=0.05, divisor=d))
        slots = tuple(t.clone() for t in (m, v, k1, k2))
        got_adam = ops.fused_adam_opt(p, g, *slots, divisor=d, **kw)
        want_adam = adam_opt_ref(p, g, m, v, k1, k2, divisor=d, **kw)
        assert all(torch.equal(a, b) for a, b in zip(got_adam, want_adam))
        torch.cuda.synchronize()
        assert ops.LAUNCHES["multi_agg_opt_chunks"] == 1
        assert ops.LAUNCHES["sgd_opt_chunks"] == 1
        assert ops.LAUNCHES["adam_opt_chunks"] == 1
        if live == W:
            assert all(torch.equal(a, b) for a, b in zip(
                got, ops.fused_multi_agg_opt(p, g, m, lr=0.05,
                                             momentum=0.9)))
            assert torch.equal(got_sgd, ops.fused_sgd_opt(p, g, lr=0.05))
            slots = tuple(t.clone() for t in (m, v, k1, k2))
            assert all(torch.equal(a, b) for a, b in zip(
                got_adam, ops.fused_adam_opt(p, g, *slots, **kw)))


# ----------------------------------------------------- attention kernels
#
# Tolerances (kernels/swa_attn/ops.py, kernels/decode_attn/ops.py): the
# kernels sum in another order than the plain versions.  f32 prefill
# within 2e-5 * max(1, max|want|), f32 decode within 3e-5 (the
# reference's bounds, tests/test_kernels.py), bf16 within 3e-2.

def _attn_tol(dtype, base):
    return base if dtype == torch.float32 else 3e-2


@pytest.mark.gpu
@pytest.mark.parametrize("T,nh,kv,hd,window", [
    (128, 4, 2, 64, 0), (128, 4, 2, 64, 32), (128, 2, 2, 120, 48),
    (64, 8, 1, 32, 0),
    (100, 4, 2, 64, 0),            # ragged T: a partial q and kv tile
    (300, 4, 2, 120, 100),         # ragged, windowed, hd 120
    (257, 8, 8, 128, 0),           # MHA, hd 128, one row past a tile
    (129, 4, 2, 120, 1),           # window 1: each row its own key
    (300, 4, 2, 64, 40),           # tiles straddle diagonal and window edge
    (200, 2, 1, 32, 70),           # hd 32, a window inside one q tile
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_swa_attention_matches_plain(T, nh, kv, hd, window, dtype):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(T + hd + window)
    B = 2
    q = torch.randn(B, T, nh, hd, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, T, kv, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, T, kv, hd, device="cuda", generator=gen).to(dtype)
    swa_attn.reset_launches()
    got = swa_attn.swa_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert swa_attn.LAUNCHES["swa_attention_kernel"] == 1
    want = swa_attn.swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2),
                                      window=window).transpose(1, 2)
    assert got.dtype == dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    assert err <= _attn_tol(dtype, 2e-5 * scale), err


def _cache(B, S, kv, hd, dtype, gen, fill, empty_lead=0):
    k = torch.randn(B, S, kv, hd, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, S, kv, hd, device="cuda", generator=gen).to(dtype)
    pos = torch.arange(S, device="cuda", dtype=torch.int32)[None].repeat(B, 1)
    pos = torch.where(pos < fill, pos, -1)
    if empty_lead:                 # the first slots empty, filled after
        pos[:, :empty_lead] = -1
    return k, v, pos.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,nh,kv,hd,window", [
    (2, 256, 4, 2, 64, 0), (2, 300, 4, 2, 64, 100), (2, 512, 8, 8, 128, 0),
    (2, 1024, 5, 5, 64, 256), (2, 2080, 32, 8, 64, 0),
    (2, 700, 32, 8, 120, 500),
    (2, 4096, 32, 8, 120, 0),      # 16 splits of 256 slots
    (2, 4096, 32, 8, 120, 300),    # most splits wholly outside the window
    (1, 40, 4, 2, 64, 0),          # B 1, C < one split
    (1, 3000, 8, 1, 128, 0),       # B 1, one KV head: many splits
])
@pytest.mark.parametrize("q_dtype,kv_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
def test_cuda_decode_attention_matches_plain(B, S, nh, kv, hd, window,
                                            q_dtype, kv_dtype):
    """20% of the slots empty, as the reference's sweep; a second call on
    the same inputs gives the same bits (the splits combine in order)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(S + nh + hd)
    fill = int(S * 0.8)
    k, v, pos = _cache(B, S, kv, hd, kv_dtype, gen, fill)
    q = torch.randn(B, 1, nh, hd, device="cuda", generator=gen).to(q_dtype)
    qp = torch.full((B,), fill, dtype=torch.int32, device="cuda")
    decode_attn.reset_launches()
    got = decode_attn.decode_attention(q, k, v, pos, qp, window=window)
    torch.cuda.synchronize()
    assert decode_attn.LAUNCHES["decode_attention_kernel"] == 1
    want = decode_attn.decode_attention_ref(
        q.reshape(B, kv, nh // kv, hd), k, v, pos, qp.reshape(B, 1),
        window=window).reshape(B, 1, nh, hd)
    assert got.dtype == q_dtype and got.shape == want.shape
    err = float((got.float() - want.float()).abs().max())
    assert err <= _attn_tol(q_dtype, 3e-5), err
    again = decode_attn.decode_attention(q, k, v, pos, qp, window=window)
    assert torch.equal(again, got)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 300])
def test_cuda_decode_attention_empty_leading_blocks_and_rotation(window):
    """The first 200 slots (three whole 64-slot blocks and part of a
    fourth) are empty: the kernel's first blocks are wholly masked, which
    the -1e30 running max must wipe.  Rolling the ring does not change
    the answer."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(window + 1)
    B, S, nh, kv, hd = 2, 640, 8, 2, 64
    k, v, pos = _cache(B, S, kv, hd, torch.bfloat16, gen, S, empty_lead=200)
    q = torch.randn(B, 1, nh, hd, device="cuda", generator=gen)
    qp = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
    got = decode_attn.decode_attention(q, k, v, pos, qp, window=window)
    want = decode_attn.decode_attention_ref(
        q.reshape(B, kv, nh // kv, hd), k, v, pos, qp.reshape(B, 1),
        window=window).reshape(B, 1, nh, hd)
    assert float((got - want).abs().max()) <= 3e-5
    assert torch.isfinite(got).all()
    r = 37
    rolled = decode_attn.decode_attention(
        q, *(torch.roll(t, r, dims=1).contiguous() for t in (k, v, pos)),
        qp, window=window)
    assert float((rolled - got).abs().max()) <= 1e-5
    # a row with no attended slot gives 0 (the cache is all empty)
    empty = decode_attn.decode_attention(q, k, v, torch.full_like(pos, -1),
                                         qp, window=window)
    assert torch.equal(empty, torch.zeros_like(empty))


@pytest.mark.gpu
def test_cuda_attention_kernels_reject_what_they_do_not_take():
    _need_card()
    q = torch.zeros(1, 8, 2, 160, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        swa_attn.swa_attention(q, q, q)
    with pytest.raises(TypeError):
        swa_attn.swa_attention(q.half(), q.half(), q.half())
    k = torch.zeros(1, 16, 1, 64, device="cuda")
    pos = torch.zeros(1, 16, dtype=torch.int32, device="cuda")
    qp = torch.zeros(1, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="nh/kv"):
        decode_attn.decode_attention(torch.zeros(1, 1, 16, 64, device="cuda"),
                                     k, k, pos, qp)
    with pytest.raises(TypeError, match="int32"):
        decode_attn.decode_attention(torch.zeros(1, 1, 2, 64, device="cuda"),
                                     k, k, pos.long(), qp)
