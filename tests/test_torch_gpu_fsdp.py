"""Tests of weight decay, gradient accumulation and the fsdp_stream
strategy that need a CUDA card.  They skip without a card.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_fsdp.py

1. agg_opt_chunks, multi_agg_opt_chunks (g a strip of a wider buffer, read
   in place), adam_opt_chunks and dequant_agg_opt_chunks (a window's strip
   of every shard, p' into a given buffer, m in place, inv_n and the device
   divisor 3) with weight decay 1e-4 and 0.1 equal their plain versions
   bitwise: f32 and bf16, a ragged length, NaN and Inf in p and g.  With
   decay 0 they equal the plain versions without the term.
2. A reduced llama3.2-1b W=4 step (f32 activations) under fsdp_stream
   (Nesterov with decay, Adam with decay), under sharded_ps with
   ``microbatch=2`` and with decay: the card against the CPU within the
   bounds ``chip_smoke.py`` holds (loss 1e-3, parameters 1e-4; Adam at eps
   1e-3 within lr * |dg| / eps), and two card runs bitwise equal.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import own_strips
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                             dequant_agg_opt_ref,
                                             multi_agg_opt_ref)
from repro_torch.kernels.quant import quantize_int8
from repro_torch.models import DecoderLM

pytestmark = pytest.mark.gpu

N, CE, LR, MU = 8192 * 5 + 100, 1024, 0.01, 0.9
DECAYS = (0.0, 1e-4, 0.1)
DTYPES = ("float32", "bfloat16")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _same(got, want) -> bool:
    return all(a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
               for a, b in zip(got, want))


def _inputs(dtype, seed, W=4):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)
    p, m = rnd(N), rnd(N)
    p[5], p[17], p[101] = float("nan"), float("inf"), -float("inf")
    # rows of whole 16-byte vectors in bf16 too, the strip at 1024
    buf = rnd(W, -(-N // 64) * 64 + 4096 + 1024, scale=1e-2)
    buf[:, 1024::7] = 0
    buf[2, 1024 + 23] = float("inf")
    return p, m, buf[:, 1024:1024 + N], gen


@pytest.mark.parametrize("wd", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_nesterov_with_decay_matches_plain(dtype, wd):
    _need_card()
    p, m, g, _ = _inputs(getattr(torch, dtype), 1)
    kw = dict(lr=LR, momentum=MU, weight_decay=wd, chunk_elems=CE)
    got = ops.fused_agg_opt(p, g[0], m, **kw)
    want = agg_opt_ref(p, g[0], m, lr=LR, momentum=MU, weight_decay=wd)
    assert _same(got, want)
    got = ops.fused_multi_agg_opt(p, g, m, **kw)
    want = multi_agg_opt_ref(p, g, m, lr=LR, momentum=MU, weight_decay=wd)
    assert _same(got, want)
    if wd == 0:
        assert _same(want, multi_agg_opt_ref(p, g, m, lr=LR, momentum=MU))
    d = torch.tensor([3.0], device="cuda")
    po, mi = torch.empty_like(p), m.clone()
    ops.fused_multi_agg_opt(p, g, mi, p_out=po, divisor=d, **kw)
    assert _same((po, mi), multi_agg_opt_ref(
        p, g, m, lr=LR, momentum=MU, weight_decay=wd, divisor=d))


@pytest.mark.parametrize("wd", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_adam_with_decay_matches_plain(dtype, wd):
    _need_card()
    p, m, g, gen = _inputs(getattr(torch, dtype), 2)
    v = m.abs()
    k1 = torch.rand(N, device="cuda", generator=gen)
    k2 = torch.rand(N, device="cuda", generator=gen)
    k1[::5] = 0
    kw = dict(lr=1e-3, eps=1e-8, weight_decay=wd)
    for gg in (g[0], g):
        want = adam_opt_ref(p, gg, m, v, k1, k2, **kw)
        slots = [t.clone() for t in (m, v, k1, k2)]
        got = ops.fused_adam_opt(p, gg, *slots, chunk_elems=CE, **kw)
        assert _same(got, want)


@pytest.mark.parametrize("wd", DECAYS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_cuda_dequant_tail_with_decay_matches_plain(dtype, wd):
    _need_card()
    dt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(3)
    S, L = 4, 4 * CE
    Lw = L // 2
    p = torch.randn(S * L, device="cuda", generator=gen).to(dt)
    m = torch.randn(S * L, device="cuda", generator=gen).to(dt)
    p[3] = float("inf")
    own = own_strips((torch.randn(S, S * L, device="cuda", generator=gen)
                      * 1e-2).to(dt), 2, 1)
    q, sc = quantize_int8(torch.randn(S * Lw, device="cuda", generator=gen)
                          * 1e-2, chunk_elems=CE)
    strip = lambda t: t.view(S, L)[:, Lw:]                # noqa: E731
    for div in (None, torch.tensor([3.0], device="cuda")):
        kw = dict(lr=LR, momentum=MU, inv_n=1 / S, chunk_elems=CE,
                  divisor=div, weight_decay=wd)
        want = dequant_agg_opt_ref(strip(p), q, sc, own, strip(m), **kw)
        po, mi = torch.empty_like(p), m.clone()
        ops.fused_dequant_agg_opt(strip(p), q, sc, own, strip(mi),
                                  p_out=strip(po), **kw)
        assert _same((strip(po), strip(mi)), want)


CASES = {"fsdp nesterov decay": ("nesterov", dict(strategy="fsdp_stream",
                                                  weight_decay=0.1)),
         "fsdp adam decay": ("adam", dict(strategy="fsdp_stream",
                                          weight_decay=0.1)),
         "microbatch 2": ("nesterov", dict(microbatch=2)),
         "decay": ("nesterov", dict(weight_decay=0.1))}


def _step(cfg, tc, dev, init):
    eng = PHubEngine(cfg, tc, StackedComm(4), device=dev)
    # copies: a step writes the new parameters into its model's tensors
    model = DecoderLM(cfg, device=dev, params={
        k: ({kk: vv.to(dev, copy=True) for kk, vv in v.items()}
            if isinstance(v, dict) else v.to(dev, copy=True))
        for k, v in init.items()})
    opt = eng.init_opt()
    data = SyntheticTokens(cfg, 8, 32, seed=0)
    model, opt, met = eng.make_train_step()(model, opt,
                                            data.torch_batch(0, dev))
    moms = [t.to("cpu", copy=True) for p, t in leaf_paths(opt)
            if p.startswith("['m']") or p.endswith("['m']")]
    return (float(met["loss"]),
            [t.detach().to("cpu", copy=True)
             for _, t in leaf_paths(model.param_tree())], moms)


@pytest.mark.parametrize("case", list(CASES))
def test_cuda_step_matches_cpu_and_repeats(case):
    _need_card()
    rule, fields = CASES[case]
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-1b"), d_model=128),
                              dtype="float32")
    kw = dict(loss_chunk=16, **fields)
    if rule == "adam":
        kw.update(optimizer="adam", lr=3e-4, adam_eps=1e-3)
    tc = TrainConfig(**kw)
    init = PHubEngine(cfg, tc, StackedComm(4), device="cpu") \
        .init_model(0).param_tree()
    init = {k: ({kk: vv.detach().clone() for kk, vv in v.items()}
                if isinstance(v, dict) else v.detach().clone())
            for k, v in init.items()}
    cpu = _step(cfg, tc, "cpu", init)
    card, again = (_step(cfg, tc, "cuda", init) for _ in range(2))
    assert card[0] == again[0]
    assert all(torch.equal(a, b) for a, b in zip(card[1] + card[2],
                                                 again[1] + again[2]))
    assert abs(card[0] - cpu[0]) <= 1e-3
    dparam = max(float((a - b).abs().max()) for a, b in zip(card[1], cpu[1]))
    dm = max(float((a.float() - b.float()).abs().max())
             for a, b in zip(card[2], cpu[2]))
    if rule == "nesterov":
        assert dparam <= 1e-4 and dm <= 1e-2
    else:
        dg = dm / (1 - tc.adam_b1)
        assert dg <= 1e-2 and dparam <= tc.lr * dg / tc.adam_eps * 1.01 + 1e-6
