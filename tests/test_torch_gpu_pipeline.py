"""Tests of the gradient processing pipeline that need a CUDA card: the
rules' kernels with a row stride, and the windowed, flat-resident and
chunk-ready train steps on the card.  They skip without a card.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_pipeline.py

1. multi_agg_opt_chunks, sgd_opt_chunks and adam_opt_chunks launched on a
   strip of a wider stacked buffer, read in place (rows ``N`` apart), equal
   their launch on a contiguous copy and their plain version bitwise, in
   f32 and bf16, at W = 3 and 4, with whole chunks and a ragged last
   chunk, with and without the device divisor, in the windowed form too
   (p' into a given buffer, slots in place); agg_opt_chunks takes a
   ragged vector without a copy.
   dequant_agg_opt_chunks (the int8 tail) on window w's strips of every
   shard, p, m and the owners' rows read in place (the block diagonal of
   the stacked buffer), p' into a given buffer and m in place, with the
   static ``inv_n`` and with the device divisor (3: a division, not
   ``* 1/3``), equals its plain version bitwise, f32 and bf16, S = 1-4.
2. A reduced W=4 step (two steps) windowed, flat-resident and chunk-ready
   equals the monolithic tree-resident step bitwise; the chunk-ready run
   twice gives the same bits (no race between the backward's stream and
   the windows' side stream); over the int8 wire too.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows, own_strips
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels import quant
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                             dequant_agg_opt_ref,
                                             multi_agg_opt_ref, sgd_opt_ref)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _inputs(rule, W, n, N, lo, dtype, seed):
    """p, the (W, N) buffer whose strip [lo, lo+n) is g, and the slots."""
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape, scale=1.0):
        return (torch.randn(*shape, device="cuda", generator=gen)
                * scale).to(dtype)
    p, buf = draw(n), draw(W, N, scale=1e-2)
    buf[:, ::7] = 0
    if rule == "nesterov":
        return p, buf, (draw(n),)
    if rule == "sgd":
        return p, buf, ()
    k1 = torch.rand(n, device="cuda", generator=gen)
    k2 = torch.rand(n, device="cuda", generator=gen)
    k1[::5] = 0
    k2[::5] = 0
    return p, buf, (draw(n, scale=1e-2), draw(n, scale=1e-2).abs(), k1, k2)


def _kernel(rule, p, g, slots, **kw):
    if rule == "nesterov":
        p2, m2 = ops.fused_multi_agg_opt(p, g, slots[0], lr=0.05,
                                         momentum=0.9, **kw)
        return p2, (m2,)
    if rule == "sgd":
        return ops.fused_sgd_opt(p, g, lr=0.05, **kw), ()
    p2, *s2 = ops.fused_adam_opt(p, g, *slots, lr=1e-3, **kw)
    return p2, tuple(s2)


def _plain(rule, p, g, slots, divisor=None):
    if rule == "nesterov":
        p2, m2 = multi_agg_opt_ref(p, g, slots[0], lr=0.05, momentum=0.9,
                                   divisor=divisor)
        return p2, (m2,)
    if rule == "sgd":
        return sgd_opt_ref(p, g, lr=0.05, divisor=divisor), ()
    p2, *s2 = adam_opt_ref(p, g, *slots, lr=1e-3, divisor=divisor)
    return p2, tuple(s2)


def _clone(slots):
    return tuple(s.clone() for s in slots)


@pytest.mark.gpu
@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [3, 4])
@pytest.mark.parametrize("n", [8192 * 3, 8192 * 3 + 72])
@pytest.mark.parametrize("divided", [False, True])
def test_cuda_rules_read_a_strided_window_in_place(rule, dtype, W, n,
                                                   divided):
    _need_card()
    lo, N = 8192 * 2, 8192 * 7
    p, buf, slots = _inputs(rule, W, n, N, lo, dtype, W * n + len(rule))
    g = buf[:, lo:lo + n]
    assert g.stride(0) == N and not g.is_contiguous()
    divisor = (torch.tensor([W - 0.5], device="cuda") if divided else None)
    kw = {"divisor": divisor} if divided else {}
    want = _plain(rule, p, g.contiguous(), _clone(slots), divisor)
    copy = _kernel(rule, p, g.contiguous(), _clone(slots), **kw)
    ops.reset_launches()
    got = _kernel(rule, p, g, _clone(slots), **kw)
    inplace, p_out = _clone(slots), torch.empty_like(p)
    windowed = _kernel(rule, p, g, inplace, p_out=p_out, **kw)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == 2
    assert windowed[0] is p_out
    assert all(a is b for a, b in zip(windowed[1], inplace))
    for run in (copy, got, windowed):
        assert torch.equal(run[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(run[1], want[1]))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [8192 * 2 + 5, 8192 * 2 + 128, 37])
def test_cuda_agg_opt_takes_a_ragged_vector_without_a_copy(dtype, n):
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    p, g, m = (torch.randn(n, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    want = agg_opt_ref(p, g, m, lr=0.05, momentum=0.9)
    p_out = torch.empty_like(p)
    m_in = m.clone()
    got = ops.fused_agg_opt(p, g, m_in, lr=0.05, momentum=0.9, p_out=p_out)
    plain = ops.fused_agg_opt(p, g, m, lr=0.05, momentum=0.9)
    torch.cuda.synchronize()
    for run in (got, plain):
        assert torch.equal(run[0], want[0]) and torch.equal(run[1], want[1])
    assert got[0] is p_out and got[1] is m_in


@pytest.mark.gpu
def test_cuda_rules_refuse_misaligned_strided_rows():
    _need_card()
    buf = torch.zeros(3, 1001, device="cuda")
    p, m = torch.zeros(500, device="cuda"), torch.zeros(500, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        ops.fused_multi_agg_opt(p, buf[:, :500], m, lr=0.1, momentum=0.9)


@pytest.mark.gpu
@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("divided", [False, True])
def test_cuda_dequant_agg_opt_reads_window_strips_in_place(S, dtype,
                                                           divided):
    _need_card()
    ce, windows, w = 8192, 3, 1
    n = S * windows * 2 * ce
    L, Lw = n // S, n // S // windows
    gen = torch.Generator(device="cuda").manual_seed(S * 10 + divided)
    p, m = (torch.randn(n, device="cuda", generator=gen).to(dtype)
            for _ in range(2))
    g = (torch.randn(S, n, device="cuda", generator=gen) * 1e-2).to(dtype)
    q, s = quant.quantize_int8(torch.randn(S * Lw, device="cuda",
                                           generator=gen), chunk_elems=ce)
    strip = lambda v: v.view(S, L)[:, w * Lw:(w + 1) * Lw]
    own = own_strips(g, windows, w)
    divisor = torch.tensor([3.0], device="cuda") if divided else None
    kw = dict(lr=0.05, momentum=0.9, inv_n=1 / 3, chunk_elems=ce,
              divisor=divisor)
    want = dequant_agg_opt_ref(strip(p), q, s, own, strip(m), **kw)
    p_out, m_in = torch.full_like(p, 7.0), m.clone()
    po, mi = strip(p_out), strip(m_in)
    ops.reset_launches()
    got = ops.fused_dequant_agg_opt(strip(p), q, s, own, mi, p_out=po, **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["dequant_agg_opt_chunks"] == 1
    assert torch.equal(strip(p_out), want[0])
    assert torch.equal(strip(m_in), want[1])
    outside = torch.ones(n, dtype=torch.bool, device="cuda")
    strip(outside).zero_()
    assert bool((p_out[outside] == 7.0).all())
    assert torch.equal(m_in[outside], m[outside])
    assert got[0] is po and got[1] is mi


# ------------------------------------------------------- reduced steps

def _step_run(mode, steps=2):
    """Losses, parameters and slots after ``steps`` W=4 steps of a reduced
    llama3.2-1b (f32 activations) on the card."""
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-1b"), d_model=128),
                              dtype="float32")
    tc = TrainConfig(lr=0.05, loss_chunk=16, chunk_size_bytes=7680, **mode)
    int8 = tc.wire_format == "int8"
    eng = PHubEngine(cfg, tc, StackedComm(4), device="cuda")
    (g,) = eng.chunk_plan.groups
    assert effective_windows(g, tc.pipeline_windows) == tc.pipeline_windows
    model, opt = eng.init_state(seed=7)
    step = eng.make_train_step()
    data = SyntheticTokens(cfg, 8, 32, seed=6)
    ops.reset_launches()
    losses = []
    for i in range(steps):
        model, opt, m = step(model, opt, data.torch_batch(i, "cuda"))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    S = 4
    if int8:
        assert ops.LAUNCHES["dequant_agg_opt_chunks"] == \
            steps * tc.pipeline_windows
    else:
        assert ops.LAUNCHES["multi_agg_opt_chunks"] == steps * (
            tc.pipeline_windows * S if tc.pipeline_windows > 1 else 1)
    return (torch.stack(losses).cpu(),
            [t.detach().cpu() for _, t in leaf_paths(model.param_tree())],
            opt["float32"]["m"].cpu())


@pytest.mark.gpu
def test_cuda_pipeline_steps_equal_the_monolithic_step_bitwise():
    _need_card()
    base = _step_run({})
    modes = {"windows": dict(pipeline_windows=5),
             "flat": dict(flat_residency=True),
             "overlap": dict(pipeline_windows=5, overlap_backward=True),
             "overlap+flat": dict(pipeline_windows=5, overlap_backward=True,
                                  flat_residency=True)}
    for name, mode in modes.items():
        runs = [_step_run(mode)]
        if mode.get("overlap_backward"):
            runs.append(_step_run(mode))        # twice: no stream race
        for losses, params, m in runs:
            assert torch.equal(losses, base[0]), name
            assert all(torch.equal(a, b) for a, b in zip(params, base[1])), \
                name
            assert torch.equal(m, base[2]), name


@pytest.mark.gpu
def test_cuda_int8_pipeline_steps_equal_the_one_window_step_bitwise():
    _need_card()
    base = _step_run(dict(wire_format="int8"))
    for mode in (dict(pipeline_windows=5),
                 dict(pipeline_windows=5, overlap_backward=True,
                      flat_residency=True)):
        for losses, params, m in [_step_run(dict(mode, wire_format="int8"))
                                  for _ in range(2)]:
            assert torch.equal(losses, base[0])
            assert all(torch.equal(a, b) for a, b in zip(params, base[1]))
            assert torch.equal(m, base[2])
