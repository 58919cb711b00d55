"""The ZeroComputeEngine and telemetry on the card, at reduced size
(llama3.2-1b at d_model 64, 28 KB chunks so that 5 windows take effect at
4 workers).  They skip without a card.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_telemetry.py

1. ``make_zero_compute_step`` at W=1, W=4 (and 3-of-4) and W=4 over the
   int8 wire in 5 windows: after every step the parameters and every slot
   bitwise equal to ``exchange_stage`` run by hand on rows filled with
   ``p * 1e-4``, and the rule's kernel launched (B1 at W=1, B2 at W=4,
   B6a/B6b/B7 over int8).
2. Telemetry on against off: two steps of ``fit`` at W=4 over the
   identity wire and over int8 in 5 windows, losses, parameters, every
   slot and every launch count bitwise equal; the spans were recorded and
   the null pair is back afterwards.
"""
import dataclasses

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import Membership
from repro_torch.kernels import agg_opt, quant

pytestmark = pytest.mark.gpu

B, T, CHUNK = 8, 32, 28 * 1024
INT8 = dict(wire_format="int8", pipeline_windows=5)


@pytest.fixture(autouse=True)
def _null_telemetry():
    yield
    telemetry.disable()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cfg():
    return dataclasses.replace(reduced(get_arch("llama3.2-1b"), d_model=64),
                               dtype="float32")


def _launches() -> dict:
    return {**agg_opt.LAUNCHES, **quant.LAUNCHES}


def _reset() -> None:
    agg_opt.reset_launches()
    quant.reset_launches()


def _by_hand(eng, model, opt, membership):
    flat = eng.client.flatten(model.param_tree())
    W = eng.comm.n_workers
    mask, live = eng.client.elastic_mask(membership)
    rows = {k: torch.zeros((W, v.numel()), dtype=v.dtype, device="cuda")
            for k, v in flat.items()}
    for k, v in flat.items():
        for w in range(W):
            if mask is None or mask[w]:
                rows[k][w] = v * 1e-4
    n_live = None if mask is None else eng.client.live_divisor(live)
    opt = {k: {n: t.clone() for n, t in d.items()} for k, d in opt.items()}
    return eng.exchange_stage(rows, {k: v.clone() for k, v in flat.items()},
                              opt, n_live)


@pytest.mark.parametrize("W,fields,dead,kernels", [
    (1, {}, None, {"agg_opt_chunks"}),
    (4, {}, None, {"multi_agg_opt_chunks"}),
    (4, {}, 2, {"multi_agg_opt_chunks"}),
    (4, INT8, None, {"quantize_chunks", "dequantize_chunks",
                     "dequant_agg_opt_chunks"}),
], ids=["W=1", "W=4", "W=4 3-of-4", "int8 W=4 5 windows"])
def test_zero_compute_equals_exchange_stage_by_hand(W, fields, dead,
                                                    kernels):
    _need_card()
    eng = PHubEngine(_cfg(), TrainConfig(chunk_size_bytes=CHUNK, **fields),
                     StackedComm(W), device="cuda")
    membership = None if dead is None else Membership.full(W).leave(dead)
    model, opt = eng.init_state(seed=2)
    step = eng.make_zero_compute_step(membership)
    for _ in range(3):
        want_p, want_opt = _by_hand(eng, model, opt, membership)
        _reset()
        model, opt = step(model, opt)
        torch.cuda.synchronize()
        assert {k for k, n in _launches().items() if n} == kernels
        got_p = eng.client.flatten(model.param_tree())
        for k in got_p:
            assert torch.equal(got_p[k], want_p[k]), k
            for n in opt[k]:
                assert torch.equal(opt[k][n], want_opt[k][n]), (k, n)


def _fit(fields, on: bool):
    from repro_torch.training import TrainState, fit
    cfg = _cfg()
    eng = PHubEngine(cfg, TrainConfig(chunk_size_bytes=CHUNK, loss_chunk=T,
                                      **fields),
                     StackedComm(4), device="cuda")
    state = TrainState(*eng.init_state())
    if on:
        telemetry.enable(seed=0)
    _reset()
    state = fit(eng, state, SyntheticTokens(cfg, B, T, seed=3), steps=2,
                log_every=1, log_fn=lambda s: None)
    torch.cuda.synchronize()
    launches = _launches()
    tracer = telemetry.disable()[0]
    return state, launches, tracer


@pytest.mark.parametrize("fields", [{}, INT8], ids=["identity", "int8"])
def test_telemetry_on_equals_off_bitwise(fields):
    _need_card()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        off, l_off, _ = _fit(fields, False)
        on, l_on, tracer = _fit(fields, True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert not telemetry.enabled() and len(tracer.records) > 0
    assert sum(l_on.values()) > 0 and l_on == l_off
    assert on.losses == off.losses
    for (pa, a), (_, b) in zip(leaf_paths(on.params.param_tree()),
                               leaf_paths(off.params.param_tree())):
        assert torch.equal(a, b), pa
    for k in off.opt:
        for n in off.opt[k]:
            assert torch.equal(on.opt[k][n], off.opt[k][n]), (k, n)
