"""The allreduce, centralized_ps and hierarchical strategies on the card,
reduced llama3.2-1b at f32 activations.  They skip without a card.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu \
        tests/test_torch_gpu_strategies.py

1. Stacked, W = 4, 2 steps each: allreduce and centralized_ps equal the
   sharded_ps step bitwise (losses and every parameter); hierarchical
   2 x 2 over every tier (identity, the int8 DCN tier, the int8 ring in
   the pods, both) in windows, chunk-ready and flat-resident equals its
   monolithic step bitwise; a static 3-of-4 membership equals the gated
   step with worker 1 poisoned; each path launches its kernels as many
   times a step as the exchange's plan says.
2. gloo, 2 processes sharing cuda:0 laid out 2 pods x 1 (collectives
   staged through pinned host buffers): hierarchical identity and int8
   DCN, allreduce and centralized_ps equal ``StackedComm(2, 2)``'s steps
   (losses, every parameter, every slot the rank keeps).
"""
import dataclasses
import hashlib

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import Membership
from repro_torch.kernels import agg_opt, quant
from repro_torch.launch import dist
from repro_torch.resilience import SanityConfig
from repro_torch.training import TrainState, fit

pytestmark = pytest.mark.gpu

T, BATCH, STEPS, CHUNK_BYTES, TIMEOUT = 64, 8, 2, 12 * 1024, 300.0
WINDOWS, DEAD = 2, 1
TIERS = {"identity": {}, "dcn": dict(wire_format_dcn="int8"),
         "int8": dict(wire_format="int8"),
         "int8+dcn": dict(wire_format="int8", wire_format_dcn="int8")}
MODES = {"windows": dict(pipeline_windows=WINDOWS),
         "chunk-ready flat": dict(pipeline_windows=WINDOWS,
                                  overlap_backward=True, flat_residency=True)}
GLOO_CASES = {"hierarchical": dict(strategy="hierarchical"),
              "dcn": dict(strategy="hierarchical", wire_format_dcn="int8",
                          pipeline_windows=WINDOWS),
              "allreduce": dict(strategy="allreduce"),
              "centralized_ps": dict(strategy="centralized_ps")}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().view(-1).view(torch.uint8)
                        .cpu().numpy().tobytes()).hexdigest()


def _launches() -> dict:
    return {k: v for k, v in {**agg_opt.LAUNCHES, **quant.LAUNCHES}.items()
            if v}


def train(comm, *, membership=None, gated=False, **kw) -> dict:
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-1b")),
                              dtype="float32")
    tc = TrainConfig(loss_chunk=T, chunk_size_bytes=CHUNK_BYTES, **kw)
    engine = PHubEngine(cfg, tc, comm, device="cuda")
    assert [effective_windows(g, tc.pipeline_windows)
            for g in engine.chunk_plan.groups] == [tc.pipeline_windows]
    model, opt = engine.init_state()
    data = SyntheticTokens(cfg, BATCH, T, seed=0)
    agg_opt.reset_launches()
    quant.reset_launches()
    if membership is None and not gated:
        state = fit(engine, TrainState(params=model, opt=opt), data,
                    steps=STEPS, log_every=0, hooks=[lambda s, m: None])
        losses, opt = list(state.losses), state.opt
    else:
        step = engine.make_train_step(
            membership=membership,
            sanity=SanityConfig(allow_injection=True) if gated else None)
        losses = []
        for i in range(STEPS):
            batch = data.torch_batch(i, "cuda")
            if gated:
                inject = np.ones(comm.n_workers, np.float32)
                inject[DEAD] = np.nan
                model, opt, m = step(model, opt, batch,
                                     {"norm_hi": 1e6, "inject": inject})
            else:
                model, opt, m = step(model, opt, batch)
            losses.append(float(m["loss"]))
    return {"losses": losses, "launches": _launches(),
            "params": [_digest(t) for _, t in leaf_paths(model.param_tree())],
            "slots": {f"{key}/{name}": [_digest(row) for row in v]
                      for key, slots in opt.items()
                      for name, v in slots.items()}}


def _same(a, b) -> bool:
    return (a["losses"][-1] == b["losses"][-1]
            and a["params"] == b["params"])


@pytest.mark.parametrize("strategy", ["allreduce", "centralized_ps"])
def test_baselines_equal_sharded_ps_on_the_card(strategy):
    _need_card()
    got = train(StackedComm(4), strategy=strategy)
    assert _same(got, train(StackedComm(4)))
    assert got["launches"] == {"multi_agg_opt_chunks": STEPS}


def _expected(tier: str, windows: int) -> dict:
    """Launches of 2 steps of hierarchical 2 x 2 (D = 2 shards): the rule
    once (one window) or once a (window, shard); the int8 ring encodes
    once a window (packed over both pods; S = 2 has no middle hop), the
    owners decode once, the DCN tier encodes and decodes once a window,
    the pull encodes and decodes once."""
    rule = 1 if windows == 1 else 2 * windows
    q = d = 0
    if tier in ("int8", "int8+dcn"):
        q, d = windows + 1, windows + 1
    if tier in ("dcn", "int8+dcn"):
        q, d = q + windows, d + windows
    out = {"multi_agg_opt_chunks": STEPS * rule}
    if q:
        out.update(quantize_chunks=STEPS * q, dequantize_chunks=STEPS * d)
    return out


@pytest.mark.parametrize("tier", list(TIERS))
def test_hierarchical_modes_equal_monolithic_on_the_card(tier):
    _need_card()
    mono = train(StackedComm(4, 2), strategy="hierarchical", **TIERS[tier])
    assert mono["launches"] == _expected(tier, 1)
    for mode, extra in MODES.items():
        got = train(StackedComm(4, 2), strategy="hierarchical",
                    **TIERS[tier], **extra)
        assert _same(got, mono), (tier, mode)
        assert got["slots"] == mono["slots"], (tier, mode)
        assert got["launches"] == _expected(tier, WINDOWS), (tier, mode)


@pytest.mark.parametrize("strategy", ["hierarchical", "allreduce",
                                      "centralized_ps"])
def test_membership_equals_gate_on_the_card(strategy):
    _need_card()
    dead = Membership.full(4).leave(DEAD)
    a = train(StackedComm(4, 2), strategy=strategy, membership=dead)
    b = train(StackedComm(4, 2), strategy=strategy, gated=True)
    assert a["losses"] == b["losses"] and a["params"] == b["params"]


def _rank(comm, device):
    return {case: train(comm, **kw) for case, kw in GLOO_CASES.items()}


def test_gloo_2x1_equals_stacked_on_the_card():
    _need_card()
    ranks = dist.run(_rank, 2, "gloo", "cuda", TIMEOUT, pods=2)
    for case, kw in GLOO_CASES.items():
        want = train(StackedComm(2, 2), **kw)
        for r, got in enumerate(ranks):
            assert got[case]["losses"] == want["losses"], (case, r)
            assert got[case]["params"] == want["params"], (case, r)
            for name, rows in want["slots"].items():
                mine = got[case]["slots"][name]
                if case == "centralized_ps":     # the PS is rank 0
                    assert mine == (rows if r == 0 else []), (name, r)
                elif name.endswith("wire_ef"):   # pod r's residual
                    assert mine == [rows[r]], (name, r)
                else:        # one shard (D = 1), pod-replicated or whole
                    assert mine == rows, (name, r)
