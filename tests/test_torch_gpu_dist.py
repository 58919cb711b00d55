"""The train step over a process group on the card: one worker a process
(``core/comm.py::ProcessGroupComm``, ``launch/dist.py``), held bitwise
against the stacked step on the same card.  They skip without a card.
This file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_dist.py

1. NCCL at world 1 (one card): reduced llama3.2-1b, 2 steps, Nesterov,
   Adam in 2 windows and Nesterov over the int8 wire in 2 windows, equal
   to ``StackedComm(1)``'s steps (losses, every parameter, every slot).
2. gloo, 2 processes sharing cuda:0 (their collectives staged through
   pinned host buffers): the same cases against ``StackedComm(2)``.
"""
import dataclasses
import hashlib

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.data import SyntheticTokens
from repro_torch.launch import dist
from repro_torch.training import TrainState, fit

pytestmark = pytest.mark.gpu

# 12 KB chunks: 2 windows take effect on the reduced model at S = 1 and 2
CASES = {"nesterov": dict(optimizer="nesterov"),
         "adam-windows": dict(optimizer="adam", lr=3e-4, pipeline_windows=2),
         "int8-windows": dict(optimizer="nesterov", wire_format="int8",
                              pipeline_windows=2)}
T, BATCH, STEPS, CHUNK_BYTES, TIMEOUT = 64, 8, 2, 12 * 1024, 300.0


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().view(-1).view(torch.uint8)
                        .cpu().numpy().tobytes()).hexdigest()


def train(comm, case: str) -> dict:
    cfg = dataclasses.replace(reduced(get_arch("llama3.2-1b")),
                              dtype="float32")
    tc = TrainConfig(loss_chunk=T, chunk_size_bytes=CHUNK_BYTES,
                     **CASES[case])
    engine = PHubEngine(cfg, tc, comm, device="cuda")
    assert [effective_windows(g, tc.pipeline_windows)
            for g in engine.chunk_plan.groups] == [tc.pipeline_windows]
    model, opt = engine.init_state()
    data = SyntheticTokens(cfg, BATCH, T, seed=0)
    state = fit(engine, TrainState(params=model, opt=opt), data,
                steps=STEPS, log_every=0, hooks=[lambda s, m: None])
    k = comm.local_workers()
    return {"losses": list(state.losses),
            "params": [_digest(t) for _, t in leaf_paths(model.param_tree())],
            "shards": {comm.rank * k + j: [_digest(v[j])
                                           for slots in state.opt.values()
                                           for v in slots.values()]
                       for j in range(k)}}


def _rank(comm, device):
    return {case: train(comm, case) for case in CASES}


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_process_group_step_on_the_card_equals_stacked(backend, world):
    _need_card()
    ranks = dist.run(_rank, world, backend, "cuda", TIMEOUT)
    for case in CASES:
        want = train(StackedComm(world), case)
        for r, got in enumerate(ranks):
            assert got[case]["losses"] == want["losses"], (case, r)
            assert got[case]["params"] == want["params"], (case, r)
            assert got[case]["shards"] == {r: want["shards"][r]}, (case, r)
