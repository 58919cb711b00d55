"""The co-scheduled step (``core/api.py::PHubConnectionManager.co_step``)
over gloo, one worker a process (``core/comm.py::ProcessGroupComm``,
``launch/dist.py``), against the same step on ``StackedComm(2)``.

Two ranks on the CPU, each running a manager with its own Comm: two
reduced llama3.2-1b tenants (d_model 64 and 128, different lr and
momentum, batches from their own seeds) attached fresh and co-stepped 2
steps, each rank filling its row of the packed gradient buffer from its
own batch slice.  sharded_ps in 1 and 2 windows, Nesterov + SGD, the int8
wire in 2 windows, and hierarchical as 2 pods x 1.  Every rank must end
with the stacked step's losses and parameters bitwise, and the packed
slots of the shard it keeps equal to the stacked rows.  Moving optimizer
state across a packed domain over a process group raises (ROADMAP.md
queue A item 4b).  One spawn runs every case.
"""
import dataclasses
import functools
import os
import tempfile

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubConnectionManager, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.launch import dist

WORLD = 2
STEPS = 2
TIMEOUT = 300.0
CHUNK = 512
D_MODELS = {"A": 64, "B": 128}
# (name, TrainConfig fields of both tenants, tenant B's rule, pods)
CASES = (
    ("sharded_ps", dict(), "nesterov", 1),
    ("sharded_ps-win2", dict(pipeline_windows=2), "nesterov", 1),
    ("nesterov+sgd", dict(), "sgd", 1),
    ("int8-win2", dict(wire_format="int8", pipeline_windows=2), "nesterov",
     1),
    ("hierarchical-2x1", dict(strategy="hierarchical"), "nesterov", 2),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tenants(fields: dict, rule_b: str) -> dict:
    a = TrainConfig(**dict(dict(lr=3e-2, momentum=0.9, loss_chunk=16,
                                chunk_size_bytes=CHUNK), **fields))
    b = dataclasses.replace(a, lr=1e-2, momentum=0.8, optimizer=rule_b,
                            seed=1)
    return {"A": a, "B": b}


def run_case(comm, fields: dict, rule_b: str):
    """Two co-steps through a manager over ``comm``; returns (losses, the
    tenants' flat parameters, the packed slots this process keeps)."""
    torch.use_deterministic_algorithms(True)
    cm = PHubConnectionManager()
    hs, models, batches = [], {}, {}
    for ns, tc in tenants(fields, rule_b).items():
        cfg = reduced(get_arch("llama3.2-1b"), d_model=D_MODELS[ns])
        h = cm.create_service(ns, cfg, tc, comm, device="cpu")
        models[ns] = cm.init_service(h)[0]
        batches[ns] = SyntheticTokens(cfg, 4, 16, seed=ord(ns)).torch_batch(
            0, "cpu")
        hs.append(h)
    cm.attach_services(hs)
    losses = []
    for _ in range(STEPS):
        models, met = cm.co_step(hs, models, batches)
        losses.append({ns: float(m["loss"]) for ns, m in met.items()})
    flat = {ns: torch.cat([t.detach().reshape(-1) for _, t in
                           leaf_paths(m.param_tree())])
            for ns, m in models.items()}
    opt = {n: v.clone() for n, v in cm._co.opt["float32"].items()}
    refused = None
    if not isinstance(comm, StackedComm):
        try:
            cm.detach_service(hs[1])
        except NotImplementedError as e:
            refused = str(e)
    return losses, flat, opt, refused


def _rank_cases(comm, device):
    return {name: run_case(comm, fields, rule_b)
            for name, fields, rule_b, pods in CASES if pods == comm.pods}


@functools.lru_cache(maxsize=None)
def gloo_runs() -> dict:
    out = {}
    for pods in sorted({c[3] for c in CASES}):
        init = "file://" + os.path.join(tempfile.mkdtemp(), "pg_init")
        for r, res in enumerate(dist.run(_rank_cases, WORLD, "gloo", "cpu",
                                         TIMEOUT, init_method=init,
                                         threads=1, pods=pods)):
            for name, v in res.items():
                out.setdefault(name, {})[r] = v
    return out


@pytest.mark.parametrize("name,fields,rule_b,pods", CASES,
                         ids=[c[0] for c in CASES])
def test_gloo_co_step_equals_the_stacked_co_step(name, fields, rule_b,
                                                 pods):
    losses_s, flat_s, opt_s, _ = run_case(StackedComm(WORLD, pods), fields,
                                          rule_b)
    S = WORLD // pods if fields.get("strategy") == "hierarchical" else WORLD
    for r, (losses, flat, opt, refused) in gloo_runs()[name].items():
        assert losses == losses_s, f"rank {r}"
        for ns in D_MODELS:
            assert torch.equal(flat[ns], flat_s[ns]), f"rank {r} {ns}"
        for slot, v in opt.items():
            j = r % S
            assert torch.equal(v, opt_s[slot][j:j + 1]), f"rank {r} {slot}"
        assert refused is not None and "process group" in refused
