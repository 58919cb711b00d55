"""The port's train step over a gloo process group on the CPU, one worker a
process (``core/comm.py::ProcessGroupComm``, ``launch/dist.py``), held
bitwise against the stacked-worker engine.

1. Reduced llama3.2-1b and reduced rwkv6-3b (2 layers, d_model 128, f32
   activations, T 32, global batch 4), 2 steps at W=2 and W=4 of
   ``fit``: monolithic, in 5 windows, in 5 windows flat-resident, and over
   the int8 wire in 5 windows.  Every step's loss, every parameter after
   the steps and each rank's optimizer slots equal the ``StackedComm(W)``
   engine's (the slots: its row of the rank's shard), and every rank's
   parameters equal every other's.  One intra-op thread a process and
   deterministic algorithms on both sides.  7680-byte chunks (1920 f32
   elements) make 5 windows take effect on both models at W=2 and W=4;
   each case asserts the effective count.
2. ``python -m repro_torch.launch.train --nproc 2 --backend gloo`` on the
   CPU equals ``--workers 2`` loss for loss.
3. What runs on the stacked Comm only raises NotImplementedError citing
   ROADMAP.md queue A item 4b under a process group: the sanity gate, the
   supervisor (``fit(supervisor=)``), chunk-ready dispatch (the step and
   the exchange) and checkpoint save and restore.
"""
import concurrent.futures
import dataclasses
import functools
import hashlib
import os
import tempfile

import pytest
import torch

from repro_torch.checkpoint import restore_train_state
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import (effective_windows,
                                       run_chunk_ready_exchange)
from repro_torch.data import SyntheticTokens
from repro_torch.launch import dist
from repro_torch.launch.train import main as train_main
from repro_torch.resilience import SanityConfig, TrainSupervisor
from repro_torch.training import TrainState, fit

ARCHS = ("llama3.2-1b", "rwkv6-3b")
WORLDS = (2, 4)
T, BATCH, STEPS, LOSS_CHUNK, CHUNK_BYTES, WINDOWS = 32, 4, 2, 16, 7680, 5
MODES = {"monolithic": {},
         "windows": dict(pipeline_windows=WINDOWS),
         "windows-flat": dict(pipeline_windows=WINDOWS, flat_residency=True),
         "int8-windows": dict(pipeline_windows=WINDOWS, wire_format="int8")}
A4B = ("sanity_gate", "supervisor", "chunk_ready_step",
       "chunk_ready_exchange", "checkpoint_save", "checkpoint_restore")
TIMEOUT = 600.0


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(n)


def config(arch: str):
    return dataclasses.replace(reduced(get_arch(arch), d_model=128),
                               dtype="float32")


def train_config(**mode) -> TrainConfig:
    return TrainConfig(lr=0.05, loss_chunk=LOSS_CHUNK,
                       chunk_size_bytes=CHUNK_BYTES, **mode)


def digest(t: torch.Tensor) -> str:
    return hashlib.sha1(t.detach().contiguous().view(-1).view(torch.uint8)
                        .numpy().tobytes()).hexdigest()


def train(comm, arch: str, mode: str) -> dict:
    """STEPS steps of ``fit`` over ``comm``; the losses, a digest of every
    parameter and of each slot row this process keeps, and the effective
    window counts."""
    cfg = config(arch)
    engine = PHubEngine(cfg, train_config(**MODES[mode]), comm, device="cpu")
    model, opt = engine.init_state()
    data = SyntheticTokens(cfg, BATCH, T, seed=0)
    state = fit(engine, TrainState(params=model, opt=opt), data,
                steps=STEPS, log_every=0, hooks=[lambda s, m: None])
    return {"losses": list(state.losses),
            "params": {p: digest(t)
                       for p, t in leaf_paths(model.param_tree())},
            "slots": {(k, n): [digest(row) for row in v]
                      for k, slots in state.opt.items()
                      for n, v in slots.items()},
            "windows": [effective_windows(g, engine.tc.pipeline_windows)
                        for g in engine.chunk_plan.groups]}


def a4b_errors(comm) -> dict:
    """{what: (exception type name, message)} for everything that raises
    A4b over a process group."""
    cfg = config("llama3.2-1b")
    engine = PHubEngine(cfg, train_config(), comm, device="cpu")
    model, opt = engine.init_state()
    data = SyntheticTokens(cfg, BATCH, T, seed=0)
    g = engine.chunk_plan.groups[0]
    d = tempfile.mkdtemp()
    calls = {
        "sanity_gate": lambda: engine.make_train_step(sanity=SanityConfig()),
        "supervisor": lambda: TrainSupervisor(engine),
        "chunk_ready_step": lambda: PHubEngine(
            cfg, train_config(pipeline_windows=WINDOWS,
                              overlap_backward=True),
            comm, device="cpu").make_train_step(),
        "chunk_ready_exchange": lambda: run_chunk_ready_exchange(
            "sharded_ps", comm, engine.grad_buffers()[g.key],
            torch.zeros(g.padded), (opt[g.key]["m"].view(-1),),
            engine.update_fn(g), g, WINDOWS),
        "checkpoint_save": lambda: fit(
            engine, TrainState(params=model, opt=opt), data, steps=1,
            log_every=0, checkpoint_dir=d, checkpoint_every=1),
        "checkpoint_restore": lambda: restore_train_state(d, engine),
    }
    out = {}
    for what, call in calls.items():
        try:
            call()
            out[what] = (None, "returned")
        except Exception as e:                     # the type is the check
            out[what] = (type(e).__name__, str(e))
    return out


def _rank_run(comm, device):
    torch.use_deterministic_algorithms(True)
    out = {(arch, mode): train(comm, arch, mode)
           for arch in ARCHS for mode in MODES}
    if comm.n_workers == 2:
        out["a4b"] = a4b_errors(comm)
    return out


def _init_file() -> str:
    return "file://" + os.path.join(tempfile.mkdtemp(), "pg_init")


@functools.lru_cache(maxsize=None)
def all_groups() -> dict:
    """Every group's ranks' results, the groups spawned side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        runs = {w: ex.submit(dist.run, _rank_run, w, "gloo", "cpu", TIMEOUT,
                             init_method=_init_file(), threads=1)
                for w in WORLDS}
        return {w: f.result() for w, f in runs.items()}


@functools.lru_cache(maxsize=None)
def stacked(world: int, arch: str, mode: str) -> dict:
    return train(StackedComm(world), arch, mode)


CASES = [(w, a, m) for w in WORLDS for a in ARCHS for m in MODES]


@pytest.mark.parametrize("world,arch,mode", CASES,
                         ids=[f"W{w}-{a}-{m}" for w, a, m in CASES])
def test_process_group_step_equals_stacked(world, arch, mode):
    want = stacked(world, arch, mode)
    if mode != "monolithic":
        assert want["windows"] == [WINDOWS], want["windows"]
    ranks = all_groups()[world]
    for r, res in enumerate(ranks):
        got = res[(arch, mode)]
        assert got["windows"] == want["windows"]
        assert got["losses"] == want["losses"], \
            f"rank {r}: losses {got['losses']} != {want['losses']}"
        assert got["params"] == want["params"], \
            f"rank {r}: parameters differ from the stacked step's"
        assert got["params"] == ranks[0][(arch, mode)]["params"]
        assert got["slots"].keys() == want["slots"].keys()
        for key, rows in got["slots"].items():
            assert rows == [want["slots"][key][r]], \
                f"rank {r}: slot {key} differs from the stacked row"


@pytest.mark.parametrize("what", A4B)
def test_stacked_only_paths_raise_a4b(what):
    kind, msg = all_groups()[2][0]["a4b"][what]
    assert kind == "NotImplementedError", (kind, msg)
    assert "queue A item 4b" in msg and "process group" in msg


def test_launcher_nproc_equals_stacked_workers(capfd):
    args = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16", "--log-every", "1"]
    got = train_main(args + ["--nproc", "2", "--backend", "gloo"])
    want = train_main(args + ["--workers", "2"])
    assert got == want and len(got) == 2
    out = capfd.readouterr().out
    assert "(2 processes, gloo)" in out


def test_launcher_rejects_workers_with_nproc():
    with pytest.raises(SystemExit, match="one worker a process"):
        train_main(["--reduced", "--device", "cpu", "--nproc", "2",
                    "--workers", "2"])
