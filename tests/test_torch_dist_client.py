"""The port's ``PHubClient`` over gloo, one worker a process
(``core/comm.py::ProcessGroupComm``, ``launch/dist.py``), against the
stacked client (``StackedComm``) on the same pushes.

Groups of 2 and 4 ranks on the CPU, laid out as 2 pods (2 x 1 and 2 x 2):
sharded_ps (Nesterov, SGD, Adam, and Nesterov in 2 windows), hierarchical
(1 and 2 windows), allreduce, centralized_ps, and the int8 wire in 2
windows (sharded_ps and hierarchical), 2 steps each.  Each rank pushes its
own row of the step's pushes through ``push_pull`` (tree mode) or
``push_pull_flat`` and must end with the stacked client's parameters
bitwise, and its slots (``wire_ef`` too) equal to the stacked rows of the
shard it keeps (centralized_ps: rank 0 alone, the PS).  The identity
cases draw integer-valued pushes at lr 0.25 and momentum 0.5, so gloo's
own order of ``all_reduce`` (allreduce at 4 ranks) sums exactly; the int8
cases draw normal values (the ring's hop order is the stacked one).  One
spawn runs a group's cases; the two groups are spawned side by side.
"""
import concurrent.futures
import functools
import os
import tempfile
import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig
from repro_torch.core import PHubClient, StackedComm
from repro_torch.launch import dist

WORLDS = (2, 4)
PODS = 2
SHAPES = {"dense": {"w": (60, 48), "b": (48,)}, "scale": (134,)}
CHUNK = 256                      # 12 chunks a shard at S = 4, 24 at S = 2
STEPS = 2
TIMEOUT = 300.0
# (name, TrainConfig fields, flat mode)
CASES = (
    ("sharded_ps-nesterov", dict(), False),
    ("sharded_ps-sgd", dict(optimizer="sgd"), False),
    ("sharded_ps-adam", dict(optimizer="adam"), False),
    ("sharded_ps-nesterov-win2-flat", dict(pipeline_windows=2), True),
    ("hierarchical", dict(strategy="hierarchical"), False),
    ("hierarchical-win2-flat", dict(strategy="hierarchical",
                                    pipeline_windows=2), True),
    ("allreduce", dict(strategy="allreduce"), False),
    ("centralized_ps", dict(strategy="centralized_ps"), False),
    ("int8-win2", dict(wire_format="int8", pipeline_windows=2), False),
    ("int8-hierarchical-win2", dict(strategy="hierarchical",
                                    wire_format="int8",
                                    pipeline_windows=2), True),
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def train_config(fields: dict) -> TrainConfig:
    return TrainConfig(**dict(dict(lr=0.25, momentum=0.5, adam_eps=1e-3,
                                   chunk_size_bytes=CHUNK), **fields))


def client(comm, fields: dict) -> PHubClient:
    return PHubClient(train_config(fields), comm, device="cpu").register(
        _map(lambda s: torch.empty(s, device="meta"), SHAPES))


def inputs(world: int, name: str, fields: dict):
    """(p0 tree, per step the (W, padded) pushes) of one case."""
    c = client(StackedComm(world, PODS), fields)
    (group,) = c.plan.groups
    rng = np.random.default_rng(zlib.crc32(f"{world}-{name}".encode()))
    p0 = rng.integers(-8, 9, group.padded).astype(np.float32)
    p0[group.total:] = 0
    pushes = []
    for _ in range(STEPS):
        if fields.get("wire_format") == "int8":
            g = rng.standard_normal((world, group.padded)).astype(np.float32)
        else:
            g = rng.integers(-8, 9, (world, group.padded)).astype(np.float32)
        g[:, group.total:] = 0
        pushes.append(torch.from_numpy(g))
    return c.unflatten({"float32": torch.from_numpy(p0)}), pushes


def run_case(comm, name: str, fields: dict, flat: bool, rows: slice):
    """The case's steps through ``comm``'s client, pushing ``rows`` of each
    step's pushes; returns (the flat p', the slots)."""
    c = client(comm, fields)
    p0, pushes = inputs(comm.n_workers, name, fields)
    opt = c.init_state()
    if flat:
        pstore = c.flatten(p0)
        for g in pushes:
            pstore, opt = c.push_pull_flat({"float32": g[rows].clone()},
                                           pstore, opt)
        return pstore["float32"], opt["float32"]
    params = _map(lambda t: t.clone(), p0)
    for g in pushes:
        grads = _stack([c.unflatten({"float32": g[w]})
                        for w in range(rows.start, rows.stop)])
        params, opt = c.push_pull(grads, params, opt)
    return c.flatten(params)["float32"], opt["float32"]


def _stack(trees: list) -> dict:
    return {k: (_stack([t[k] for t in trees]) if isinstance(v, dict)
                else torch.stack([t[k] for t in trees]))
            for k, v in trees[0].items()}


def _rank_cases(comm, device):
    r = comm.rank
    return {name: run_case(comm, name, fields, flat, slice(r, r + 1))
            for name, fields, flat in CASES}


@functools.lru_cache(maxsize=None)
def all_groups() -> dict:
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        runs = {w: ex.submit(dist.run, _rank_cases, w, "gloo", "cpu",
                             TIMEOUT, init_method="file://" + os.path.join(
                                 tempfile.mkdtemp(), "pg_init"),
                             threads=1, pods=PODS)
                for w in WORLDS}
        return {w: f.result() for w, f in runs.items()}


@functools.lru_cache(maxsize=None)
def stacked(world: int, name: str):
    fields, flat = next((f, fl) for n, f, fl in CASES if n == name)
    return run_case(StackedComm(world, PODS), name, fields, flat,
                    slice(0, world))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", [n for n, _, _ in CASES])
def test_gloo_client_equals_the_stacked_client(world, name):
    fields = next(f for n, f, _ in CASES if n == name)
    strategy = fields.get("strategy", "sharded_ps")
    p_s, opt_s = stacked(world, name)
    D = world // PODS
    for r, res in enumerate(all_groups()[world]):
        p2, opt2 = res[name]
        assert torch.equal(p2, p_s), f"rank {r}: p' differs"
        assert set(opt2) == set(opt_s)
        for slot, v in opt2.items():
            want = opt_s[slot]
            if strategy == "sharded_ps":
                want = want[r:r + 1]
            elif strategy == "hierarchical":
                want = want[r % D:r % D + 1]
            elif strategy == "centralized_ps" and r > 0:
                want = want[:0]
            assert v.shape == want.shape and torch.equal(v, want), \
                f"rank {r}: slot {slot} differs"
