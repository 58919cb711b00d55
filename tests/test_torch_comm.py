"""The port's process-group Comm (``core/comm.py::ProcessGroupComm``) over
gloo on the CPU, one worker a process (``launch/dist.py``).

1. sharded_ps over gloo groups of 1, 2, 3 and 4 processes equals the
   stacked Comm's exchange bitwise, as the engine dispatches it
   (``run_exchange`` / ``run_wire_exchange``): Nesterov, SGD and Adam, f32
   and bf16 groups, 1 and 3 windows, the identity and the int8 wire, and at
   4 processes a static 3-of-4 membership (worker 1's row zero, the mean
   over 3: a tensor divisor on the identity wire, ``1/3`` baked into the
   int8 tail).  Every rank's p' is the stacked p', its slots (and the int8
   wire's ``wire_ef``) the stacked slots' run of its shard.  Each group is
   one spawn that runs all its cases.
2. The uint32 word framing of wire payloads equals the reference's
   ``pack_words`` / ``unpack_words`` bitwise.
3. The reference's sharded_ps ``exchange_group`` under ``shard_map`` on 4
   forced host devices (a mesh with ``AxisType.Auto``, ROADMAP.md queue C)
   equals the gloo W=4 exchange bitwise on integer-valued gradients,
   parameters and momentum, at lr 0.25 and momentum 0.5 (every sum,
   product and the /4 exact, so the two frameworks' FMA contraction
   cannot differ).
4. A rank that raises before its push brings its group down: ``run``
   re-raises its error and kills the other rank, which would otherwise wait
   in the collective until the group's 300 s timeout.  An NCCL Comm
   without CUDA raises.
"""
import concurrent.futures
import functools
import itertools
import os
import subprocess
import sys
import tempfile
import time
import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig
from repro_torch.core import StackedComm, chunking
from repro_torch.core.comm import ProcessGroupComm
from repro_torch.core.pipeline import run_exchange, run_wire_exchange
from repro_torch.core.wire import WireFormat
from repro_torch.launch import dist
from repro_torch.optim.protocol import make_sharded_optimizer

CE, CPS = 128, 3                # chunk elements; chunks a shard
WORLDS = (1, 2, 3, 4)
RULES = ("nesterov", "sgd", "adam")
DTYPES = ("float32", "bfloat16")
WINDOWS = (1, 3)
WIRES = ("identity", "int8")
DEAD = 1                        # the worker a 3-of-4 membership leaves out
LR = {"nesterov": 0.05, "sgd": 0.05, "adam": 1e-3}
TIMEOUT = 300.0
REF_LR, REF_MU = 0.25, 0.5      # exact on integer-valued inputs
REF_RULES = ("nesterov", "sgd")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group_cases(world: int) -> list:
    out = []
    for rule, dt, win, wire in itertools.product(RULES, DTYPES, WINDOWS,
                                                 WIRES):
        out.append((rule, dt, win, wire, None))
        if world == 4:
            out.append((rule, dt, win, wire, DEAD))
    return out


def case_id(case) -> str:
    rule, dt, win, wire, dead = case
    return (f"{rule}-{dt}-win{win}-{wire}"
            + ("" if dead is None else f"-dead{dead}"))


def plan(world: int, dtype):
    """One group of CPS chunks a shard, the last chunk ragged."""
    tree = {"w": torch.empty(world * CPS * CE - 50, dtype=dtype)}
    (group,) = chunking.build_plan(
        tree, chunk_bytes=CE * dtype.itemsize, n_shards=world).groups
    return group


def case_inputs(world: int, case):
    """(group, g (W, padded), p, slots (padded,) each, wire_ef) from a
    seed of the case."""
    rule, dt, win, wire, dead = case
    rng = np.random.default_rng(zlib.crc32(repr((world, case)).encode()))
    dtype = getattr(torch, dt)
    group = plan(world, dtype)
    n = group.padded

    def draw(*shape, scale=1.0):
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    g = draw(world, n).to(dtype)
    if dead is not None:
        g[dead] = 0
    p = draw(n).to(dtype)
    if rule == "nesterov":
        slots = (draw(n, scale=0.1).to(dtype),)
    elif rule == "sgd":
        slots = ()
    else:
        slots = (draw(n, scale=0.1).to(dtype),
                 draw(n, scale=0.01).abs().to(dtype),
                 torch.from_numpy(rng.uniform(0.1, 0.9, n).astype(np.float32)),
                 torch.from_numpy(rng.uniform(1e-3, 0.1, n)
                                  .astype(np.float32)))
    residual = draw(n, scale=1e-3) if wire != "identity" else None
    return group, g, p, slots, residual


def exchange(comm, case, group, g, p, slots, residual):
    """One group's exchange as the engine dispatches it; returns (p',
    slots', wire_ef' or None)."""
    rule, dt, win, wire, dead = case
    tc = TrainConfig(optimizer=rule, lr=LR[rule], adam_eps=1e-3,
                     wire_format=wire)
    sopt = make_sharded_optimizer(tc)
    coefs = sopt.coefs(tc)
    upd = sopt.kernel_update(group.chunk_elems, coefs)
    W = comm.n_workers
    if wire == "identity":
        n_live = None if dead is None else torch.tensor(float(W - 1))
        p2, s2 = run_exchange("sharded_ps", comm, g, p, slots, upd, group,
                              win, n_live)
        return p2, tuple(s2), None
    n_live = None if dead is None else float(W - 1)
    fused = sopt.kernel_dequant_update(group.chunk_elems, coefs,
                                       1.0 / (n_live or W))
    p2, s2, r2 = run_wire_exchange("sharded_ps", comm, g, p, slots, upd,
                                   group, WireFormat(wire), residual, fused,
                                   win, n_live)
    return p2, tuple(s2), r2


def ref_inputs(rule: str):
    """Integer-valued g (4, padded), p and m for the reference test."""
    rng = np.random.default_rng(7 + REF_RULES.index(rule))
    n = plan(4, torch.float32).padded
    return (rng.integers(-8, 9, (4, n)).astype(np.float32),
            rng.integers(-8, 9, n).astype(np.float32),
            rng.integers(-4, 5, n).astype(np.float32))


def ref_exchange(comm, rule: str):
    """The port's exchange on ``ref_inputs(rule)`` over ``comm`` (this
    rank's row and momentum run)."""
    g, p, m = (torch.from_numpy(a) for a in ref_inputs(rule))
    tc = TrainConfig(optimizer=rule, lr=REF_LR, momentum=REF_MU)
    sopt = make_sharded_optimizer(tc)
    group = plan(4, torch.float32)
    upd = sopt.kernel_update(group.chunk_elems, sopt.coefs(tc))
    L = group.shard_len
    r, k = comm.rank, comm.local_workers()
    slots = (m[r * L:(r + k) * L].clone(),) if rule == "nesterov" else ()
    p2, s2 = run_exchange("sharded_ps", comm, g[r:r + k], p, slots, upd,
                          group, 1)
    return p2, (s2[0] if s2 else None)


def _rank_cases(comm, device):
    """Every case of this group on this rank: its row, its shard's slots."""
    torch.use_deterministic_algorithms(True)
    W, r = comm.n_workers, comm.rank
    out = {}
    for case in group_cases(W):
        group, g, p, slots, residual = case_inputs(W, case)
        L = group.shard_len
        sh = slice(r * L, (r + 1) * L)
        p2, s2, r2 = exchange(comm, case, group, g[r:r + 1], p,
                              tuple(s[sh].clone() for s in slots),
                              None if residual is None else residual[sh])
        out[case_id(case)] = (p2, s2, r2)
    if W == 4:
        for rule in REF_RULES:
            out[f"ref-{rule}"] = ref_exchange(comm, rule)
    out["gathered"] = comm.gather_small(torch.tensor([float(r), -1.0]))
    out["stats"] = comm.stats
    return out


def init_file() -> str:
    return "file://" + os.path.join(tempfile.mkdtemp(), "pg_init")


@functools.lru_cache(maxsize=None)
def all_groups() -> dict:
    """Every group's ranks' results, the groups spawned side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as ex:
        runs = {w: ex.submit(dist.run, _rank_cases, w, "gloo", "cpu",
                             TIMEOUT, init_method=init_file(), threads=1)
                for w in WORLDS}
        return {w: f.result() for w, f in runs.items()}


def group_results(world: int) -> list:
    return all_groups()[world]


@functools.lru_cache(maxsize=None)
def stacked_result(world: int, case):
    group, g, p, slots, residual = case_inputs(world, case)
    return exchange(StackedComm(world), case, group, g, p, slots, residual)


CASES = [(w, c) for w in WORLDS for c in group_cases(w)]


@pytest.mark.parametrize("world,case", CASES,
                         ids=[f"W{w}-{case_id(c)}" for w, c in CASES])
def test_process_group_exchange_equals_stacked(world, case):
    p_s, slots_s, r_s = stacked_result(world, case)
    L = p_s.numel() // world
    for r, res in enumerate(group_results(world)):
        p2, s2, r2 = res[case_id(case)]
        sh = slice(r * L, (r + 1) * L)
        assert p2.dtype == p_s.dtype and torch.equal(p2, p_s), \
            f"rank {r}: p' differs from the stacked exchange's"
        assert len(s2) == len(slots_s)
        for i, (a, b) in enumerate(zip(s2, slots_s)):
            assert torch.equal(a.reshape(-1), b.reshape(-1)[sh]), \
                f"rank {r}: slot {i} differs from the stacked run of its shard"
        if r_s is None:
            assert r2 is None
        else:
            assert torch.equal(r2, r_s[sh]), f"rank {r}: wire_ef differs"


@pytest.mark.parametrize("world", WORLDS)
def test_gather_small_and_byte_counts(world):
    """gather_small stacks the ranks' values in rank order; the push moves
    (W-1)/W of a row off each rank, the pull (W-1) shards."""
    for r, res in enumerate(group_results(world)):
        want = torch.tensor([[float(q), -1.0] for q in range(world)])
        assert torch.equal(res["gathered"], want)
        st = res["stats"]
        assert st["push"]["calls"] > 0 and st["pull"]["calls"] > 0
        if world == 1:
            assert st["push"]["bytes"] == 0 and st["pull"]["bytes"] == 0
            assert "ring_hop" not in st
        else:
            assert st["ring_hop"]["calls"] > 0


@pytest.mark.parametrize("name", ["int8", "bf16", "f16", "identity"])
def test_pack_words_matches_reference(name):
    import jax.numpy as jnp
    from repro.core.wire import WireFormat as JaxWire

    rng = np.random.default_rng(3)
    n = 4 * CE
    if name == "int8":
        q = rng.integers(-127, 128, n).astype(np.int8)
        parts_np = (q, rng.random(4).astype(np.float32))
        parts_t = tuple(torch.from_numpy(a.copy()) for a in parts_np)
        parts_j = tuple(jnp.asarray(a) for a in parts_np)
    elif name == "identity":
        x = rng.standard_normal(n).astype(np.float32)
        parts_t, parts_j = (torch.from_numpy(x.copy()),), (jnp.asarray(x),)
    else:
        jdt = jnp.bfloat16 if name == "bf16" else jnp.float16
        tdt = torch.bfloat16 if name == "bf16" else torch.float16
        xj = jnp.asarray(rng.standard_normal(n).astype(np.float32)).astype(jdt)
        bits = np.asarray(xj).view(np.uint16)
        parts_t = (torch.from_numpy(bits.view(np.int16).copy()).view(tdt),)
        parts_j = (xj,)
    words_j = JaxWire(name).pack_words(parts_j)
    words_t = WireFormat(name).pack_words(parts_t)
    assert len(words_j) == len(words_t)
    for a, b in zip(words_j, words_t):
        a = np.asarray(a)
        assert (a.dtype == np.uint32) == (b.dtype == torch.uint32)
        b = (b.view(torch.int32) if b.dtype == torch.uint32 else b).numpy()
        assert a.shape == b.shape and a.tobytes() == b.tobytes()
    back = WireFormat(name).unpack_words(words_t)
    for a, b in zip(back, parts_t):
        assert a.dtype == b.dtype and torch.equal(a, b)


_REF_SCRIPT = r"""
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro.core.exchange import ExchangeContext, exchange_group, flat_rank
from repro.optim.protocol import NesterovOptimizer, SGDOptimizer, tuple_update
from repro.utils import compat

src, dst, rule, lr, mu = sys.argv[1:6]
d = np.load(src)
W = d["g"].shape[0]
assert len(jax.devices()) == W
mesh = jax.make_mesh((W,), ("data",),
                     axis_types=(jax.sharding.AxisType.Auto,))
ctx = ExchangeContext(data_axes=("data",), axis_sizes={"data": W})
opt, coefs = ((NesterovOptimizer(), (float(lr), float(mu)))
              if rule == "nesterov" else (SGDOptimizer(), (float(lr),)))
upd = tuple_update(opt, coefs)


def body(g, p, m):
    rank = flat_rank(("data",), {"data": W})
    slots = (m,) if opt.slots else ()
    p2, s2 = exchange_group("sharded_ps", ctx, g.reshape(-1), p, slots,
                            upd, rank)
    return p2, (s2[0] if s2 else m)


f = jax.jit(compat.shard_map(body, mesh=mesh,
                             in_specs=(P("data"), P(), P("data")),
                             out_specs=(P(), P("data")),
                             axis_names={"data"}))
with compat.set_mesh(mesh):
    p2, m2 = f(jnp.asarray(d["g"]), jnp.asarray(d["p"]), jnp.asarray(d["m"]))
np.savez(dst, p=np.asarray(p2), m=np.asarray(m2))
"""


@pytest.mark.parametrize("rule", REF_RULES)
def test_reference_exchange_equals_gloo_w4(rule, tmp_path):
    g, p, m = ref_inputs(rule)
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, g=g, p=p, m=m)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(src),
                          str(dst), rule, str(REF_LR), str(REF_MU)],
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    want = np.load(dst)
    assert not np.array_equal(want["p"], p), "the reference did not update"
    L = p.size // 4
    for r, res in enumerate(group_results(4)):
        p2, m2 = res[f"ref-{rule}"]
        assert p2.numpy().tobytes() == want["p"].tobytes(), \
            f"rank {r}: p' differs from the reference's"
        if rule == "nesterov":
            assert (m2.numpy().tobytes()
                    == want["m"][r * L:(r + 1) * L].tobytes()), \
                f"rank {r}: m' differs from the reference's shard"


def _raise_before_push(comm, device):
    if comm.rank == 1:
        raise ValueError("rank 1 fails before its push")
    comm.push(torch.ones(comm.n_workers, 4))
    return "rank 0 got past the push"


def test_failed_rank_brings_group_down():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails before its push"):
        dist.run(_raise_before_push, 2, "gloo", "cpu", TIMEOUT,
                 init_method=init_file(), threads=1)
    # rank 0 waits in the push until the group's timeout unless killed
    assert time.monotonic() - t0 < 60


def test_nccl_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
        ProcessGroupComm(0, 1, "nccl", init_file(), timeout=10)
