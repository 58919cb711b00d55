"""The allreduce, centralized_ps and hierarchical strategies over gloo on the
CPU, one worker a process (``core/comm.py::ProcessGroupComm`` with
``pods``, ``launch/dist.py``), against the stacked Comm.

1. Groups of 2 and 4 processes laid out 1 x 2, 2 x 1 and 2 x 2 (pods x
   data): every strategy under Nesterov, SGD and Adam, f32 and bf16
   groups; hierarchical over the identity wire, the int8 DCN tier, the
   int8 ring inside the pods and both, in 1 and 3 windows; allreduce and
   centralized_ps at one window.  Each rank's p', its slots (the shard it
   owns: hierarchical's pod-replicated shard d, allreduce's whole vector,
   centralized_ps's on rank 0 only) and its ``wire_ef`` equal the stacked
   exchange's bitwise, except allreduce at 4 ranks, whose ``all_reduce``
   sums in the library's order: there Nesterov and SGD in f32 hold m' and
   p' within the bound one reordered sum of 4 f32 addends allows
   (``reordered_bound``), and integer-valued rows hold bitwise.  Each
   group is one spawn that runs all its cases.
2. Every rank creates the pod and cross-pod subgroups in the same order,
   and the hierarchical collectives move the bytes they should: the
   cross-pod leg carries 1/D of a row (identity) and a quarter of that
   plus the scales (int8).
3. A reduced llama3.2-1b ``fit`` at 2 x 2 (hierarchical identity and
   int8 DCN in 3 windows, centralized_ps) and at 1 x 2 (allreduce) equals
   the stacked engine's bitwise: losses and every parameter after 2
   steps.
"""
import concurrent.futures
import functools
import itertools
import os
import tempfile
import zlib

import numpy as np
import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm, chunking
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import (run_dcn_exchange, run_exchange,
                                       run_wire_exchange)
from repro_torch.core.wire import WireFormat
from repro_torch.data import SyntheticTokens
from repro_torch.launch import dist
from repro_torch.optim.protocol import make_sharded_optimizer
from repro_torch.training import TrainState, fit

CE, CPS = 128, 3                # chunk elements; chunks a shard
GROUPS = ((1, 2), (2, 1), (2, 2))            # (P pods, D ranks a pod)
RULES = ("nesterov", "sgd", "adam")
DTYPES = ("float32", "bfloat16")
TIERS = ("identity", "dcn", "int8", "int8+dcn")
LR = {"nesterov": 0.05, "sgd": 0.05, "adam": 1e-3}
MU = 0.9
TIMEOUT = 300.0
STEPS = 2
# (layout, strategy, TrainConfig fields): allreduce at two ranks, where
# the library's sum of two rows commutes
ENGINE_CASES = (((2, 2), "hierarchical", {}),
                ((2, 2), "hierarchical", dict(wire_format_dcn="int8",
                                              pipeline_windows=3,
                                              chunk_size_bytes=4096)),
                ((2, 2), "centralized_ps", {}),
                ((1, 2), "allreduce", {}))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def group_cases(P: int, D: int) -> list:
    out = []
    for rule, dt in itertools.product(RULES, DTYPES):
        for st in ("allreduce", "centralized_ps"):
            out.append((st, rule, dt, 1, "identity", False))
        for win, tier in itertools.product((1, 3), TIERS):
            out.append(("hierarchical", rule, dt, win, tier, False))
    if P * D == 4:
        for rule in ("nesterov", "sgd"):
            out.append(("allreduce", rule, "float32", 1, "identity", True))
    return out


def case_id(case) -> str:
    st, rule, dt, win, tier, ints = case
    return f"{st}-{rule}-{dt}-win{win}-{tier}" + ("-ints" if ints else "")


def plan(comm, strategy, dtype):
    S = comm.n_shards(strategy)
    tree = {"w": torch.empty(S * CPS * CE - 50, dtype=dtype)}
    (group,) = chunking.build_plan(
        tree, chunk_bytes=CE * dtype.itemsize, n_shards=S).groups
    return group


def case_inputs(P, D, case):
    """(group, g (W, padded), p, slots (padded,) each, residual) from a
    seed of the case; the residual is (P*padded,) for the DCN tier."""
    st, rule, dt, win, tier, ints = case
    rng = np.random.default_rng(zlib.crc32(repr((P, D, case)).encode()))
    dtype = getattr(torch, dt)
    group = plan(StackedComm(P * D, P), st, dtype)
    n = group.padded

    def draw(*shape, scale=1.0):
        if ints:
            return torch.from_numpy(
                rng.integers(-8, 9, shape).astype(np.float32))
        return torch.from_numpy(
            (scale * rng.standard_normal(shape)).astype(np.float32))

    g = draw(P * D, n).to(dtype)
    p = draw(n).to(dtype)
    sopt = make_sharded_optimizer(TrainConfig(optimizer=rule))
    slots = []
    for spec in sopt.slots:
        t = draw(n, scale=0.1)
        if spec.name in ("v", "k1", "k2"):
            t = t.abs() + 1e-3
        slots.append(t.to(spec.resolve_dtype(dtype)))
    rows = P if tier == "dcn" else 1
    return group, g, p, tuple(slots), draw(rows * n, scale=1e-3)


def exchange(comm, case, group, g, p, slots, residual):
    """One group's exchange as the engine dispatches it; returns (p',
    slots', wire_ef' or None)."""
    st, rule, dt, win, tier, ints = case
    tc = TrainConfig(optimizer=rule, lr=0.25 if ints else LR[rule],
                     momentum=0.5 if ints else MU, adam_eps=1e-3)
    sopt = make_sharded_optimizer(tc)
    coefs = sopt.coefs(tc)
    upd = sopt.kernel_update(group.chunk_elems, coefs)
    if tier == "identity":
        p2, s2 = run_exchange(st, comm, g, p, slots, upd, group, win)
        return p2, tuple(s2), None
    if tier == "dcn":
        p2, s2, r2 = run_dcn_exchange(st, comm, g, p, slots, upd, group,
                                      WireFormat("int8"), residual, win)
        return p2, tuple(s2), r2
    fused = sopt.kernel_dequant_update(group.chunk_elems, coefs,
                                       1.0 / comm.n_workers)
    p2, s2, r2 = run_wire_exchange(
        st, comm, g, p, slots, upd, group, WireFormat("int8"), residual,
        fused, win, wire_dcn=WireFormat("int8") if tier == "int8+dcn"
        else None)
    return p2, tuple(s2), r2


def rank_slices(comm_rank, P, D, case, n):
    """(slot slice, residual slice) of the state rank ``comm_rank`` keeps,
    or None for no slots (centralized_ps off rank 0)."""
    st, rule, dt, win, tier, ints = case
    q, d = divmod(comm_rank, D)
    if st == "allreduce":
        return slice(0, n), None
    if st == "centralized_ps":
        return (slice(0, n) if comm_rank == 0 else None), None
    L = n // D
    sh = slice(d * L, (d + 1) * L)
    if tier == "dcn":
        return sh, slice((q * D + d) * L, (q * D + d + 1) * L)
    return sh, (sh if tier != "identity" else None)


def _rank_cases(comm, device):
    torch.use_deterministic_algorithms(True)
    P, D, r = comm.pods, comm.pod_size, comm.rank
    out = {}
    for case in group_cases(P, D):
        group, g, p, slots, residual = case_inputs(P, D, case)
        sh, rsh = rank_slices(r, P, D, case, group.padded)
        mine = (tuple(s[sh].clone() for s in slots) if sh is not None
                else tuple(s[:0].clone() for s in slots))
        res = residual[rsh].clone() if rsh is not None else None
        before = comm.stats.get("cross_gather", {}).get("bytes", 0)
        out[case_id(case)] = exchange(comm, case, group, g[r:r + 1], p,
                                      mine, res)
        out["cross/" + case_id(case)] = comm.stats.get(
            "cross_gather", {}).get("bytes", 0) - before
    out["subgroups"] = list(comm.subgroups)
    out["stats"] = comm.stats
    out["engine"] = _engine_runs(comm)
    return out


def _engine_runs(comm) -> dict:
    """The reduced llama3.2-1b ``fit`` runs of ENGINE_CASES at this
    group's layout."""
    here = (comm.pods, comm.pod_size)
    return {i: _fit(comm, st, kw)
            for i, (layout, st, kw) in enumerate(ENGINE_CASES)
            if layout == here}


def _fit(comm, strategy, kw):
    cfg = reduced(get_arch("llama3.2-1b"))
    tc = TrainConfig(strategy=strategy, loss_chunk=16, **kw)
    eng = PHubEngine(cfg, tc, comm, device="cpu")
    model, opt = eng.init_state(seed=3)
    data = SyntheticTokens(cfg, 4, 16, seed=2)
    st = fit(eng, TrainState(params=model, opt=opt), data, steps=STEPS,
             log_every=0, hooks=[lambda s, m: None])
    return st.losses, [t.detach().clone()
                       for _, t in leaf_paths(model.param_tree())]


def init_file() -> str:
    return "file://" + os.path.join(tempfile.mkdtemp(), "pg_init")


@functools.lru_cache(maxsize=None)
def all_groups() -> dict:
    """Every group's ranks' results, the groups spawned side by side."""
    with concurrent.futures.ThreadPoolExecutor(len(GROUPS)) as ex:
        runs = {(P, D): ex.submit(dist.run, _rank_cases, P * D, "gloo",
                                  "cpu", TIMEOUT, init_method=init_file(),
                                  threads=1, pods=P)
                for P, D in GROUPS}
        return {k: f.result() for k, f in runs.items()}


@functools.lru_cache(maxsize=None)
def stacked_result(P, D, case):
    torch.use_deterministic_algorithms(True)
    group, g, p, slots, residual = case_inputs(P, D, case)
    return exchange(StackedComm(P * D, P), case, group, g.clone(), p,
                    tuple(s.clone() for s in slots), residual.clone())


def reordered_bound(P, D, case, p_want, s_want):
    """The elementwise bound on (p', m') of allreduce at 4 ranks: the
    library may add the 4 f32 rows in any order, so the sum moves by at
    most 3 * 2^-24 * sum|g_w| (three roundings, each at most half an ulp
    of a partial bounded by sum|g_w|) and the mean dg by that / W.  Then
    m' = mu*m + mean moves by dm = dg plus an ulp of m'; the step u = lr *
    (mean + mu*m') by lr * (dg + mu*dm) plus an ulp of u (u ~ p - p'),
    and p' by that plus an ulp of p'.  SGD: u = lr * mean."""
    st, rule, dt, win, tier, ints = case
    _, g, p, _, _ = case_inputs(P, D, case)
    ulp = lambda t: 2.0 ** -23 * t.abs()                 # noqa: E731
    dg = 3 * 2.0 ** -24 * g.abs().sum(0) / (P * D)
    lr = LR[rule]
    dm = [dg + ulp(s) for s in s_want]
    du = lr * (dg + MU * dm[0]) if rule == "nesterov" else lr * dg
    du = du + 2 * ulp(p - p_want)
    return du + ulp(p_want), dm


CASES = [((P, D), c) for P, D in GROUPS for c in group_cases(P, D)]


@pytest.mark.parametrize("layout,case", CASES,
                         ids=[f"{P}x{D}-{case_id(c)}" for (P, D), c in CASES])
def test_process_group_strategy_equals_stacked(layout, case):
    P, D = layout
    W = P * D
    p_s, slots_s, r_s = stacked_result(P, D, case)
    n = p_s.numel()
    exact = not (case[0] == "allreduce" and W > 2 and not case[5])
    for r, res in enumerate(all_groups()[layout]):
        p2, s2, r2 = res[case_id(case)]
        sh, rsh = rank_slices(r, P, D, case, n)
        assert p2.dtype == p_s.dtype
        if exact:
            assert torch.equal(p2, p_s), f"rank {r}: p' differs"
        else:
            bp, bs = reordered_bound(P, D, case, p_s, slots_s)
            assert ((p2 - p_s).abs() <= bp).all(), f"rank {r}: p' bound"
            for a, b, lim in zip(s2, slots_s, bs):
                assert ((a - b).abs() <= lim).all(), f"rank {r}: m' bound"
            continue
        if sh is None:
            assert all(t.numel() == 0 for t in s2), \
                "centralized_ps slots off the PS"
        else:
            assert len(s2) == len(slots_s)
            for i, (a, b) in enumerate(zip(s2, slots_s)):
                assert torch.equal(a.reshape(-1), b.reshape(-1)[sh]), \
                    f"rank {r}: slot {i} differs from its stacked run"
        if r_s is None:
            assert r2 is None
        else:
            assert torch.equal(r2, r_s[rsh]), f"rank {r}: wire_ef differs"


@pytest.mark.parametrize("layout", GROUPS, ids=[f"{P}x{D}" for P, D in GROUPS])
def test_subgroups_and_cross_pod_bytes(layout):
    P, D = layout
    ranks = all_groups()[layout]
    want = ([("pod", tuple(q * D + d for d in range(D))) for q in range(P)]
            + [("cross", tuple(q * D + d for q in range(P)))
               for d in range(D)]) if P > 1 else []
    for res in ranks:
        assert res["subgroups"] == want
        st = res["stats"]
        assert st["all_reduce"]["calls"] > 0 and st["gather_to"]["calls"] > 0
        assert st["broadcast_from"]["calls"] > 0
        if P > 1:
            assert st["cross_gather"]["calls"] > 0
            assert st["cross_gather"]["bytes"] > 0
        else:
            assert "cross_gather" not in st


def test_cross_pod_leg_moves_a_shard():
    """A hierarchical f32 exchange at 2 x 2, one window: each rank's
    cross-pod leg sends its (L,) f32 partial once to the other pod, L =
    padded / D; the int8 DCN tier sends the L int8 codes and L / CE f32
    scales; the int8 ring inside the pods with the DCN tier scales-only
    sends as much; allreduce and centralized_ps have no cross-pod leg."""
    n = plan(StackedComm(4, 2), "hierarchical", torch.float32).padded
    L = n // 2
    want = {"identity": 4 * L, "dcn": L + 4 * (L // CE),
            "int8": 4 * L, "int8+dcn": L + 4 * (L // CE)}
    for res in all_groups()[(2, 2)]:
        for tier, b in want.items():
            case = ("hierarchical", "sgd", "float32", 1, tier, False)
            assert res["cross/" + case_id(case)] == b, tier
        for st in ("allreduce", "centralized_ps"):
            case = (st, "sgd", "float32", 1, "identity", False)
            assert res["cross/" + case_id(case)] == 0


@functools.lru_cache(maxsize=None)
def stacked_engine(i):
    torch.use_deterministic_algorithms(True)
    (P, D), st, kw = ENGINE_CASES[i]
    return _fit(StackedComm(P * D, P), st, kw)


@pytest.mark.parametrize("i", range(len(ENGINE_CASES)),
                         ids=[f"{P}x{D}-{st}-{'-'.join(kw) or 'identity'}"
                              for (P, D), st, kw in ENGINE_CASES])
def test_reduced_llama_fit_equals_stacked(i):
    want = stacked_engine(i)
    for r, res in enumerate(all_groups()[ENGINE_CASES[i][0]]):
        losses, params = res["engine"][i]
        assert losses == want[0], f"rank {r}: losses differ"
        for a, b in zip(params, want[1]):
            assert torch.equal(a, b), f"rank {r}: parameters differ"
