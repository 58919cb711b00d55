"""The port's allreduce, centralized_ps and hierarchical strategies inside
the port, on the stacked Comm (reduced llama3.2-1b, W=4; the reference's
oracles are ``tests/test_torch_strategies.py``):

1. allreduce and centralized_ps equal the sharded_ps step bitwise (every
   rule; compared unflattened: the padding differs); hierarchical at one
   pod, and at P pods of one worker, equals sharded_ps in an f32 group;
   2 x 2 stays within 1e-4 of the step's largest change after one step.
2. Every tier (identity, the int8 DCN tier, the int8 ring inside the
   pods, both) at 2 x 2 and 2 x 1: windowed, chunk-ready and
   flat-resident steps equal the monolithic step bitwise (losses,
   parameters, every slot).
3. A static 3-of-4 membership and the sanity gate with worker 1 poisoned
   run the same step, bitwise, on every strategy and tier; the supervisor
   demotes a repeat offender under hierarchical as under sharded_ps.
4. A checkpoint of a DCN-tier run keeps all P residual rows and continues
   bitwise; the refusals; the launcher takes ``--pods`` and
   ``--wire-format-dcn``.
"""
import functools

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_train_state, save_checkpoint
from repro_torch.checkpoint.checkpointer import snapshot_tree
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import pod_rows_
from repro_torch.core.wire import WIRE_EF_SLOT
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import (FaultEvent, FaultSchedule, Membership,
                                  NAN_PUSH)
from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                    TrainSupervisor)
from repro_torch.training import TrainState, fit

BASELINES = ("allreduce", "centralized_ps")
RULES = ("nesterov", "sgd", "adam")
LR = {"nesterov": 0.05, "sgd": 0.05, "adam": 1e-3}
ADAM_EPS = 1e-3
DEAD = 1                        # the worker a 3-of-4 membership leaves out


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """The CPU embedding backward sums its rows in parallel, in an order
    that changes from run to run; deterministic mode fixes it."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _cfg():
    return reduced(get_arch("llama3.2-1b"))


def _train(strategy="sharded_ps", W=4, pods=1, steps=2, membership=None,
           sanity=False, seed=7, **kw):
    """(losses, params, opt) of ``steps`` reduced-llama steps."""
    cfg = _cfg()
    tc = TrainConfig(strategy=strategy, loss_chunk=16, **kw)
    eng = PHubEngine(cfg, tc, StackedComm(W, pods), device="cpu")
    model, opt = eng.init_state(seed=seed)
    data = SyntheticTokens(cfg, 4, 16, seed=2)
    if membership is None and not sanity:
        st = fit(eng, TrainState(params=model, opt=opt), data, steps=steps,
                 log_every=0, hooks=[lambda s, m: None])
        return st.losses, _params(model), st.opt
    step = eng.make_train_step(
        membership=membership,
        sanity=SanityConfig(allow_injection=True) if sanity else None)
    losses, metrics = [], None
    for i in range(steps):
        batch = data.torch_batch(i, "cpu")
        if sanity:
            inject = np.ones(W, np.float32)
            inject[DEAD] = np.nan
            model, opt, metrics = step(model, opt, batch,
                                       {"norm_hi": 1e6, "inject": inject})
        else:
            model, opt, metrics = step(model, opt, batch)
        losses.append(float(metrics["loss"]))
    return losses, _params(model), opt


@functools.lru_cache(maxsize=None)
def _sharded_ps(rule: str, flat: bool = False, steps: int = 2):
    """The sharded_ps step the other strategies are held against (one run
    a rule, residency and step count, shared by the tests)."""
    torch.use_deterministic_algorithms(True)
    try:
        return _train("sharded_ps", optimizer=rule, lr=LR[rule],
                      adam_eps=ADAM_EPS, flat_residency=flat, steps=steps)
    finally:
        torch.use_deterministic_algorithms(False)


def _params(model):
    return [t.detach().clone() for _, t in leaf_paths(model.param_tree())]


def _same(a, b) -> bool:
    return (a[0] == b[0] and len(a[1]) == len(b[1])
            and all(torch.equal(x, y) for x, y in zip(a[1], b[1])))


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("strategy", BASELINES)
def test_baselines_equal_sharded_ps_step(strategy, rule, flat, deterministic):
    kw = dict(optimizer=rule, lr=LR[rule], adam_eps=ADAM_EPS,
              flat_residency=flat)
    assert _same(_train(strategy, **kw), _sharded_ps(rule, flat))


@pytest.mark.parametrize("rule", RULES)
def test_hierarchical_steps(rule, deterministic):
    """One pod equals sharded_ps (an f32 group: the in-pod adds run in the
    kernel's worker order); P pods of one worker too (no in-pod adds, the
    kernel sums the rows).  2 x 2 groups the four f32 addends differently,
    which moves the mean gradient by a few ulps: after one step its
    parameter change stays within 1e-4 of the largest change of the
    sharded_ps step (the rules are Lipschitz in g), and differs."""
    kw = dict(optimizer=rule, lr=LR[rule], adam_eps=ADAM_EPS)
    base = _sharded_ps(rule)
    assert _same(_train("hierarchical", pods=1, **kw), base)
    assert _same(_train("hierarchical", pods=4, **kw), base)
    p0 = _sharded_ps(rule, steps=0)[1]
    one = _sharded_ps(rule, steps=1)[1]
    two = _train("hierarchical", pods=2, steps=1, **kw)[1]
    step = max((a - b).abs().max().item() for a, b in zip(one, p0))
    err = max((a - b).abs().max().item() for a, b in zip(two, one))
    assert 0 < err <= 1e-4 * step, (err, step)


TIERS = {"identity": {}, "dcn": dict(wire_format_dcn="int8"),
         "int8": dict(wire_format="int8"),
         "int8+dcn": dict(wire_format="int8", wire_format_dcn="int8")}
MODES = {"windows": dict(pipeline_windows=3),
         "chunk-ready": dict(pipeline_windows=3, overlap_backward=True),
         "flat": dict(flat_residency=True),
         "windows+chunk-ready+flat": dict(pipeline_windows=3,
                                          overlap_backward=True,
                                          flat_residency=True)}
POD_LAYOUTS = ((2, 2), (2, 1))


@pytest.mark.parametrize("P,D", POD_LAYOUTS)
@pytest.mark.parametrize("tier", list(TIERS))
def test_pipeline_modes_equal_monolithic(tier, P, D, deterministic):
    kw = dict(TIERS[tier], chunk_size_bytes=4096)
    mono = _train("hierarchical", W=P * D, pods=P, **kw)
    for mode, extra in MODES.items():
        got = _train("hierarchical", W=P * D, pods=P, **kw, **extra)
        assert _same(got, mono), f"{tier} {mode} differs from monolithic"
        for key, slots in got[2].items():
            for name, v in slots.items():
                assert torch.equal(v, mono[2][key][name]), (mode, name)


GATED = [(st, "identity") for st in BASELINES] + [
    ("hierarchical", t) for t in ("identity", "dcn", "int8", "int8+dcn")]


@pytest.mark.parametrize("strategy,tier", GATED,
                         ids=[f"{s}-{t}" for s, t in GATED])
def test_membership_and_gate_equal(strategy, tier, deterministic):
    """A static 3-of-4 membership and the sanity gate with worker 1
    poisoned run the same step: bitwise equal, worker 1's push adding
    exactly zero to the in-pod and cross-pod sums."""
    kw = dict(TIERS[tier], chunk_size_bytes=4096)
    dead = Membership.full(4).leave(DEAD)
    a = _train(strategy, pods=2, membership=dead, **kw)
    b = _train(strategy, pods=2, sanity=True, **kw)
    assert _same(a, b)
    full = _train(strategy, pods=2, **kw)
    assert not _same(a, full)


@pytest.mark.parametrize("tier", ["identity", "dcn"])
def test_supervisor_demotes_under_hierarchical(tier):
    """The supervised ``fit`` over 2 pods x 2: worker 1 NaN-poisoned at
    steps 1 and 2 is masked, then demoted (demote_after 2), and step 3
    runs the static 3-of-4 program, as under sharded_ps."""
    cfg = _cfg()
    tc = TrainConfig(strategy="hierarchical", loss_chunk=16,
                     chunk_size_bytes=4096, **TIERS[tier])
    eng = PHubEngine(cfg, tc, StackedComm(4, 2), device="cpu")
    model, opt = eng.init_state(seed=2)
    sup = TrainSupervisor(
        eng, SupervisorConfig(sanity=SanityConfig(allow_injection=True),
                              demote_after=2),
        faults=FaultSchedule([FaultEvent(1, NAN_PUSH, DEAD, duration=2)],
                             world=4), log_fn=None)
    seen = []
    state = fit(eng, TrainState(params=model, opt=opt),
                SyntheticTokens(cfg, 4, 16, seed=3), steps=4, log_every=0,
                supervisor=sup, hooks=[lambda s, h: seen.append(h)])
    assert [h["ok_mask"].tolist() for h in seen] == \
        [[1, 1, 1, 1], [1, 0, 1, 1], [1, 0, 1, 1], [1, 0, 1, 1]]
    assert [(e["step"], e["worker"]) for e in
            sup.incident_history("demote")] == [(2, DEAD)]
    assert sup.membership.live_ranks == (0, 2, 3)
    assert state.step == 4 and np.isfinite(state.losses).all()


def test_dcn_checkpoint_keeps_every_pod_residual(tmp_path, deterministic):
    """A DCN-tier run's snapshot holds wire_ef as P rows a shard
    (pod-major), and a restore continues bitwise."""
    kw = dict(wire_format_dcn="int8", chunk_size_bytes=4096)
    cfg = _cfg()
    tc = TrainConfig(strategy="hierarchical", loss_chunk=16, **kw)
    eng = PHubEngine(cfg, tc, StackedComm(4, 2), device="cpu")
    assert eng.exchange_slots[-1].name == WIRE_EF_SLOT
    model, opt = eng.init_state(seed=7)
    (g,) = eng.chunk_plan.groups
    assert tuple(opt[g.key][WIRE_EF_SLOT].shape) == (4, g.shard_len)
    assert tuple(opt[g.key]["m"].shape) == (2, g.shard_len)
    data = SyntheticTokens(cfg, 4, 16, seed=2)
    step = eng.make_train_step()
    model, opt, _ = step(model, opt, data.torch_batch(0, "cpu"))
    ef = opt[g.key][WIRE_EF_SLOT].view(2, -1)
    assert not torch.equal(ef[0], ef[1]), "the pods' residuals coincide"
    save_checkpoint(str(tmp_path), 1, snapshot_tree(model, opt))
    _, model2, opt2 = restore_train_state(str(tmp_path), eng)
    for key in opt:
        for name in opt[key]:
            assert torch.equal(opt2[key][name], opt[key][name])
    model, opt, m1 = step(model, opt, data.torch_batch(1, "cpu"))
    model2, opt2, m2 = step(model2, opt2, data.torch_batch(1, "cpu"))
    assert float(m1["loss"]) == float(m2["loss"])
    assert all(torch.equal(a, b) for a, b in zip(_params(model),
                                                 _params(model2)))


def test_pod_rows_add_in_data_order():
    g = torch.arange(4 * 2 * 6, dtype=torch.float32).view(4, 12)
    want = g.view(2, 2, 12).sum(1)
    rows = pod_rows_(g.clone(), 2)
    assert torch.equal(rows, want) and rows.stride(0) == 24
    # a window's strips only: window 1 of 3 of each of the D = 2 shards
    h = g.clone()
    rows = pod_rows_(h, 2, 3, 1)
    for j in range(2):
        cols = slice(j * 6 + 2, j * 6 + 4)
        assert torch.equal(rows[:, cols], want[:, cols])
        other = slice(j * 6, j * 6 + 2)
        assert torch.equal(h[0::2, other], g[0::2, other])


def test_strategy_and_layout_refusals():
    cfg = _cfg()
    with pytest.raises(ValueError, match="flat_residency requires a "
                                         "chunk-domain strategy"):
        PHubEngine(cfg, TrainConfig(strategy="fsdp_stream",
                                    flat_residency=True), StackedComm(2),
                   device="cpu")
    with pytest.raises(ValueError, match="hierarchical"):
        PHubEngine(cfg, TrainConfig(wire_format_dcn="int8"),
                   StackedComm(4, 2), device="cpu")
    with pytest.raises(ValueError, match="shard dimension"):
        PHubEngine(cfg, TrainConfig(strategy="allreduce",
                                    wire_format="int8"), StackedComm(2),
                   device="cpu")
    with pytest.raises(ValueError, match="pods"):
        StackedComm(4, 3)
    for st, want in (("sharded_ps", 4), ("hierarchical", 2),
                     ("allreduce", 1), ("centralized_ps", 1)):
        assert StackedComm(4, 2).n_shards(st) == want
    # an identity DCN tier is no tier
    eng = PHubEngine(cfg, TrainConfig(strategy="hierarchical",
                                      wire_format_dcn="identity"),
                     StackedComm(4, 2), device="cpu")
    assert eng.wire_dcn is None and eng.exchange_slots[-1].name == "m"


def test_launcher_runs_the_strategies_on_cpu():
    from repro_torch.launch.train import main
    for argv in (["--workers", "4", "--pods", "2", "--strategy",
                  "hierarchical", "--wire-format-dcn", "int8"],
                 ["--workers", "2", "--strategy", "allreduce"],
                 ["--workers", "2", "--strategy", "centralized_ps"]):
        losses = main(["--reduced", "--device", "cpu", "--steps", "2",
                       "--batch", "4", "--seq", "16"] + argv)
        assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(ValueError, match="pods"):
        main(["--reduced", "--device", "cpu", "--workers", "4", "--pods",
              "3", "--strategy", "hierarchical"])
