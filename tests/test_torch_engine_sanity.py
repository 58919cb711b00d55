"""The port's sanity-gated and k-of-n train steps against the JAX package's.

1. W=1: the port's gated step against the JAX engine's ``sane_step`` on a
   (1, 1) mesh, from the same weights, for a clean step and then a
   NaN-poisoned one.  The JAX engine runs its jnp scan
   (``use_pallas=False``, as tests/test_resilience.py does): with this
   JAX the interpret-mode Pallas health kernel inside the engine's
   shard_map raises a ShardingTypeError (a reference behaviour,
   ROADMAP.md queue C); tests/test_torch_health.py holds the port's scan
   against that kernel outside the engine.
2. W=4 stacked, worker 1 NaN-poisoned through the gate and, separately,
   worker 1 dead in a static membership: two steps each against the
   data-parallel oracle over the three live workers' batch slices (their
   gradients summed in worker order and divided by 3, then the kernel-form
   rule), under Nesterov, SGD and Adam.  The loss stays the mean over all
   four workers, as the reference's ``pmean``.
3. The gated step with worker 1 poisoned equals the static step with
   worker 1 dead bitwise; a clean step after a poisoned one is healthy
   again; the supervised ``fit`` demotes after ``demote_after`` bad pushes
   and rolls back past a corrupt snapshot on divergence.

Stated bounds: ``ok_mask`` and ``n_live`` exact; ``grad_norms`` to rtol
1e-5 (the reference scans leaf by leaf, the port the flat domain, in
another order); losses to rtol 1e-5; parameters to 1e-6 absolute and the
slots to the relative bounds of tests/test_torch_engine.py and
tests/test_torch_engine_optim.py, for the reasons given there (f32
activations: the two sides differ in the order f32 products and sums are
taken).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro.data import SyntheticTokens as JaxTokens
from repro.kernels.agg_opt.ref import (adam_opt_ref as jax_adam_ref,
                                       sgd_opt_ref as jax_sgd_ref)
from repro.models import (chunked_cross_entropy as jax_ce, forward,
                          init as jax_init, lm_head_weight)
from repro.optim.protocol import NesterovOptimizer, tree_update
from repro.resilience import SanityConfig as JaxSanityConfig
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths, unflatten_groups
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import (CKPT_CORRUPT, FaultEvent, FaultSchedule,
                                 Membership, NAN_PUSH)
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                    TrainSupervisor)
from repro_torch.training import TrainState, fit

T, LOSS_CHUNK, W4 = 32, 16, 4
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-5, 1e-6
LR = {"nesterov": 0.05, "sgd": 1e-4, "adam": 1e-4}
ADAM_EPS = 1e-3
SLOT_REL = {"m": 1e-4, "v": 2e-4, "k1": 0.0, "k2": 0.0}
INF = np.float32(np.inf)


def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype="float32")
    return jcfg, pcfg


def _tc(rule, **kw):
    kw = dict(optimizer=rule, lr=LR[rule], loss_chunk=LOSS_CHUNK, **kw)
    if rule == "adam":
        kw["adam_eps"] = ADAM_EPS
    return TrainConfig(**kw)


def _health(norm_hi, inject):
    return {"norm_hi": np.float32(norm_hi),
            "inject": np.asarray(inject, np.float32)}


def _assert_trees_close(port_tree, ref_tree, *, atol=None, rel=None):
    ref = dict(leaf_paths(ref_tree))
    got = dict(leaf_paths(port_tree))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        r = np.asarray(ref[path], np.float32)
        err = np.abs(t.detach().numpy() - r).max()
        tol = atol if atol is not None else rel * np.abs(r).max()
        assert err <= tol, (path, err, tol)


# ------------------------------------------------------------- W = 1

def test_w1_gated_step_matches_jax_sane_step():
    jcfg, pcfg = _cfgs()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(lr=0.05,
                                                 loss_chunk=LOSS_CHUNK),
                     mesh=mesh)
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    init = jax.device_get(params)
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(
        shapes, sanity=JaxSanityConfig(allow_injection=True))

    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(1), device="cpu")
    model = params_from_numpy(pcfg, init, device="cpu")
    popt = peng.init_opt()
    pstep = peng.make_train_step(sanity=SanityConfig(allow_injection=True))
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)

    reset_launches()
    for i, inject in enumerate((1.0, np.nan)):
        h = _health(INF, [inject])
        params, opt, jm = jstep(params, opt, jdata.device_batch(i), h)
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"), h)
        assert pm["ok_mask"].tolist() == np.asarray(jm["ok_mask"]).tolist()
        assert float(pm["n_live"]) == float(jm["n_live"]) == 1.0
        np.testing.assert_allclose(pm["grad_norms"].numpy(),
                                   np.asarray(jm["grad_norms"]),
                                   rtol=NORM_RTOL)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    assert pm["ok_mask"].tolist() == [0.0]
    assert np.isnan(pm["grad_norms"].numpy()).all()
    assert all(c == 0 for c in LAUNCHES.values())      # CPU: plain versions
    _assert_trees_close(model.param_tree(), jax.device_get(params),
                        atol=PARAM_ATOL)


def test_w1_norm_threshold_masks_like_the_reference():
    """A ceiling between the clean norm and the blown-up one: the verdict
    agrees, and a masked W=1 push still divides by max(0, 1) = 1."""
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(1), device="cpu")
    model, popt = peng.init_state(seed=3)
    step = peng.make_train_step(sanity=SanityConfig(allow_injection=True))
    data = SyntheticTokens(pcfg, 4, T, seed=5)
    _, popt, m = step(model, popt, data.torch_batch(0, "cpu"),
                      _health(INF, [1.0]))
    clean = float(m["grad_norms"][0])
    hi = np.float32(clean * 100)
    _, popt, m = step(model, popt, data.torch_batch(1, "cpu"),
                      _health(hi, [1000.0]))
    assert m["ok_mask"].tolist() == [0.0] and float(m["n_live"]) == 1.0
    _, popt, m = step(model, popt, data.torch_batch(2, "cpu"),
                      _health(hi, [2.0]))
    assert m["ok_mask"].tolist() == [1.0]


# ------------------------------------------------------------- W = 4

def _worker_loss(jcfg, p, tokens, labels):
    x = forward(jcfg, p, tokens, remat=False)["x"]
    return jax_ce(x, lm_head_weight(jcfg, p), labels, chunk=LOSS_CHUNK)


def _oracle_rule(rule, p, g, slots):
    """The kernel-form rule on one leaf."""
    if rule == "nesterov":
        return None
    if rule == "sgd":
        return jax_sgd_ref(p, g, lr=LR[rule]), {}
    p2, *new = jax_adam_ref(p, g, slots["m"], slots["v"], slots["k1"],
                            slots["k2"], lr=LR[rule], eps=ADAM_EPS)
    return p2, dict(zip(("m", "v", "k1", "k2"), new))


LIVE = (0, 2, 3)


@pytest.fixture(scope="module", params=["nesterov", "sgd", "adam"])
def live_oracle(request):
    """Two data-parallel oracle steps over workers 0, 2, 3 (worker 1's
    push excluded, the mean over the 3 live pushes; the loss over all 4)
    from PRNGKey(1) weights."""
    rule = request.param
    jcfg, pcfg = _cfgs()
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    init = jax.device_get(params)
    names = {"nesterov": ("m",), "sgd": (),
             "adam": ("m", "v", "k1", "k2")}[rule]
    slots = {n: jax.tree.map(jnp.zeros_like, params) for n in names}
    vg = jax.jit(jax.value_and_grad(
        lambda p, tok, lab: _worker_loss(jcfg, p, tok, lab)))
    data = SyntheticTokens(pcfg, 8, T, seed=4)
    bs = 8 // W4
    losses = []
    for i in range(2):
        batch = data.batch_at(i)
        step_losses, gsum = [], None
        for w in range(W4):
            sl = slice(w * bs, (w + 1) * bs)
            loss, g = vg(params, jnp.asarray(batch["tokens"][sl]),
                         jnp.asarray(batch["labels"][sl]))
            step_losses.append(float(loss))
            if w in LIVE:
                gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        gmean = jax.tree.map(lambda a: a / len(LIVE), gsum)
        if rule == "nesterov":
            params, st = tree_update(NesterovOptimizer(), (LR[rule], 0.9),
                                     params, gmean, {"m": slots["m"]})
            slots = {"m": st["m"]}
        else:
            flat_p, tdef = jax.tree.flatten(params)
            flat_g = tdef.flatten_up_to(gmean)
            flat_s = {n: tdef.flatten_up_to(slots[n]) for n in names}
            new_p, new_s = [], {n: [] for n in names}
            for j, (p, g) in enumerate(zip(flat_p, flat_g)):
                p2, s2 = _oracle_rule(rule, p, g,
                                      {n: flat_s[n][j] for n in names})
                new_p.append(p2)
                for n in names:
                    new_s[n].append(s2[n])
            params = tdef.unflatten(new_p)
            slots = {n: tdef.unflatten(new_s[n]) for n in names}
        losses.append(float(np.mean(step_losses)))
    return (rule, init, data, jax.device_get(params),
            jax.device_get(slots), losses)


def _run_w4(rule, init, data, mode):
    """Two port steps at W=4 with worker 1 excluded: ``gated`` (NaN
    injected, the sanity gate masks it) or ``dead`` (static membership)."""
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc(rule), StackedComm(W4), device="cpu")
    model = params_from_numpy(pcfg, init, device="cpu")
    popt = peng.init_opt()
    if mode == "gated":
        step = peng.make_train_step(sanity=SanityConfig(allow_injection=True))
        extra = (_health(INF, [1, np.nan, 1, 1]),)
    else:
        step = peng.make_train_step(
            membership=Membership.full(W4).leave(1))
        extra = ()
    metrics = []
    for i in range(2):
        model, popt, m = step(model, popt, data.torch_batch(i, "cpu"),
                              *extra)
        metrics.append(m)
    return peng, model, popt, metrics


@pytest.mark.parametrize("mode", ["gated", "dead"])
def test_w4_excluded_worker_matches_live_oracle(live_oracle, mode):
    rule, init, data, ref_params, ref_slots, ref_losses = live_oracle
    peng, model, popt, metrics = _run_w4(rule, init, data, mode)
    for m, ref_loss in zip(metrics, ref_losses):
        np.testing.assert_allclose(float(m["loss"]), ref_loss,
                                   rtol=LOSS_RTOL)
        if mode == "gated":
            assert m["ok_mask"].tolist() == [1.0, 0.0, 1.0, 1.0]
            assert float(m["n_live"]) == 3.0
            norms = m["grad_norms"].numpy()
            assert np.isnan(norms[1]) and np.isfinite(norms[LIVE,]).all()
    _assert_trees_close(model.param_tree(), ref_params, atol=PARAM_ATOL)
    (group,) = peng.chunk_plan.groups
    for name, t in popt["float32"].items():
        tree = unflatten_groups(peng.chunk_plan, {"float32": t.reshape(-1)},
                                model.param_tree())
        rel = {"nesterov": {"m": 1e-4}}.get(rule, SLOT_REL)[name]
        _assert_trees_close(tree, ref_slots[name],
                            **({"rel": rel} if rel else {"atol": 0.0}))
        assert not t.reshape(-1)[group.total:].any()


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small steps, and with the
    default (one thread a core) next to other test processes the threads'
    barriers spin against each other, many times slower; the results do
    not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """PyTorch's CPU backward of the embedding lookup accumulates rows in
    parallel, in an order that changes from run to run; deterministic
    mode fixes it, so two runs of one step are comparable bitwise."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
def test_gated_poisoned_equals_static_dead_bitwise(rule, deterministic):
    """The gate and the k-of-n mask run one code path with one divisor:
    worker 1 poisoned under the gate equals worker 1 dead, bit for bit."""
    _, pcfg = _cfgs()
    data = SyntheticTokens(pcfg, 8, T, seed=6)
    runs = []
    for mode in ("gated", "dead"):
        peng = PHubEngine(pcfg, _tc(rule), StackedComm(W4), device="cpu")
        model, popt = peng.init_state(seed=7)
        if mode == "gated":
            step = peng.make_train_step(
                sanity=SanityConfig(allow_injection=True))
            extra = (_health(INF, [1, np.nan, 1, 1]),)
        else:
            step = peng.make_train_step(
                membership=Membership.full(W4).leave(1))
            extra = ()
        for i in range(2):
            model, popt, _ = step(model, popt, data.torch_batch(i, "cpu"),
                                  *extra)
        runs.append((model, popt))
    (ma, oa), (mb, ob) = runs
    for (_, a), (_, b) in zip(leaf_paths(ma.param_tree()),
                              leaf_paths(mb.param_tree())):
        assert torch.equal(a, b)
    for name in oa["float32"]:
        assert torch.equal(oa["float32"][name], ob["float32"][name])


def test_clean_step_after_a_poisoned_one_is_healthy():
    """The gradient buffer is reused: a NaN injection poisons a row's pad
    tail too, and the next clean step must judge that worker healthy."""
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(W4), device="cpu")
    model, popt = peng.init_state(seed=1)
    step = peng.make_train_step(sanity=SanityConfig(allow_injection=True))
    data = SyntheticTokens(pcfg, 8, T, seed=1)
    _, popt, m = step(model, popt, data.torch_batch(0, "cpu"),
                      _health(INF, [1, np.nan, 1, 1]))
    assert m["ok_mask"].tolist() == [1, 0, 1, 1]
    (gbuf,) = peng.grad_buffers().values()
    assert not gbuf[1].any()                    # zeroed where-semantics
    _, popt, m = step(model, popt, data.torch_batch(1, "cpu"),
                      _health(INF, [1, 1, 1, 1]))
    assert m["ok_mask"].tolist() == [1, 1, 1, 1]
    assert float(m["n_live"]) == 4.0
    assert np.isfinite(m["grad_norms"].numpy()).all()


def test_gated_step_shares_one_gradient_buffer_and_rejects_the_int8_wire():
    """The steps of one engine share its gradient buffer; over the int8
    wire the gate and a k-of-n membership are no longer refused (their
    arithmetic is held in tests/test_torch_wire_pipeline.py): a poisoned
    worker is masked there too.  A membership of another world still
    raises."""
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(2), device="cpu")
    peng.make_train_step()
    buf = peng.grad_buffers()
    peng.make_train_step(sanity=SanityConfig())
    peng.make_train_step(membership=Membership.full(2).leave(0))
    assert peng.grad_buffers() is buf
    wire = PHubEngine(pcfg, _tc("nesterov", wire_format="int8"),
                      StackedComm(2), device="cpu")
    model, opt = wire.init_state(seed=3)
    batch = SyntheticTokens(pcfg, 4, T, seed=3).torch_batch(0, "cpu")
    gated = wire.make_train_step(sanity=SanityConfig(allow_injection=True))
    model, opt, m = gated(model, opt, batch, _health(INF, [1, np.nan]))
    assert m["ok_mask"].tolist() == [1, 0] and float(m["n_live"]) == 1.0
    assert all(torch.isfinite(t).all()
               for _, t in leaf_paths(model.param_tree()))
    step = wire.make_train_step(membership=Membership.full(2).leave(1))
    model, opt, m = step(model, opt, batch)
    assert np.isfinite(float(m["loss"]))
    assert wire.grad_buffers() is not buf
    with pytest.raises(ValueError, match="worker positions"):
        peng.make_train_step(membership=Membership.full(3).leave(1))


# ------------------------------------------------------- the supervisor

def _supervised(tmp_path, faults, steps, **cfg):
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(W4), device="cpu")
    model, opt = peng.init_state(seed=2)
    sup = TrainSupervisor(
        peng, SupervisorConfig(sanity=SanityConfig(allow_injection=True),
                               **cfg),
        faults=faults, log_fn=None)
    data = SyntheticTokens(pcfg, 8, T, seed=3)
    seen = []
    state = fit(peng, TrainState(params=model, opt=opt), data, steps=steps,
                log_every=0, supervisor=sup,
                hooks=[lambda s, h: seen.append((s.step, h))])
    return peng, sup, state, seen


def test_supervised_fit_demotes_a_repeat_offender(tmp_path):
    faults = FaultSchedule([FaultEvent(1, NAN_PUSH, 1, duration=2)],
                           world=W4)
    peng, sup, state, seen = _supervised(tmp_path, faults, 4,
                                         demote_after=2)
    masks = [h["ok_mask"].tolist() for _, h in seen]
    assert masks == [[1, 1, 1, 1], [1, 0, 1, 1], [1, 0, 1, 1], [1, 0, 1, 1]]
    assert [h["n_live"] for _, h in seen] == [4, 3, 3, 3]
    demotes = sup.incident_history("demote")
    assert [(e["step"], e["worker"], e["status"]) for e in demotes] == \
        [(2, 1, "slow")]
    assert sup.membership.live_ranks == (0, 2, 3)
    assert len(sup._steps) == 2                 # all live, then 3 of 4
    assert state.step == 4 and np.isfinite(state.losses).all()


def test_supervised_fit_rolls_back_past_a_corrupt_snapshot(tmp_path):
    """Every worker NaN-pushes for ``divergence_patience`` steps and the
    newest snapshot is truncated: the supervisor restores the last
    verified one, bitwise, and finishes."""
    d = str(tmp_path / "ckpt")
    events = [FaultEvent(3, NAN_PUSH, w, duration=3) for w in range(W4)]
    faults = FaultSchedule([*events, FaultEvent(5, CKPT_CORRUPT)], world=W4)
    checked = []

    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(W4), device="cpu")
    model, opt = peng.init_state(seed=2)
    sup = TrainSupervisor(
        peng, SupervisorConfig(sanity=SanityConfig(allow_injection=True),
                               checkpoint_dir=d, checkpoint_every=1,
                               keep_k=2, divergence_patience=3),
        faults=faults, log_fn=None)

    def on_step(state, host):
        if sup.rollbacks and not checked:
            step, tree = load_checkpoint(d, state.step)
            for path, t in leaf_paths(state.params.param_tree()):
                assert torch.equal(t.detach(),
                                   dict(leaf_paths(tree["params"]))[path])
            for name, t in state.opt["float32"].items():
                assert torch.equal(t, tree["opt"]["float32"][name])
            checked.append(step)

    data = SyntheticTokens(pcfg, 8, T, seed=3)
    state = fit(peng, TrainState(params=model, opt=opt), data, steps=6,
                log_every=0, supervisor=sup, hooks=[on_step])
    (rb,) = sup.incident_history("rollback")
    assert rb["step"] == 5 and rb["restored_step"] == 4
    assert rb["skipped"] == [5]
    assert checked == [4]
    assert "ckpt_corrupt_injected" in sup.event_kinds()
    assert state.step == 6 and len(state.losses) == 6
    assert np.isfinite(state.losses).all()
    assert sorted(int(s[5:]) for s in os.listdir(d)
                  if s.startswith("step_")) == [5, 6]
