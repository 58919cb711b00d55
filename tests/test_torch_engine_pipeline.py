"""The port's train step with PHub's gradient processing pipeline: windows,
flat parameter residency and chunk-ready dispatch.

1. W=1 against the JAX ``PHubEngine`` on a (1, 1) mesh with
   ``use_pallas=True`` (the Pallas kernels in interpret mode), with the
   same ``pipeline_windows`` / ``flat_residency`` / ``overlap_backward`` on
   both sides: one JAX step, its state carried over, then two more steps
   on each side from the same batches, under Nesterov, SGD and Adam.
   Bounds as tests/test_torch_engine.py and tests/test_torch_engine_optim.py
   state them (f32 activations, the two sides differ only in the order
   of f32 products and sums): losses rtol 1e-5, parameters 1e-6
   absolute; Nesterov's m 1e-4 of its largest entry, Adam's m 1e-4 and v
   2e-4, k1/k2 bitwise (Adam at eps 1e-3 and lr 1e-4, SGD at lr 1e-4).
2. Inside the port, the stacked W=4 step (two steps each): windowed, flat
   and chunk-ready, alone and combined, equal the monolithic
   tree-resident step bitwise (losses, parameters, every slot) under
   Nesterov, SGD and Adam, under a 3-of-4 membership (the dead worker
   first and last), and under the sanity gate with a NaN-poisoned worker
   (ok_mask, grad_norms, n_live too).  Chunk-ready windows launch inside
   the last worker's backward, after it under the gate; a windowed step
   makes windows x S update calls a group.
3. A checkpoint saved flat restores as a tree and the other way round,
   bitwise; the supervisor's rollback on a flat-resident model equals the
   tree-resident run bitwise; the launcher runs ``--windows`` and
   ``--overlap`` on the CPU; over the int8 wire, windows, chunk-ready
   dispatch and a flat store equal the one-window tree-resident run
   (``tests/test_torch_wire_pipeline.py`` holds the encoded windows
   further).

The chunk size is 7680 bytes (1920 f32 elements): the reduced model's
group has 240 chunks at S=1 and 60 a shard at S=4, so windows 2, 4 (W=1)
and 5 (W=4) take effect; each test asserts the effective count.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro.core.pipeline import effective_windows as jax_effective_windows
from repro.data import SyntheticTokens as JaxTokens
from repro_torch.checkpoint import (restore_train_state, save_checkpoint,
                                    snapshot_tree)
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import (CKPT_CORRUPT, FaultEvent, FaultSchedule,
                                 Membership, NAN_PUSH)
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                    TrainSupervisor)
from repro_torch.training import TrainState, fit

T, LOSS_CHUNK, W4, CHUNK_BYTES = 32, 16, 4, 7680
LR = {"nesterov": 0.05, "sgd": 1e-4, "adam": 1e-4}
ADAM_EPS = 1e-3
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
SLOT_REL = {"m": 1e-4, "v": 2e-4, "k1": 0.0, "k2": 0.0}
INF = np.float32(np.inf)
RULES = ["nesterov", "sgd", "adam"]


def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype="float32")
    return jcfg, pcfg


def _kw(rule, **mode):
    kw = dict(optimizer=rule, lr=LR[rule], loss_chunk=LOSS_CHUNK,
              chunk_size_bytes=CHUNK_BYTES, **mode)
    if rule == "adam":
        kw["adam_eps"] = ADAM_EPS
    return kw


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small steps, and with the
    default (one thread a core) next to other test processes the threads'
    barriers spin against each other, 50x slower; the results do not
    depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """The CPU embedding backward sums its rows in parallel, in an order
    that changes from run to run; deterministic mode fixes it, so two runs
    of one step are comparable bitwise."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


# ------------------------------------------------------------- W = 1

W1_MODES = {"windows2": dict(pipeline_windows=2),
            "windows4": dict(pipeline_windows=4),
            "flat": dict(flat_residency=True),
            "overlap": dict(pipeline_windows=4, overlap_backward=True)}


def _assert_trees_close(port_tree, ref_tree, atol):
    ref = dict(leaf_paths(ref_tree))
    got = dict(leaf_paths(port_tree))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        err = np.abs(t.detach().numpy() - np.asarray(ref[path],
                                                     np.float32)).max()
        assert err <= atol, (path, err, atol)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("mode", list(W1_MODES))
def test_w1_pipeline_steps_match_jax_engine(rule, mode):
    jcfg, pcfg = _cfgs()
    kw = _kw(rule, **W1_MODES[mode])
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(use_pallas=True, **kw),
                     mesh=jax.make_mesh((1, 1), ("data", "model")))
    (jg,) = jeng.chunk_plan.groups
    want_w = kw.get("pipeline_windows", 1)
    assert jax_effective_windows(jg, want_w) == want_w
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(shapes)
    flat = kw.get("flat_residency", False)
    tree = jeng.params_from_store if flat else (lambda p: p)
    params, opt, _ = jstep(params, opt, jdata.device_batch(0))
    carried = jax.device_get(tree(params)), jax.device_get(opt)
    jlosses = []
    for i in (1, 2):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        jlosses.append(float(jm["loss"]))
    jparams, jopt = jax.device_get(tree(params)), jax.device_get(opt)

    peng = PHubEngine(pcfg, TrainConfig(**kw), StackedComm(1), device="cpu")
    (g,) = peng.chunk_plan.groups
    assert effective_windows(g, want_w) == want_w
    model = peng.resident(params_from_numpy(pcfg, carried[0], device="cpu"))
    assert (model.flat_store is not None) == flat
    popt = opt_from_numpy(peng.chunk_plan, carried[1], device="cpu")
    pstep = peng.make_train_step()
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)
    reset_launches()
    plosses = []
    for i in (1, 2):
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        plosses.append(float(pm["loss"]))
    # CPU tensors take the plain versions: no kernel launch is counted
    assert all(c == 0 for c in LAUNCHES.values())
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)
    _assert_trees_close(model.param_tree(), jparams, PARAM_ATOL)
    for name, t in popt["float32"].items():
        r = np.asarray(jopt["float32"][name]).reshape(-1)
        err = np.abs(t.numpy().reshape(-1) - r).max()
        assert err <= SLOT_REL[name] * np.abs(r).max(), (name, err)


# ------------------------------------------------ W = 4, inside the port

W4_MODES = {"windows": dict(pipeline_windows=5),
            "flat": dict(flat_residency=True),
            "overlap": dict(pipeline_windows=5, overlap_backward=True),
            "windows+flat": dict(pipeline_windows=5, flat_residency=True),
            "overlap+flat": dict(pipeline_windows=5, overlap_backward=True,
                                 flat_residency=True),
            "overlap, one window": dict(overlap_backward=True)}


def _run(rule, mode, *, membership=None, sanity=False, steps=2, spy=None):
    """(losses, params, opt, metrics) of ``steps`` W=4 steps from seed-7
    weights; ``spy(engine)`` may wrap the engine before the step is made."""
    _, pcfg = _cfgs()
    eng = PHubEngine(pcfg, TrainConfig(**_kw(rule, **mode)), StackedComm(W4),
                     device="cpu")
    (g,) = eng.chunk_plan.groups
    assert effective_windows(g, mode.get("pipeline_windows", 1)) == \
        mode.get("pipeline_windows", 1)
    if spy is not None:
        spy(eng)
    model, opt = eng.init_state(seed=7)
    assert (model.flat_store is not None) == mode.get("flat_residency",
                                                       False)
    data = SyntheticTokens(pcfg, 8, T, seed=6)
    if sanity:
        step = eng.make_train_step(membership=membership,
                                   sanity=SanityConfig(allow_injection=True))
        extra = ({"norm_hi": INF,
                  "inject": np.asarray([1, np.nan, 1, 1], np.float32)},)
    else:
        step = eng.make_train_step(membership=membership)
        extra = ()
    losses, metrics = [], []
    for i in range(steps):
        model, opt, m = step(model, opt, data.torch_batch(i, "cpu"), *extra)
        losses.append(m["loss"])
        metrics.append(m)
    return losses, dict(leaf_paths(model.param_tree())), opt, metrics


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The bit patterns of an f32 tensor (so a NaN equals itself)."""
    return t.reshape(-1).view(torch.int32)


def _assert_same_run(a, b):
    (la, pa, oa, ma), (lb, pb, ob, mb) = a, b
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    for key in oa:
        assert oa[key].keys() == ob[key].keys()
        assert all(torch.equal(oa[key][n], ob[key][n]) for n in oa[key])
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        assert all(torch.equal(_bits(x[k]), _bits(y[k])) for k in x)


@pytest.mark.parametrize("rule", RULES)
def test_w4_pipeline_modes_equal_the_monolithic_step_bitwise(
        rule, deterministic):
    base = _run(rule, {})
    for mode in W4_MODES.values():
        _assert_same_run(_run(rule, mode), base)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("dead", [1, 3])
def test_w4_pipeline_modes_under_a_3_of_4_membership(rule, dead,
                                                     deterministic):
    """Worker 1 dead leaves chunk-ready dispatch on (its row is zeroed
    before the last worker's backward); the last worker dead sends it
    after the backward."""
    members = Membership.full(W4).leave(dead)
    base = _run(rule, {}, membership=members)
    for name in ("windows", "flat", "overlap+flat"):
        _assert_same_run(_run(rule, W4_MODES[name], membership=members),
                         base)


@pytest.mark.parametrize("rule", RULES)
def test_w4_pipeline_modes_under_the_sanity_gate(rule, deterministic):
    base = _run(rule, {}, sanity=True)
    assert [m["ok_mask"].tolist() for m in base[3]] == [[1, 0, 1, 1]] * 2
    for name in ("windows", "flat", "overlap+flat"):
        _assert_same_run(_run(rule, W4_MODES[name], sanity=True), base)


def _graph_tasks(calls):
    """Wrap the engine's update_fn to record, for every call, whether it
    ran inside a backward (an autograd graph task)."""
    def spy(eng):
        make = eng.update_fn

        def update_fn(group):
            upd = make(group)

            def counted(*a, **kw):
                calls.append(torch._C._current_graph_task_id() != -1)
                return upd(*a, **kw)
            return counted
        eng.update_fn = update_fn
    return spy


@pytest.mark.parametrize("sanity", [False, True])
def test_chunk_ready_windows_launch_inside_the_backward(sanity):
    """5 windows x 4 shards = 20 update calls a step: inside the last
    worker's backward, or after it under the gate."""
    calls = []
    _run("nesterov", W4_MODES["overlap"], sanity=sanity, steps=1,
         spy=_graph_tasks(calls))
    assert calls == [not sanity] * 20
    calls.clear()
    _run("nesterov", W4_MODES["windows"], steps=1, spy=_graph_tasks(calls))
    assert calls == [False] * 20
    calls.clear()
    _run("nesterov", {}, steps=1, spy=_graph_tasks(calls))
    assert calls == [False]


# ---------------------------------------------- checkpoints, fit, launcher

def _next_step(eng, model, opt, batch):
    """The parameters after one more step (on a copy of ``opt``)."""
    model, _, _ = eng.make_train_step()(
        model, {k: {n: t.clone() for n, t in v.items()}
                for k, v in opt.items()}, batch)
    return [t.detach().clone() for _, t in leaf_paths(model.param_tree())]


@pytest.mark.parametrize("rule", ["nesterov", "adam"])
def test_checkpoint_restores_across_residency_bitwise(tmp_path, rule,
                                                      deterministic):
    """A snapshot saved flat (the store) restores into a tree-resident
    engine and one saved as a tree into a flat-resident engine, fresh or
    into a given model: parameters and every slot bitwise, and the next
    step equals the one from a same-residency restore."""
    _, pcfg = _cfgs()
    engs = {flat: PHubEngine(pcfg, TrainConfig(**_kw(
        rule, flat_residency=flat, pipeline_windows=5)), StackedComm(W4),
        device="cpu") for flat in (False, True)}
    data = SyntheticTokens(pcfg, 8, T, seed=5)
    for src, dst in ((True, False), (False, True)):
        d = str(tmp_path / f"from_{'flat' if src else 'tree'}")
        model, opt = engs[src].init_state(seed=3)
        model, opt, _ = engs[src].make_train_step()(
            model, opt, data.torch_batch(0, "cpu"))
        tree = snapshot_tree(model, opt)
        assert ("float32" in tree["params"]) == src
        save_checkpoint(d, 1, tree)
        want = [t.detach().clone() for _, t in leaf_paths(model.param_tree())]
        want_opt = {n: t.clone() for n, t in opt["float32"].items()}
        _, same, same_opt = restore_train_state(d, engs[src])
        want_next = _next_step(engs[src], same, same_opt,
                               data.torch_batch(1, "cpu"))
        for into in (None, engs[dst].init_model(seed=9)):
            step, restored, ropt = restore_train_state(d, engs[dst],
                                                       model=into)
            assert step == 1 and (into is None or restored is into)
            assert (restored.flat_store is not None) == dst
            got = [t for _, t in leaf_paths(restored.param_tree())]
            assert all(torch.equal(a, b) for a, b in zip(got, want))
            for name, t in ropt["float32"].items():
                assert torch.equal(t, want_opt[name])
            got_next = _next_step(engs[dst], restored, ropt,
                                  data.torch_batch(1, "cpu"))
            assert all(torch.equal(a, b)
                       for a, b in zip(got_next, want_next))


def test_supervised_rollback_on_a_flat_resident_model(tmp_path,
                                                      deterministic):
    """Every worker NaN-pushes for ``divergence_patience`` steps and the
    newest snapshot is truncated: the supervisor rolls a flat-resident,
    windowed model back into its store, and the run equals the
    tree-resident one bitwise."""
    _, pcfg = _cfgs()
    runs = []
    for mode in ({}, dict(flat_residency=True, pipeline_windows=5)):
        d = str(tmp_path / f"ckpt{len(runs)}")
        eng = PHubEngine(pcfg, TrainConfig(**_kw("nesterov", **mode)),
                         StackedComm(W4), device="cpu")
        model, opt = eng.init_state(seed=2)
        store = model.flat_store
        faults = FaultSchedule(
            [*(FaultEvent(3, NAN_PUSH, w, duration=3) for w in range(W4)),
             FaultEvent(5, CKPT_CORRUPT)], world=W4)
        sup = TrainSupervisor(
            eng, SupervisorConfig(sanity=SanityConfig(allow_injection=True),
                                  checkpoint_dir=d, checkpoint_every=1,
                                  keep_k=2, divergence_patience=3),
            faults=faults, log_fn=None)
        state = fit(eng, TrainState(params=model, opt=opt),
                    SyntheticTokens(pcfg, 8, T, seed=3), steps=6,
                    log_every=0, supervisor=sup)
        rb = sup.incident_history("rollback")
        assert [(e["restored_step"], e["skipped"]) for e in rb] == [(4, [5])]
        assert state.params is model
        if store is not None:
            assert model.flat_store is not None and \
                model.flat_store is not store
        runs.append((state.losses, model, state.opt))
    (la, ma, oa), (lb, mb, ob) = runs
    assert la == lb
    for (_, a), (_, b) in zip(leaf_paths(ma.param_tree()),
                              leaf_paths(mb.param_tree())):
        assert torch.equal(a, b)
    assert all(torch.equal(oa["float32"][n], ob["float32"][n])
               for n in oa["float32"])


def test_launcher_runs_windows_and_overlap_on_cpu(capsys):
    from repro_torch.launch.train import main
    losses = main(["--reduced", "--device", "cpu", "--steps", "2",
                   "--batch", "4", "--seq", "16", "--workers", "4",
                   "--chunk-kb", "28", "--windows", "5", "--overlap"])
    out = capsys.readouterr().out
    assert "windows=5 (effective [5]) overlap=True" in out
    assert len(losses) == 2 and np.isfinite(losses).all()


def test_encoded_wire_in_windows_raises_and_flat_runs_at_one_window(
        deterministic):
    """No mode refuses an encoded wire now: over int8, windows, chunk-ready
    dispatch and flat residency, alone and combined, equal the one-window
    tree-resident int8 step bitwise (losses, parameters, the rule's slot
    and ``wire_ef``), as a flat store at one window does."""
    _, pcfg = _cfgs()
    runs = []
    for mode in ({}, dict(flat_residency=True), dict(pipeline_windows=5),
                 dict(pipeline_windows=5, overlap_backward=True,
                      flat_residency=True)):
        eng = PHubEngine(pcfg, TrainConfig(**_kw(
            "nesterov", wire_format="int8", **mode)),
            StackedComm(W4), device="cpu")
        (g,) = eng.chunk_plan.groups
        assert effective_windows(g, mode.get("pipeline_windows", 1)) == \
            mode.get("pipeline_windows", 1)
        model, opt = eng.init_state(seed=4)
        step = eng.make_train_step()
        data = SyntheticTokens(pcfg, 8, T, seed=4)
        for i in range(2):
            model, opt, m = step(model, opt, data.torch_batch(i, "cpu"))
        runs.append((m["loss"], dict(leaf_paths(model.param_tree())), opt))
    (la, pa, oa), *rest = runs
    assert oa["float32"]["wire_ef"].abs().max() > 0
    for lb, pb, ob in rest:
        assert torch.equal(la, lb)
        assert all(torch.equal(pa[k], pb[k]) for k in pa)
        assert oa["float32"].keys() == ob["float32"].keys()
        assert all(torch.equal(oa["float32"][n], ob["float32"][n])
                   for n in oa["float32"])


def test_flat_step_refuses_a_model_that_is_not_resident():
    _, pcfg = _cfgs()
    tree_eng = PHubEngine(pcfg, TrainConfig(**_kw("sgd")), StackedComm(1),
                          device="cpu")
    flat_eng = PHubEngine(pcfg, TrainConfig(**_kw("sgd",
                                                  flat_residency=True)),
                          StackedComm(1), device="cpu")
    model, opt = tree_eng.init_state()
    data = SyntheticTokens(pcfg, 2, T, seed=1)
    with pytest.raises(ValueError, match="resident"):
        flat_eng.make_train_step()(model, opt, data.torch_batch(0, "cpu"))
    model = flat_eng.resident(model)
    store = model.flat_store
    assert flat_eng.resident(model).flat_store is store
    for path, leaf in leaf_paths(model.param_tree()):
        assert leaf.untyped_storage().data_ptr() == \
            store["float32"].untyped_storage().data_ptr()
