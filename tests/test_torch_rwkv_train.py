"""Training the attention-free (ssm) family, rwkv6-3b, through the port
against the JAX package, on reduced configs.

1. Autograd of the scan: the port's ``rwkv_chunked`` (T 64, 128) and
   ``rwkv_recurrence`` (T 40, 64) against ``jax.grad`` of the reference's,
   on r, k, v, w, u and the initial state: f32, B 2, H 2, hd 16 and 32,
   decay in (0.9, 1), a nonzero state, random cotangents on y and the
   final state.  Stated bound: every gradient within 5e-6 of its largest
   entry.  The two frameworks take f32 products and sums in another
   order, and the chunked form divides k by the cumulative decay (down to
   0.9^64 ~ 1e-3) and multiplies it back, which can magnify those
   roundings; measured at most 4.4e-7 of max|want| here, so the bound
   leaves a factor of 10.
2. Loss and gradients of the model: reduced rwkv6-3b (2 layers, d_model
   256, 4 heads of 64), chunked cross-entropy, T 64 (the chunked form) and
   T 40 (the recurrence), f32 and bf16, against ``jax.value_and_grad`` of
   the reference's ``forward``: the bounds of tests/test_torch_model.py
   (f32: loss rtol 1e-5, gradients 1e-4 of each leaf's largest entry;
   bf16: 1e-3 and 2e-2, for the reasons given there).
3. W=1: three steps against the JAX ``PHubEngine`` on a (1, 1) mesh with
   ``use_pallas=False`` (the only way the reference trains this family:
   ``jax.grad`` through its scan kernel fails), under Nesterov, SGD and
   Adam, f32 activations, T 64: losses rtol 1e-5, parameters 1e-6
   absolute, Nesterov's m 1e-4 and Adam's m 1e-4 and v 2e-4 of their
   largest entries, k1/k2 bitwise (the bounds of tests/test_torch_engine.py
   and tests/test_torch_engine_optim.py; SGD and Adam at lr 1e-4, Adam at
   eps 1e-3).
4. W=4 stacked: two steps against the data-parallel oracle (JAX
   per-worker gradients, averaged, ``tree_update``'s Nesterov), with the
   bounds of 3.
5. Inside the port, W=2 (152 = 8 x 19 chunks a shard, so 2, 4 and 8
   windows take effect): windows, flat residency and chunk-ready
   dispatch, alone and combined, equal the monolithic tree-resident step bitwise, under the
   three rules and over the int8 wire; chunk-ready windows launch inside
   the last worker's backward.
6. Checkpoints of the rwkv tree restore across residencies bitwise; the
   supervised step masks a NaN-poisoned worker; the launcher trains
   ``--arch rwkv6-3b --reduced --device cpu``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro.data import SyntheticTokens as JaxTokens
from repro.models import (chunked_cross_entropy as jax_ce, forward,
                          init as jax_init, lm_head_weight)
from repro.models.rwkv import (rwkv_chunked as jax_chunked,
                               rwkv_recurrence as jax_recurrence)
from repro.optim.protocol import NesterovOptimizer, tree_update
from repro_torch.checkpoint import (restore_train_state, save_checkpoint,
                                    snapshot_tree)
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths, unflatten_groups
from repro_torch.core.pipeline import effective_windows
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
from repro_torch.kernels.rwkv_scan import ops as scan_ops
from repro_torch.models import chunked_cross_entropy
from repro_torch.models.rwkv import rwkv_chunked, rwkv_recurrence
from repro_torch.resilience import SanityConfig

T, LOSS_CHUNK, W4 = 64, 16, 4
SCAN_TOL = 5e-6
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-2)}
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
SLOT_REL = {"m": 1e-4, "v": 2e-4, "k1": 0.0, "k2": 0.0}
LR = {"nesterov": 0.05, "sgd": 1e-4, "adam": 1e-4}
ADAM_EPS = 1e-3
RULES = ["nesterov", "sgd", "adam"]
CHUNK_BYTES = 24576              # 6144 f32: 152 chunks a shard at W=2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: these tests run many small steps beside other
    test processes (see tests/test_torch_engine_pipeline.py); the results
    do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """The CPU embedding backward sums its rows in an order that changes
    from run to run; deterministic mode fixes it for bitwise comparisons."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


# ----------------------------------------------------- 1. the scan's grads

def _scan_inputs(B, T_, H, hd, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(
        np.float32)
    r, k, v = (f(B, T_, H, hd, scale=0.5) for _ in range(3))
    w = rng.uniform(0.9, 1.0, (B, T_, H, hd)).astype(np.float32)
    u = f(H, hd, scale=0.5)
    S = f(B, H, hd, hd, scale=0.3)
    dy, dS = f(B, T_, H, hd), f(B, H, hd, hd)
    return (r, k, v, w, u, S), dy, dS


@pytest.mark.parametrize("form,T_", [("chunked", 64), ("chunked", 128),
                                     ("recurrence", 40),
                                     ("recurrence", 64)])
@pytest.mark.parametrize("hd", [16, 32])
def test_scan_autograd_matches_jax_grad(form, T_, hd):
    ins, dy, dS = _scan_inputs(2, T_, 2, hd, seed=T_ + hd)
    jfn = jax_chunked if form == "chunked" else jax_recurrence
    pfn = rwkv_chunked if form == "chunked" else rwkv_recurrence

    def jloss(*a):
        y, S = jfn(*a)
        return jnp.sum(y * dy) + jnp.sum(S * dS)
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    y, S = pfn(*leaves)
    loss = (y * torch.from_numpy(dy)).sum() + (S * torch.from_numpy(dS)).sum()
    got = torch.autograd.grad(loss, leaves)
    for name, a, b in zip("rkvwuS", got, want):
        b = np.asarray(b)
        err = np.abs(a.numpy() - b).max()
        assert err <= SCAN_TOL * np.abs(b).max(), (name, err,
                                                   np.abs(b).max())


# --------------------------------------------------- 2. the model's grads

def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(reduced(ARCHS["rwkv6-3b"]), dtype=dtype)
    pcfg = dataclasses.replace(port_reduced(get_arch("rwkv6-3b")),
                               dtype=dtype)
    return jcfg, pcfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T_", [64, 40])
def test_rwkv_loss_and_grads_match_reference(dtype, T_):
    jcfg, pcfg = _cfgs(dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    batch = JaxTokens(jcfg, 2, T_, seed=1).batch_at(0)

    def jloss(p):
        x = forward(jcfg, p, jnp.asarray(batch["tokens"]), remat=False)["x"]
        return jax_ce(x, lm_head_weight(jcfg, p), jnp.asarray(batch["labels"]),
                      chunk=LOSS_CHUNK)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)

    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    tb = SyntheticTokens(pcfg, 2, T_, seed=1).torch_batch(0, "cpu")
    loss = chunked_cross_entropy(model(tb["tokens"], remat=True),
                                 model.lm_head_weight(), tb["labels"],
                                 chunk=LOSS_CHUNK)
    paths, leaves = zip(*leaf_paths(model.param_tree()))
    grads = torch.autograd.grad(loss, leaves)
    rtol, gtol = TOL[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=rtol)
    ref = dict(leaf_paths(jax.device_get(ref_grads)))
    assert list(paths) == list(ref)             # the reference's leaf order
    for path, g in zip(paths, grads):
        r = np.asarray(ref[path], np.float32)
        err = np.abs(g.float().numpy() - r).max()
        assert err <= gtol * np.abs(r).max(), (path, err, np.abs(r).max())


# ----------------------------------------------------- 3. W=1 vs the JAX

def _kw(rule, **mode):
    kw = dict(optimizer=rule, lr=LR[rule], loss_chunk=LOSS_CHUNK, **mode)
    if rule == "adam":
        kw["adam_eps"] = ADAM_EPS
    return kw


def _assert_trees_close(port_tree, ref_tree, *, atol=None, rel=None):
    ref = dict(leaf_paths(ref_tree))
    got = dict(leaf_paths(port_tree))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        r = np.asarray(ref[path], np.float32)
        err = np.abs(t.detach().numpy() - r).max()
        tol = atol if atol is not None else rel * np.abs(r).max()
        assert err <= tol, (path, err, tol)


@pytest.mark.parametrize("rule", RULES)
def test_w1_steps_match_jax_engine(rule):
    jcfg, pcfg = _cfgs()
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(use_pallas=False,
                                                 **_kw(rule)),
                     mesh=jax.make_mesh((1, 1), ("data", "model")))
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    np_params, np_opt = jax.device_get(params), jax.device_get(opt)
    jdata = JaxTokens(jcfg, 2, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(shapes)

    peng = PHubEngine(pcfg, TrainConfig(**_kw(rule)), StackedComm(1),
                      device="cpu")
    # the rwkv tree's chunk domain is the reference's, leaf for leaf
    assert [(g.paths, g.sizes, g.padded) for g in peng.chunk_plan.groups] \
        == [(g.paths, g.sizes, g.padded) for g in jeng.chunk_plan.groups]
    model = params_from_numpy(pcfg, np_params, device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, np_opt,
                          slots=peng.exchange_slots, device="cpu")
    pstep = peng.make_train_step()
    pdata = SyntheticTokens(pcfg, 2, T, seed=2)
    reset_launches()
    scan_ops.reset_launches()
    for i in range(3):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    # CPU tensors take the plain versions, and training never the scan
    assert all(c == 0 for c in LAUNCHES.values())
    assert all(c == 0 for c in scan_ops.LAUNCHES.values())
    _assert_trees_close(model.param_tree(), jax.device_get(params),
                        atol=PARAM_ATOL)
    jopt = jax.device_get(opt)["float32"]
    for name, t in popt["float32"].items():
        r = np.asarray(jopt[name]).reshape(-1)
        err = np.abs(t.numpy().reshape(-1) - r).max()
        assert err <= SLOT_REL[name] * np.abs(r).max(), (name, err)


# ------------------------------------------------- 4. W=4 vs the oracle

def test_w4_stacked_steps_match_data_parallel_oracle():
    jcfg, pcfg = _cfgs()
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    init = jax.device_get(params)
    m = jax.tree.map(jnp.zeros_like, params)

    def wloss(p, tok, lab):
        x = forward(jcfg, p, tok, remat=False)["x"]
        return jax_ce(x, lm_head_weight(jcfg, p), lab, chunk=LOSS_CHUNK)
    vg = jax.jit(jax.value_and_grad(wloss))
    data = SyntheticTokens(pcfg, 8, T, seed=4)
    bs = 8 // W4
    ref_losses = []
    for i in range(2):
        batch = data.batch_at(i)
        step_losses, gsum = [], None
        for w in range(W4):
            sl = slice(w * bs, (w + 1) * bs)
            loss, g = vg(params, jnp.asarray(batch["tokens"][sl]),
                         jnp.asarray(batch["labels"][sl]))
            step_losses.append(float(loss))
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        gmean = jax.tree.map(lambda a: a / W4, gsum)
        params, state = tree_update(NesterovOptimizer(), (LR["nesterov"],
                                                          0.9),
                                    params, gmean, {"m": m})
        m = state["m"]
        ref_losses.append(float(np.mean(step_losses)))

    peng = PHubEngine(pcfg, TrainConfig(**_kw("nesterov")), StackedComm(W4),
                      device="cpu")
    model = params_from_numpy(pcfg, init, device="cpu")
    popt = peng.init_opt()
    pstep = peng.make_train_step()
    for i in range(2):
        model, popt, pm = pstep(model, popt, data.torch_batch(i, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), ref_losses[i],
                                   rtol=LOSS_RTOL)
    _assert_trees_close(model.param_tree(), jax.device_get(params),
                        atol=PARAM_ATOL)
    flats = {k: v["m"].reshape(-1) for k, v in popt.items()}
    _assert_trees_close(unflatten_groups(peng.chunk_plan, flats,
                                         model.param_tree()),
                        jax.device_get(m), rel=SLOT_REL["m"])


# ------------------------------------------------ 5. the pipeline's modes

MODES = {"windows": dict(pipeline_windows=4),
         "flat": dict(flat_residency=True),
         "overlap": dict(pipeline_windows=8, overlap_backward=True),
         "windows+flat": dict(pipeline_windows=2, flat_residency=True),
         "overlap+flat": dict(pipeline_windows=4, overlap_backward=True,
                              flat_residency=True)}


def _run(rule, mode, wire="identity", steps=2, spy=None):
    _, pcfg = _cfgs()
    eng = PHubEngine(pcfg, TrainConfig(**_kw(
        rule, chunk_size_bytes=CHUNK_BYTES, wire_format=wire, **mode)),
        StackedComm(2), device="cpu")
    (g,) = eng.chunk_plan.groups
    want = mode.get("pipeline_windows", 1)
    assert g.chunks_per_shard == 152 and effective_windows(g, want) == want
    if spy is not None:
        spy(eng)
    model, opt = eng.init_state(seed=5)
    assert (model.flat_store is not None) == mode.get("flat_residency",
                                                       False)
    data = SyntheticTokens(pcfg, 4, T, seed=6)
    step = eng.make_train_step()
    losses = []
    for i in range(steps):
        model, opt, m = step(model, opt, data.torch_batch(i, "cpu"))
        losses.append(m["loss"])
    return losses, dict(leaf_paths(model.param_tree())), opt


def _assert_same_run(a, b):
    (la, pa, oa), (lb, pb, ob) = a, b
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert pa.keys() == pb.keys()
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    for key in oa:
        assert oa[key].keys() == ob[key].keys()
        assert all(torch.equal(oa[key][n], ob[key][n]) for n in oa[key])


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("wire", ["identity", "int8"])
def test_rwkv_pipeline_modes_equal_the_monolithic_step_bitwise(
        rule, wire, deterministic):
    base = _run(rule, {}, wire)
    for name in ("windows", "flat", "overlap", "windows+flat",
                 "overlap+flat"):
        _assert_same_run(_run(rule, MODES[name], wire), base)


def test_rwkv_chunk_ready_windows_launch_inside_the_backward():
    calls = []

    def spy(eng):
        make = eng.update_fn

        def update_fn(group):
            upd = make(group)

            def counted(*a, **kw):
                calls.append(torch._C._current_graph_task_id() != -1)
                return upd(*a, **kw)
            return counted
        eng.update_fn = update_fn
    _run("nesterov", MODES["overlap"], steps=1, spy=spy)
    assert len(calls) == 8 * 2 and any(calls)


# ------------------------------------- 6. checkpoints, supervisor, launcher

@pytest.mark.parametrize("rule", ["nesterov", "adam"])
def test_rwkv_checkpoint_restores_across_residency_bitwise(tmp_path, rule,
                                                           deterministic):
    _, pcfg = _cfgs()
    engs = {flat: PHubEngine(pcfg, TrainConfig(**_kw(
        rule, chunk_size_bytes=CHUNK_BYTES, flat_residency=flat,
        pipeline_windows=4)), StackedComm(2), device="cpu")
        for flat in (False, True)}
    data = SyntheticTokens(pcfg, 4, T, seed=5)
    for src, dst in ((True, False), (False, True)):
        d = str(tmp_path / f"from_{'flat' if src else 'tree'}")
        model, opt = engs[src].init_state(seed=3)
        model, opt, _ = engs[src].make_train_step()(
            model, opt, data.torch_batch(0, "cpu"))
        save_checkpoint(d, 1, snapshot_tree(model, opt))
        want = [t.detach().clone() for _, t in leaf_paths(model.param_tree())]
        step, restored, ropt = restore_train_state(d, engs[dst])
        assert step == 1 and (restored.flat_store is not None) == dst
        got = [t for _, t in leaf_paths(restored.param_tree())]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        for name, t in ropt["float32"].items():
            assert torch.equal(t, opt["float32"][name])


def test_rwkv_gated_step_masks_a_poisoned_worker():
    _, pcfg = _cfgs()
    eng = PHubEngine(pcfg, TrainConfig(**_kw("nesterov", wire_format="int8")),
                     StackedComm(2), device="cpu")
    model, opt = eng.init_state(seed=2)
    step = eng.make_train_step(sanity=SanityConfig(allow_injection=True))
    data = SyntheticTokens(pcfg, 4, T, seed=2)
    model, opt, m = step(model, opt, data.torch_batch(0, "cpu"),
                         {"norm_hi": np.float32(np.inf),
                          "inject": np.asarray([np.nan, 1], np.float32)})
    assert m["ok_mask"].tolist() == [0, 1] and float(m["n_live"]) == 1.0
    assert all(torch.isfinite(t).all()
               for _, t in leaf_paths(model.param_tree()))


def test_launcher_trains_rwkv_on_cpu(capsys):
    from repro_torch.launch.train import main
    losses = main(["--arch", "rwkv6-3b", "--reduced", "--device", "cpu",
                   "--steps", "2", "--batch", "4", "--seq", "64",
                   "--workers", "2"])
    assert "arch=rwkv6-3b" in capsys.readouterr().out
    assert len(losses) == 2 and np.isfinite(losses).all()
