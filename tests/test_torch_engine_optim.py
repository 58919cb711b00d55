"""The port's PHub train step under SGD and Adam against the JAX package's.

1. W=1: one JAX ``PHubEngine`` step on a (1, 1) mesh with ``use_pallas=True``
   (the Pallas sgd/adam kernels in interpret mode), then its weights and
   optimizer slots carried over with ``params_from_numpy`` /
   ``opt_from_numpy`` (Adam's k1/k2 as f32), then two more steps on each
   side from the same batches.
2. W=4 stacked: two port steps against the data-parallel oracle: JAX
   per-worker gradients, summed in worker order and divided by W, then the
   kernel-form rule (``repro.kernels.agg_opt.ref``) leaf by leaf.

Activations are float32, so the two sides differ only in the order f32
products and sums are taken (and, against the Pallas kernels, in XLA's
FMA contraction).  At the default eps=1e-8 Adam's first step is
lr*g/(|g| + eps), a sign function wherever |g| >> eps, so a gradient
entry near 0 whose sign the two orders disagree on can move its parameter
by up to 2*lr: no useful parameter bound holds.  So the parity runs use
``adam_eps=1e-3``, where the step is Lipschitz in the gradient:
|dstep| <= lr/(k1'*eps) * |dm'| (plus a v' term of the same order) and
|dm'| <= (1-b1)*|dg| + b1*|dm|, with k1' >= 1-b1, so at lr=1e-4 each step
moves a parameter by at most about 0.1*|dg| beyond the carried |dm|.
Stated bounds: losses to rtol 1e-5; parameters to 1e-6 absolute, which
covers |dg| up to 3e-6 over the three steps; m to 1e-4 of its largest
entry per leaf, v (which holds squared gradients) to 2e-4, k1/k2 bitwise
(they tick where g != 0, and no gradient entry is exactly 0 on one side
alone).  One run at the default eps checks losses only.
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
from repro.kernels.agg_opt.ref import (adam_opt_ref as jax_adam_ref,
                                       sgd_opt_ref as jax_sgd_ref)
from repro.models import (chunked_cross_entropy as jax_ce, forward,
                          init as jax_init, lm_head_weight)
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths, unflatten_groups
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches

T, LOSS_CHUNK, LR, EPS, W4 = 32, 16, 1e-4, 1e-3, 4
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
SLOT_REL = {"m": 1e-4, "v": 2e-4, "k1": 0.0, "k2": 0.0}


def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype="float32")
    return jcfg, pcfg


def _tcs(rule, eps=EPS):
    kw = dict(optimizer=rule, lr=LR, loss_chunk=LOSS_CHUNK)
    if rule == "adam":
        kw["adam_eps"] = eps
    return JaxTrainConfig(use_pallas=True, **kw), TrainConfig(**kw)


def _assert_trees_close(port_tree, ref_tree, *, atol=None, rel=None):
    ref = dict(leaf_paths(ref_tree))
    got = dict(leaf_paths(port_tree))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        r = np.asarray(ref[path], np.float32)
        err = np.abs(t.detach().numpy() - r).max()
        tol = atol if atol is not None else rel * np.abs(r).max()
        assert err <= tol, (path, err, tol)


def _assert_slots_close(port_opt, jax_opt):
    for key, slots in port_opt.items():
        assert slots.keys() == jax_opt[key].keys()
        for name, t in slots.items():
            r = np.asarray(jax_opt[key][name]).reshape(-1)
            assert t.dtype == getattr(torch, str(r.dtype))
            err = np.abs(t.numpy().reshape(-1) - r).max()
            assert err <= SLOT_REL[name] * np.abs(r).max(), (name, err)


def _jax_w1(rule, eps=EPS, steps=3):
    """The JAX engine's run: (state after step 1, batches, losses of the
    later steps, final params, final opt)."""
    jcfg, _ = _cfgs()
    jtc, _ = _tcs(rule, eps)
    jeng = JaxEngine(cfg=jcfg, tc=jtc, mesh=jax.make_mesh((1, 1),
                                                          ("data", "model")))
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(shapes)
    params, opt, _ = jstep(params, opt, jdata.device_batch(0))
    carried = jax.device_get(params), jax.device_get(opt)
    losses = []
    for i in range(1, steps):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        losses.append(float(jm["loss"]))
    return carried, losses, jax.device_get(params), jax.device_get(opt)


def _port_w1(rule, carried, eps=EPS, steps=3):
    _, pcfg = _cfgs()
    _, tc = _tcs(rule, eps)
    peng = PHubEngine(pcfg, tc, StackedComm(1), device="cpu")
    model = params_from_numpy(pcfg, carried[0], device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, carried[1], device="cpu")
    pstep = peng.make_train_step()
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)
    losses = []
    for i in range(1, steps):
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        losses.append(float(pm["loss"]))
    return model, popt, losses


@pytest.mark.parametrize("rule", ["sgd", "adam"])
def test_w1_steps_match_jax_engine_with_pallas_kernel(rule):
    carried, jlosses, jparams, jopt = _jax_w1(rule)
    if rule == "adam":
        k1 = carried[1]["float32"]["k1"]
        assert k1.dtype == np.float32 and (k1 != 0).any()
    reset_launches()
    model, popt, plosses = _port_w1(rule, carried)
    # CPU tensors take the plain version: no kernel launch is counted
    assert all(c == 0 for c in LAUNCHES.values())
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)
    _assert_trees_close(model.param_tree(), jparams, atol=PARAM_ATOL)
    assert popt.keys() == jopt.keys()
    _assert_slots_close(popt, jopt)


def test_w1_adam_at_default_eps_matches_losses():
    """eps=1e-8: the step is a sign function of the gradient, so only the
    losses are compared (the parameters may differ by 2*lr in a few
    entries; see the module docstring)."""
    carried, jlosses, _, _ = _jax_w1("adam", eps=1e-8, steps=4)
    _, _, plosses = _port_w1("adam", carried, eps=1e-8, steps=4)
    np.testing.assert_allclose(plosses, jlosses, rtol=LOSS_RTOL)


def _worker_loss(jcfg, p, tokens, labels):
    x = forward(jcfg, p, tokens, remat=False)["x"]
    return jax_ce(x, lm_head_weight(jcfg, p), labels, chunk=LOSS_CHUNK)


def _oracle_rule(rule, p, g, slots):
    """The kernel-form rule on one leaf; slots: dict of arrays."""
    if rule == "sgd":
        return jax_sgd_ref(p, g, lr=LR), {}
    p2, *new = jax_adam_ref(p, g, slots["m"], slots["v"], slots["k1"],
                            slots["k2"], lr=LR, eps=EPS)
    return p2, dict(zip(("m", "v", "k1", "k2"), new))


@pytest.fixture(scope="module", params=["sgd", "adam"])
def w4_oracle(request):
    """Two data-parallel oracle steps from PRNGKey(1) weights: the rule,
    the initial weights, the batches, and the oracle's (params, slots,
    losses)."""
    rule = request.param
    jcfg, pcfg = _cfgs()
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    init = jax.device_get(params)
    names = () if rule == "sgd" else ("m", "v", "k1", "k2")
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
            gsum = g if gsum is None else jax.tree.map(jnp.add, gsum, g)
        gmean = jax.tree.map(lambda a: a / W4, gsum)
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


def test_w4_stacked_steps_match_data_parallel_oracle(w4_oracle):
    _, pcfg = _cfgs()
    rule, init, data, ref_params, ref_slots, ref_losses = w4_oracle
    _, tc = _tcs(rule)
    peng = PHubEngine(pcfg, tc, StackedComm(W4), device="cpu")
    model = params_from_numpy(pcfg, init, device="cpu")
    popt = peng.init_opt()
    (group,) = peng.chunk_plan.groups
    assert sorted(popt["float32"]) == sorted(ref_slots)
    for name, t in popt["float32"].items():
        assert t.shape == (W4, group.shard_len)
        assert t.dtype == torch.float32
    pstep = peng.make_train_step()
    for i in range(2):
        model, popt, pm = pstep(model, popt, data.torch_batch(i, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), ref_losses[i],
                                   rtol=LOSS_RTOL)
    _assert_trees_close(model.param_tree(), ref_params, atol=PARAM_ATOL)
    for name, t in popt["float32"].items():
        tree = unflatten_groups(peng.chunk_plan,
                                {"float32": t.reshape(-1)},
                                model.param_tree())
        rel = SLOT_REL[name]
        if rel:
            _assert_trees_close(tree, ref_slots[name], rel=rel)
        else:
            _assert_trees_close(tree, ref_slots[name], atol=0.0)
        # the pad tail past the parameters is dead: it stays exactly 0
        assert not t.reshape(-1)[group.total:].any()


def test_adam_slots_are_updated_in_place_by_the_engine():
    """The engine's step hands back the very slot tensors it was given
    (no second copy of four model-sized vectors)."""
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, TrainConfig(optimizer="adam", lr=LR,
                                        loss_chunk=LOSS_CHUNK),
                      StackedComm(2), device="cpu")
    model, opt = peng.init_state()
    ids = {n: t.data_ptr() for n, t in opt["float32"].items()}
    batch = SyntheticTokens(pcfg, 4, T, seed=0).torch_batch(0, "cpu")
    _, opt2, _ = peng.make_train_step()(model, opt, batch)
    assert {n: t.data_ptr() for n, t in opt2["float32"].items()} == ids
    assert opt2["float32"]["k1"].dtype == torch.float32
    assert opt2["float32"]["k1"].any()
    sgd = PHubEngine(pcfg, TrainConfig(optimizer="sgd", lr=LR),
                     StackedComm(2), device="cpu")
    assert sgd.init_opt() == {"float32": {}}



def test_opt_from_numpy_carries_adam_slots_of_a_bf16_group():
    """A bf16 dtype group: m/v arrive as numpy bf16 (JAX's extension type)
    and stay bf16 bit for bit; k1/k2 arrive and stay f32."""
    from repro_torch.core.chunking import build_plan
    tree = {"a": torch.zeros(3, 5, dtype=torch.bfloat16),
            "b": torch.zeros(7)}
    plan = build_plan(tree, chunk_bytes=64, n_shards=2)
    rng = np.random.default_rng(0)
    ref = {}
    for g in plan.groups:
        jdt = jnp.bfloat16 if g.dtype == torch.bfloat16 else jnp.float32
        ref[g.key] = {
            n: np.asarray(jnp.asarray(rng.standard_normal(
                (1, 2, g.shard_len)).astype(np.float32)).astype(
                    jnp.float32 if n in ("k1", "k2") else jdt))
            for n in ("m", "v", "k1", "k2")}
    out = opt_from_numpy(plan, ref, device="cpu")
    for g in plan.groups:
        for n, t in out[g.key].items():
            want = ref[g.key][n]
            assert t.shape == (2, g.shard_len)
            assert t.dtype == (torch.float32 if n in ("k1", "k2")
                               else g.dtype)
            np.testing.assert_array_equal(
                t.float().numpy(), want.astype(np.float32).reshape(2, -1))
