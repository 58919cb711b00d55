"""The port's PHub train step against the JAX package's.

1. W=1: three port steps against the JAX ``PHubEngine`` on a (1, 1) mesh
   with ``use_pallas=True`` (the Pallas agg_opt kernel in interpret mode),
   from the same weights and batches.
2. W=4 stacked: two port steps against the data-parallel oracle of
   tests/multidevice/check_engine.py: JAX per-worker gradients, averaged,
   then the Nesterov rule of ``repro.optim.protocol.tree_update``.

Activations are float32, so the two sides differ only in the order f32
products and sums are taken, and (against the Pallas kernel) in XLA's FMA
contraction.  Stated bounds: losses to rtol 1e-5; momentum (which holds
the gradients' running sum) to 1e-4 of its largest entry per leaf, as the
gradients in tests/test_torch_model.py; parameters to 1e-6 absolute, which
is lr * (1 + momentum) * 3 steps times that gradient bound with room for
the magnitudes here (largest momentum entry below 0.1).
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
from repro.optim.protocol import NesterovOptimizer, tree_update
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths, unflatten_groups
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
from repro_torch.kernels.agg_opt.ref import (agg_opt_ref, multi_agg_opt_ref,
                                             worker_mean)
from repro_torch.optim.protocol import (NesterovOptimizer as PortNesterov,
                                        tuple_update)

T, LOSS_CHUNK, LR, MU, W4 = 32, 16, 0.05, 0.9, 4
LOSS_RTOL, MOM_TOL, PARAM_ATOL = 1e-5, 1e-4, 1e-6


def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype="float32")
    return jcfg, pcfg


def _assert_trees_close(port_tree, ref_tree, *, atol=None, rel=None):
    ref = dict(leaf_paths(ref_tree))
    got = dict(leaf_paths(port_tree))
    assert got.keys() == ref.keys()
    for path, t in got.items():
        r = np.asarray(ref[path], np.float32)
        err = np.abs(t.detach().numpy() - r).max()
        tol = atol if atol is not None else rel * np.abs(r).max()
        assert err <= tol, (path, err, tol)


def _port_momentum_tree(engine, opt, like):
    flats = {k: v["m"].reshape(-1) for k, v in opt.items()}
    return unflatten_groups(engine.chunk_plan, flats, like)


def test_w1_steps_match_jax_engine_with_pallas_kernel():
    jcfg, pcfg = _cfgs()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(lr=LR, momentum=MU,
                                                 use_pallas=True,
                                                 loss_chunk=LOSS_CHUNK),
                     mesh=mesh)
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    np_params, np_opt = jax.device_get(params), jax.device_get(opt)
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(shapes)

    peng = PHubEngine(pcfg, TrainConfig(lr=LR, momentum=MU,
                                        loss_chunk=LOSS_CHUNK),
                      StackedComm(1), device="cpu")
    model = params_from_numpy(pcfg, np_params, device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, np_opt, device="cpu")
    pstep = peng.make_train_step()
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)

    reset_launches()
    for i in range(3):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    # CPU tensors take the plain version: no kernel launch is counted
    assert all(c == 0 for c in LAUNCHES.values())
    _assert_trees_close(model.param_tree(), jax.device_get(params),
                        atol=PARAM_ATOL)
    jm_tree = jax.device_get(opt)["float32"]["m"]
    assert popt["float32"]["m"].shape == (1, jm_tree.shape[-1])
    np.testing.assert_allclose(
        popt["float32"]["m"].numpy().reshape(-1), jm_tree.reshape(-1),
        rtol=0, atol=MOM_TOL * np.abs(jm_tree).max())


def _worker_loss(jcfg, p, tokens, labels):
    x = forward(jcfg, p, tokens, remat=False)["x"]
    return jax_ce(x, lm_head_weight(jcfg, p), labels, chunk=LOSS_CHUNK)


@pytest.fixture(scope="module")
def w4_oracle():
    """Two data-parallel oracle steps from PRNGKey(1) weights: the initial
    weights, the batches, and the oracle's (params, m, losses)."""
    jcfg, pcfg = _cfgs()
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    init = jax.device_get(params)
    m = jax.tree.map(jnp.zeros_like, params)
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
        params, state = tree_update(NesterovOptimizer(), (LR, MU), params,
                                    gmean, {"m": m})
        m = state["m"]
        losses.append(float(np.mean(step_losses)))
    return init, data, jax.device_get(params), jax.device_get(m), losses


def test_w4_stacked_steps_match_data_parallel_oracle(w4_oracle):
    _, pcfg = _cfgs()
    init, data, ref_params, ref_m, ref_losses = w4_oracle
    peng = PHubEngine(pcfg, TrainConfig(lr=LR, momentum=MU,
                                        loss_chunk=LOSS_CHUNK),
                      StackedComm(W4), device="cpu")
    model = params_from_numpy(pcfg, init, device="cpu")
    popt = peng.init_opt()
    (group,) = peng.chunk_plan.groups
    assert popt["float32"]["m"].shape == (W4, group.shard_len)
    pstep = peng.make_train_step()
    for i in range(2):
        model, popt, pm = pstep(model, popt, data.torch_batch(i, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), ref_losses[i],
                                   rtol=LOSS_RTOL)
    _assert_trees_close(model.param_tree(), ref_params, atol=PARAM_ATOL)
    _assert_trees_close(_port_momentum_tree(peng, popt, model.param_tree()),
                        ref_m, rel=MOM_TOL)


@pytest.mark.parametrize("W", [1, 3])
def test_kernel_update_equals_plain_rule_bitwise(W):
    """The kernel wrapper (its plain version on the CPU) and the protocol's
    plain rule on the worker mean run the same arithmetic."""
    rng = np.random.default_rng(W)
    p, m = (torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((W, 3000)).astype(np.float32))
    g = g[0] if W == 1 else g
    opt = PortNesterov()
    a = opt.kernel_update(1024, (LR, MU))(p, g, (m,))
    g_mean = g if W == 1 else worker_mean(g)
    b = tuple_update(opt, (LR, MU))(p, g_mean, (m,))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0])


@pytest.mark.parametrize("W", [1, 4])
def test_engine_update_goes_through_the_kernel_wrapper(W):
    """The engine's update has one path, the kernel's entry point for the
    worker count (its plain version on the CPU), weight decay included:
    the kernel's ``+wd*p`` term against the plain versions'."""
    _, pcfg = _cfgs()
    wd = 0.1
    eng = PHubEngine(pcfg, TrainConfig(lr=LR, momentum=MU, weight_decay=wd),
                     StackedComm(W), device="cpu")
    rng = np.random.default_rng(W)
    p, m = (torch.from_numpy(rng.standard_normal(3000).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((W, 3000)).astype(np.float32))
    got_p, (got_m,) = eng.update_fn(eng.chunk_plan.groups[0])(
        p, g[0] if W == 1 else g, (m,))
    if W == 1:
        ref_p, ref_m = agg_opt_ref(p, g[0], m, lr=LR, momentum=MU,
                                   weight_decay=wd)
        plain_p, _ = agg_opt_ref(p, g[0], m, lr=LR, momentum=MU)
    else:
        ref_p, ref_m = multi_agg_opt_ref(p, g, m, lr=LR, momentum=MU,
                                         weight_decay=wd)
        plain_p, _ = multi_agg_opt_ref(p, g, m, lr=LR, momentum=MU)
    assert torch.equal(got_p, ref_p) and torch.equal(got_m, ref_m)
    assert not torch.equal(got_p, plain_p), "the decay term did nothing"


def test_launcher_runs_on_cpu_and_rejects_what_is_not_ported():
    from repro_torch.launch.train import main
    losses = main(["--reduced", "--device", "cpu", "--steps", "2",
                   "--batch", "4", "--seq", "16", "--workers", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    losses = main(["--reduced", "--device", "cpu", "--steps", "2",
                   "--batch", "4", "--seq", "16", "--workers", "2",
                   "--strategy", "fsdp_stream"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 4b"):
        main(["--reduced", "--device", "cpu", "--nproc", "2",
              "--strategy", "fsdp_stream"])
    losses = main(["--arch", "grok-1-314b", "--reduced", "--device", "cpu",
                   "--steps", "1", "--batch", "4", "--seq", "16",
                   "--workers", "2"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    with pytest.raises(ValueError, match="workers"):
        main(["--reduced", "--device", "cpu", "--steps", "1", "--batch", "3",
              "--seq", "16", "--workers", "2"])
