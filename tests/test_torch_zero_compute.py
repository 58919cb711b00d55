"""The port's ZeroComputeEngine (``PHubEngine.make_zero_compute_step``)
against the JAX package's and against the port's own exchange.

1. W=1, in-process: three zero-compute steps against the reference's
   ``make_zero_compute_step`` on a (1, 1) mesh from the same weights.
   XLA:CPU contracts the jitted update ``p - lr * (g + mu * m)`` into FMAs
   (ROADMAP.md queue C), on its jnp path as in its interpret-mode Pallas
   kernel, so the port is within ``ULP_BOUND``, the 2-ulp bound
   ``tests/test_torch_agg_opt.py`` states, at the TrainConfig's lr and
   momentum; at power-of-two coefficients (lr 1/4, momentum 1/2) every
   product is exact, a contraction rounds as the separate operations do,
   and the port is bitwise equal to both paths.
2. W=2 and W=4: each step bitwise equal to ``exchange_stage`` run by hand
   on rows filled with ``p * 1e-4`` (the reference's synthetic push), over
   the identity wire and int8 in windows, and under a 3-of-4 membership
   (worker 2's row zeroed, the mean over 3); flat residency raises, as the
   reference's does.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro_torch import telemetry
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.elastic import Membership
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches

LR, MU = 0.05, 0.9
EXACT_LR, EXACT_MU = 0.25, 0.5          # powers of two: products exact
ULP_BOUND = 2
STEPS = 3


@pytest.fixture(autouse=True)
def _null_telemetry():
    yield
    telemetry.disable()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(d_model=128):
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=d_model),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=d_model), dtype="float32")
    return jcfg, pcfg


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    ia = a.astype(np.float32).view(np.int32).astype(np.int64)
    ib = b.astype(np.float32).view(np.int32).astype(np.int64)
    oa = np.where(ia < 0, -(2**31) - ia, ia)
    ob = np.where(ib < 0, -(2**31) - ib, ib)
    return int(np.abs(oa - ob).max())


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["jnp", "pallas-interpret"])
@pytest.mark.parametrize("lr,mu,bound", [(EXACT_LR, EXACT_MU, 0),
                                         (LR, MU, ULP_BOUND)],
                         ids=["exact-coefs", "default-coefs"])
def test_w1_matches_the_reference_zero_compute_step(use_pallas, lr, mu,
                                                    bound):
    jcfg, pcfg = _cfgs()
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(lr=lr, momentum=mu,
                                                 use_pallas=use_pallas),
                     mesh=mesh)
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    peng = PHubEngine(pcfg, TrainConfig(lr=lr, momentum=mu), StackedComm(1),
                      device="cpu")
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, jax.device_get(opt),
                          device="cpu")
    jstep = jeng.make_zero_compute_step()
    pstep = peng.make_zero_compute_step()
    reset_launches()
    for _ in range(STEPS):
        params, opt = jstep(params, opt)
        model, popt = pstep(model, popt)
    # CPU tensors take the plain version: no launch is counted
    assert all(c == 0 for c in LAUNCHES.values())
    ref = dict(leaf_paths(jax.device_get(params)))
    worst = 0
    for path, t in leaf_paths(model.param_tree()):
        got, want = t.detach().numpy(), np.asarray(ref[path])
        worst = max(worst, _ulps(got, want))
    jm = np.asarray(jax.device_get(opt)["float32"]["m"]).reshape(-1)
    pm = popt["float32"]["m"].numpy().reshape(-1)
    worst = max(worst, _ulps(pm, jm))
    assert worst <= bound, worst


def _by_hand(eng, model, opt, membership=None):
    """The exchange of one zero-compute step written out: every live
    worker's row p * 1e-4, excluded rows zero, ``exchange_stage``."""
    flat = eng.client.flatten(model.param_tree())
    W = eng.comm.n_workers
    rows = {k: torch.zeros((W, v.numel()), dtype=v.dtype)
            for k, v in flat.items()}
    mask, live = eng.client.elastic_mask(membership)
    for k, v in flat.items():
        for w in range(W):
            if mask is None or mask[w]:
                rows[k][w] = v * np.float32(1e-4)
    n_live = None if mask is None else eng.client.live_divisor(live)
    opt = {k: {n: t.clone() for n, t in d.items()} for k, d in opt.items()}
    return eng.exchange_stage(rows, {k: v.clone() for k, v in flat.items()},
                              opt, n_live)


CASES = [
    ("identity W=2", 2, {}, None),
    ("identity W=4", 4, {}, None),
    ("identity W=4 3-of-4", 4, {}, 2),
    ("int8 W=4 in 5 windows", 4,
     dict(wire_format="int8", pipeline_windows=5,
          chunk_size_bytes=28 * 1024), None),
    ("int8 W=2 in 5 windows 1-of-2 live", 2,
     dict(wire_format="int8", pipeline_windows=5,
          chunk_size_bytes=28 * 1024), 1),
    ("identity W=4 in 5 windows 3-of-4", 4,
     dict(pipeline_windows=5, chunk_size_bytes=28 * 1024), 0),
]


@pytest.mark.parametrize("label,W,fields,dead", CASES,
                         ids=[c[0] for c in CASES])
def test_zero_compute_equals_exchange_stage_by_hand(label, W, fields, dead):
    _, pcfg = _cfgs(d_model=64)
    eng = PHubEngine(pcfg, TrainConfig(lr=LR, momentum=MU, **fields),
                     StackedComm(W), device="cpu")
    if fields.get("pipeline_windows", 1) > 1:
        assert all(effective_windows(g, fields["pipeline_windows"]) > 1
                   for g in eng.chunk_plan.groups)
    membership = None if dead is None else Membership.full(W).leave(dead)
    model, opt = eng.init_state(seed=3)
    step = eng.make_zero_compute_step(membership)
    for _ in range(STEPS):
        want_p, want_opt = _by_hand(eng, model, opt, membership)
        model, opt = step(model, opt)
        got_p = eng.client.flatten(model.param_tree())
        for k in got_p:
            assert torch.equal(got_p[k], want_p[k]), (label, k)
            assert opt[k].keys() == want_opt[k].keys()
            for n in opt[k]:
                assert torch.equal(opt[k][n], want_opt[k][n]), (label, k, n)
    assert any(bool(t.abs().sum()) for d in opt.values() for t in d.values())


def test_zero_compute_refuses_flat_residency():
    _, pcfg = _cfgs(d_model=64)
    eng = PHubEngine(pcfg, TrainConfig(flat_residency=True), StackedComm(2),
                     device="cpu")
    with pytest.raises(ValueError, match="tree-state"):
        eng.make_zero_compute_step()
