"""Gradient accumulation (``TrainConfig.microbatch``) in the port against
the JAX package's ``_local_grads``, and across the port's own paths.

1. W=1, k=2: two reduced llama3.2-1b steps against the reference's
   ``PHubEngine`` at ``microbatch=2`` on a one-device mesh, losses to rtol
   1e-5 and parameters to 1e-6 (``tests/test_torch_engine.py``'s bounds).
2. W=4, k=2 against the port's W=8, k=1 step (the same microbatches,
   averaged in another order) within ``tests/multidevice/check_engine.py``'s
   2e-4 on parameters and 3e-4 on the loss, the reference's own relation.
3. At k=2, windows, flat residency and chunk-ready dispatch (which degrades
   to after the backward) equal the monolithic tree-resident step
   bitwise (reduced d_model 64: 32 KB chunks give 5 windows at S = 4).
4. A worker slice that k does not divide raises the reference's error (a
   ``TypeError`` of its reshape).
5. A co-scheduled tenant at k=2 beside one at k=1 equals its solo run
   bitwise (each tenant its own k, as the reference's co-step).
6. One gloo spawn: a W=2, k=2 rank equals the stacked step bitwise, and
   the fsdp_stream strategy raises NotImplementedError citing ROADMAP.md
   queue A item 4b over the process group.
"""
import dataclasses
import hashlib
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro.data import SyntheticTokens as JaxTokens
from repro_torch.configs import TrainConfig, get_arch, reduced as preduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubConnectionManager, PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.data import SyntheticTokens
from repro_torch.launch import dist

T, LOSS_CHUNK, LR, MU = 32, 16, 0.05, 0.9
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6
ENGINE_PARAM_ATOL, ENGINE_LOSS_ATOL = 2e-4, 3e-4   # check_engine.py's
WINDOWS = 5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(n)


def _pcfg(d_model=128):
    return dataclasses.replace(preduced(get_arch("llama3.2-1b"),
                                        d_model=d_model), dtype="float32")


def _run(cfg, tc, W, batch=8, steps=2, seed=0):
    eng = PHubEngine(cfg, tc, StackedComm(W), device="cpu")
    model, opt = eng.init_state(seed)
    data = SyntheticTokens(cfg, batch, T, seed=4)
    step = eng.make_train_step()
    losses = []
    for i in range(steps):
        model, opt, m = step(model, opt, data.torch_batch(i, "cpu"))
        losses.append(float(m["loss"]))
    return eng, losses, {p: t.detach().clone()
                         for p, t in leaf_paths(model.param_tree())}


def test_w1_k2_steps_match_jax_engine():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = _pcfg()
    kw = dict(lr=LR, momentum=MU, microbatch=2, loss_chunk=LOSS_CHUNK)
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(use_pallas=False, **kw),
                     mesh=jax.make_mesh((1, 1), ("data", "model")))
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    peng = PHubEngine(pcfg, TrainConfig(**kw), StackedComm(1), device="cpu")
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, jax.device_get(opt),
                          device="cpu")
    jdata, pdata = JaxTokens(jcfg, 4, T, seed=2), SyntheticTokens(pcfg, 4, T,
                                                                  seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep, pstep = jeng.make_train_step(shapes), peng.make_train_step()
    for i in range(2):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=LOSS_RTOL)
    ref = dict(leaf_paths(jax.device_get(params)))
    for path, t in leaf_paths(model.param_tree()):
        err = np.abs(t.detach().numpy() - np.asarray(ref[path])).max()
        assert err <= PARAM_ATOL, (path, err)
    # the slice that k does not divide: both packages raise a TypeError
    odd = {k: v[:3] for k, v in jdata.batch_at(0).items()}
    with pytest.raises(TypeError):
        jeng.make_train_step({k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                              for k, v in odd.items()})(
            params, opt, {k: jax.numpy.asarray(v) for k, v in odd.items()})
    with pytest.raises(TypeError, match="microbatches"):
        pstep(model, popt, {k: v[:3] for k, v in
                            pdata.torch_batch(0, "cpu").items()})


def test_w4_k2_tracks_w8_k1():
    cfg = _pcfg()
    _, a_loss, a = _run(cfg, TrainConfig(lr=LR, microbatch=2,
                                         loss_chunk=LOSS_CHUNK), 4)
    _, b_loss, b = _run(cfg, TrainConfig(lr=LR, loss_chunk=LOSS_CHUNK), 8)
    assert np.abs(np.array(a_loss) - np.array(b_loss)).max() <= \
        ENGINE_LOSS_ATOL
    for path, t in a.items():
        assert (t - b[path]).abs().max().item() <= ENGINE_PARAM_ATOL, path
    _, _, start = _run(cfg, TrainConfig(lr=LR, loss_chunk=LOSS_CHUNK), 4,
                       steps=0)
    assert max((t - start[p]).abs().max().item() for p, t in a.items()) \
        > 5 * ENGINE_PARAM_ATOL, "the steps barely moved"


MODES = {"windows": dict(pipeline_windows=WINDOWS),
         "flat": dict(flat_residency=True),
         "windows-flat-chunk-ready": dict(pipeline_windows=WINDOWS,
                                          flat_residency=True,
                                          overlap_backward=True)}


@pytest.mark.parametrize("mode", list(MODES))
def test_k2_modes_equal_monolithic_bitwise(mode):
    cfg = _pcfg(64)
    base = TrainConfig(lr=LR, microbatch=2, loss_chunk=LOSS_CHUNK)
    _, want_loss, want = _run(cfg, base, 4)
    eng, got_loss, got = _run(cfg, dataclasses.replace(base, **MODES[mode]),
                              4)
    if "windows" in mode:
        assert [effective_windows(g, WINDOWS)
                for g in eng.chunk_plan.groups] == [WINDOWS]
    assert got_loss == want_loss
    for path, t in got.items():
        assert torch.equal(t, want[path]), path


def test_co_step_tenant_at_k2_equals_its_solo_run():
    cfg = preduced(get_arch("llama3.2-1b"), d_model=64)
    tcs = {"A": TrainConfig(loss_chunk=16, microbatch=2),
           "B": TrainConfig(loss_chunk=16, lr=5e-3)}
    comm = StackedComm(2)
    data = {ns: SyntheticTokens(cfg, 4, 16, seed=i)
            for i, ns in enumerate(tcs)}
    solo = {}
    for i, (ns, tc) in enumerate(tcs.items()):
        eng = PHubEngine(cfg, tc, comm, device="cpu")
        model, opt = eng.init_state(i)
        step = eng.make_train_step()
        for s in range(2):
            model, opt, _ = step(model, opt, data[ns].torch_batch(s, "cpu"))
        solo[ns] = dict(leaf_paths(model.param_tree()))
    cm = PHubConnectionManager()
    hs = {ns: cm.create_service(ns, cfg, tc, comm, device="cpu")
          for ns, tc in tcs.items()}
    models = {ns: cm.init_service(h, i)[0]
              for i, (ns, h) in enumerate(hs.items())}
    cm.attach_services(list(hs.values()))
    for s in range(2):
        models, _ = cm.co_step(list(hs.values()), models,
                               {ns: d.torch_batch(s, "cpu")
                                for ns, d in data.items()})
    for ns in tcs:
        for path, t in leaf_paths(models[ns].param_tree()):
            assert torch.equal(t.detach(), solo[ns][path].detach()), \
                (ns, path)


# ---------------------------------------------------- one gloo spawn, W = 2

def _digests(model) -> dict:
    return {p: hashlib.sha1(t.detach().contiguous().view(-1)
                            .view(torch.uint8).numpy().tobytes()).hexdigest()
            for p, t in leaf_paths(model.param_tree())}


def _train_digests(comm):
    cfg = _pcfg()
    eng = PHubEngine(cfg, TrainConfig(lr=LR, microbatch=2,
                                      loss_chunk=LOSS_CHUNK), comm,
                     device="cpu")
    model, opt = eng.init_state()
    data = SyntheticTokens(cfg, 8, T, seed=4)
    step = eng.make_train_step()
    losses = []
    for i in range(2):
        model, opt, m = step(model, opt, data.torch_batch(i, "cpu"))
        losses.append(float(m["loss"]))
    return losses, _digests(model)


def _rank_run(comm, device):
    torch.use_deterministic_algorithms(True)
    out = {"k2": _train_digests(comm)}
    try:
        PHubEngine(_pcfg(), TrainConfig(strategy="fsdp_stream"), comm,
                   device="cpu")
        out["fsdp"] = (None, "returned")
    except Exception as e:                         # the type is the check
        out["fsdp"] = (type(e).__name__, str(e))
    return out


def test_process_group_k2_equals_stacked_and_refuses_fsdp():
    init = "file://" + os.path.join(tempfile.mkdtemp(), "pg_init")
    ranks = dist.run(_rank_run, 2, "gloo", "cpu", 600.0, init_method=init,
                     threads=1)
    want = _train_digests(StackedComm(2))
    for r in ranks:
        assert r["k2"] == want
        kind, msg = r["fsdp"]
        assert kind == "NotImplementedError", (kind, msg)
        assert "queue A item 4b" in msg and "fsdp_stream" in msg
