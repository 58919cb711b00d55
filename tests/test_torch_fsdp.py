"""The fsdp_stream strategy on the stacked Comm against the JAX package's.

1. The reference's ``PHubEngine`` with ``strategy="fsdp_stream"`` on a
   ``(data=4, model=1)`` mesh of forced host devices built with
   ``AxisType.Auto`` axes, in one subprocess: reduced llama3.2-1b (d_model
   128, f32 activations), one step each under Nesterov with weight decay,
   Adam, and ``microbatch=2``, from the reference's weights, against the
   port's W=4 fsdp_stream step within ``tests/multidevice/check_engine.py``'s
   2e-4 on parameters and 3e-4 on the loss; the optimizer state is the
   reference's ``{slot: tree}`` (``convert.fsdp_opt_from_numpy``).
2. The port's fsdp_stream step against its own sharded_ps step (Nesterov
   with decay, SGD, Adam), within the same bounds.
3. The refusals: flat residency, chunk-ready dispatch, an encoded wire, a
   membership that is not all live, the sanity gate and the zero-compute
   step raise the reference's exception types with the reference's
   messages (the subprocess records the reference's); ``PHubClient`` and
   co-scheduling raise the reference's ``ValueError``.  Windows raise a
   ``ValueError`` in the port (the reference's engine ignores them: an
   fsdp_stream step has no chunk domain to window).
4. A checkpoint round trip (save after a step, restore, one more step
   each) and a 4 -> 3 -> 4 resize of an fsdp_stream service through
   ``PHubConnectionManager.resize``: the state comes back bitwise, and a
   step after the round trip equals a step of a run that never resized,
   bitwise.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_train_state, save_checkpoint, \
    snapshot_tree
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.convert import fsdp_opt_from_numpy, params_from_numpy
from repro_torch.core import (PHubClient, PHubConnectionManager, PHubEngine,
                              StackedComm)
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import Membership
from repro_torch.resilience import SanityConfig

B, T, LOSS_CHUNK = 8, 32, 16
PARAM_ATOL, LOSS_ATOL = 2e-4, 3e-4          # check_engine.py's
STEPS = {"nesterov-decay": dict(lr=0.05, weight_decay=0.1),
         "adam": dict(optimizer="adam", lr=5e-3, adam_eps=1e-3),
         "microbatch": dict(lr=0.05, microbatch=2)}
REFUSALS = {"flat_residency": dict(flat_residency=True),
            "overlap_backward": dict(overlap_backward=True),
            "wire": dict(wire_format="int8"),
            "membership": {}, "sanity": {}, "zero_compute": {}}
TIMEOUT = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)
    torch.set_num_threads(n)


def _cfg(d_model=128):
    return dataclasses.replace(reduced(get_arch("llama3.2-1b"),
                                       d_model=d_model), dtype="float32")


_REF_SCRIPT = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import ARCHS, TrainConfig, reduced
from repro.core import PHubEngine
from repro.data import SyntheticTokens
from repro.elastic.membership import Membership
from repro.resilience.sanity import SanityConfig

spec_path, dst, err_path = sys.argv[1:4]
spec = json.load(open(spec_path))
Auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((4, 1), ("data", "model"), axis_types=(Auto, Auto))
cfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                          dtype="float32")
data = SyntheticTokens(cfg, spec["B"], spec["T"], seed=3)
shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
          for k, v in data.batch_at(0).items()}
out = {}


def put(prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(tree)):
        out[prefix + jax.tree_util.keystr(path)] = np.asarray(leaf,
                                                              np.float32)


for name, kw in spec["steps"].items():
    eng = PHubEngine(cfg=cfg, tc=TrainConfig(strategy="fsdp_stream",
                                             loss_chunk=spec["loss_chunk"],
                                             **kw), mesh=mesh)
    params, opt = eng.init_state(jax.random.PRNGKey(0))
    put("init/", params)
    params, opt, m = eng.make_train_step(shapes)(params, opt,
                                                  data.device_batch(0))
    out[name + "/loss"] = np.asarray(float(m["loss"]))
    put(name + "/params/", params)
    put(name + "/opt/", opt)

errors = {}
base = TrainConfig(strategy="fsdp_stream")
for name, kw in spec["refusals"].items():
    try:
        eng = PHubEngine(cfg=cfg, tc=dataclasses.replace(base, **kw),
                         mesh=mesh)
        if name == "membership":
            eng.make_train_step(shapes,
                                membership=Membership.full(4).leave(1))
        elif name == "sanity":
            eng.make_train_step(shapes, sanity=SanityConfig())
        elif name == "zero_compute":
            eng.make_zero_compute_step()
        errors[name] = [None, "returned"]
    except Exception as e:
        errors[name] = [type(e).__name__, str(e)]
np.savez(dst, **out)
json.dump(errors, open(err_path, "w"))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fsdp_ref")
    spec, dst, err = (os.path.join(tmp, f) for f in
                      ("spec.json", "out.npz", "errors.json"))
    with open(spec, "w") as f:
        json.dump({"steps": STEPS, "refusals": REFUSALS, "B": B, "T": T,
                   "loss_chunk": LOSS_CHUNK}, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(root, "src"))
    run = subprocess.run([sys.executable, "-c", _REF_SCRIPT, spec, dst, err],
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert run.returncode == 0, run.stderr[-4000:]
    with open(err) as f:
        return dict(np.load(dst)), json.load(f)


def _nest(flat: dict, prefix: str) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        if not key.startswith(prefix):
            continue
        parts = [k.strip("'") for k in key[len(prefix) + 1:-1].split("][")]
        node = tree
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return tree


def _step(eng, model, opt, batch):
    return eng.make_train_step()(model, opt, batch)


@pytest.mark.parametrize("name", list(STEPS))
def test_w4_fsdp_step_matches_reference_engine(name, reference):
    arrays, _ = reference
    cfg = _cfg()
    eng = PHubEngine(cfg, TrainConfig(strategy="fsdp_stream",
                                      loss_chunk=LOSS_CHUNK, **STEPS[name]),
                     StackedComm(4), device="cpu")
    init = _nest(arrays, "init/")
    model = params_from_numpy(cfg, init, device="cpu")
    opt = eng.init_opt()
    assert set(opt) == set(eng.sopt.slot_names)
    model, opt, metrics = _step(eng, model, opt,
                                SyntheticTokens(cfg, B, T, seed=3)
                                .torch_batch(0, "cpu"))
    assert abs(float(metrics["loss"]) - float(arrays[name + "/loss"])) <= \
        LOSS_ATOL
    want = dict(leaf_paths(_nest(arrays, name + "/params/")))
    moved = 0.0
    for path, t in leaf_paths(model.param_tree()):
        err = np.abs(t.detach().numpy() - want[path]).max()
        assert err <= PARAM_ATOL, (path, err)
        moved = max(moved, np.abs(want[path] - dict(leaf_paths(init))[path])
                    .max())
    assert moved > 5 * PARAM_ATOL, "the step barely moved"
    # the reference's {slot: tree} carries over, leaf for leaf; Adam's
    # k1/k2 tick only where the gradient is not exactly 0, and a gradient
    # that cancels to 0 in one summation order is a few 1e-10 in the
    # other, so a flipped tick is allowed exactly where m is that small
    ref_opt = {n: _nest(arrays, f"{name}/opt/['{n}']")
               for n in eng.sopt.slot_names}
    got_opt = fsdp_opt_from_numpy(cfg, ref_opt, slots=eng.exchange_slots,
                                  device="cpu")
    assert set(got_opt) == set(opt)
    for n in opt:
        ref_leaves = dict(leaf_paths(got_opt[n]))
        for path, t in leaf_paths(opt[n]):
            r = ref_leaves[path]
            if n in ("k1", "k2"):
                m, rm = dict(leaf_paths(opt["m"]))[path], \
                    dict(leaf_paths(got_opt["m"]))[path]
                flip = t != r
                tiny = 1e-6 * float(rm.abs().max())
                assert bool(((m[flip] == 0) | (rm[flip] == 0)).all())
                assert bool((torch.maximum(m[flip].abs(),
                                           rm[flip].abs()) <= tiny).all())
                continue
            scale = float(r.abs().max())
            assert float((t - r).abs().max()) <= 2e-4 * scale, (n, path)


@pytest.mark.parametrize("rule", ["nesterov-decay", "sgd", "adam"])
def test_fsdp_step_tracks_sharded_ps_step(rule):
    cfg = _cfg(64)
    kw = dict(STEPS.get(rule, dict(optimizer="sgd", lr=0.05)),
              loss_chunk=LOSS_CHUNK)
    data = SyntheticTokens(cfg, B, T, seed=1)
    out = {}
    for st in ("sharded_ps", "fsdp_stream"):
        eng = PHubEngine(cfg, TrainConfig(strategy=st, **kw), StackedComm(4),
                         device="cpu")
        model, opt = eng.init_state(0)
        step = eng.make_train_step()
        losses = []
        for i in range(2):
            model, opt, m = step(model, opt, data.torch_batch(i, "cpu"))
            losses.append(float(m["loss"]))
        out[st] = losses, dict(leaf_paths(model.param_tree()))
    (la, pa), (lb, pb) = out["sharded_ps"], out["fsdp_stream"]
    assert np.abs(np.array(la) - np.array(lb)).max() <= LOSS_ATOL
    for path, t in pa.items():
        assert float((t - pb[path]).detach().abs().max()) <= PARAM_ATOL, \
            path


def test_refusals_match_the_reference(reference):
    _, ref_errors = reference
    cfg = _cfg(64)
    base = TrainConfig(strategy="fsdp_stream")
    got = {}
    for name, kw in REFUSALS.items():
        try:
            eng = PHubEngine(cfg, dataclasses.replace(base, **kw),
                             StackedComm(4), device="cpu")
            if name == "membership":
                eng.make_train_step(membership=Membership.full(4).leave(1))
            elif name == "sanity":
                eng.make_train_step(sanity=SanityConfig())
            elif name == "zero_compute":
                eng.make_zero_compute_step()
            got[name] = [None, "returned"]
        except Exception as e:                      # the type is the check
            got[name] = [type(e).__name__, str(e)]
    for name, (kind, msg) in ref_errors.items():
        assert kind is not None, f"the reference accepts {name}"
        assert got[name][0] == kind, (name, got[name], kind)
        # the port's messages are the reference's, but for the wire's,
        # whose strategy lists are the port's
        key = msg.split(";")[0] if name == "wire" else msg
        assert key in got[name][1], (name, got[name][1], msg)
    with pytest.raises(ValueError, match="shard dimension"):
        PHubEngine(cfg, dataclasses.replace(base, pipeline_windows=2),
                   StackedComm(4), device="cpu")
    with pytest.raises(ValueError, match="no chunk domain"):
        PHubClient(base, StackedComm(4), device="cpu")
    cm = PHubConnectionManager()
    h = cm.create_service("fsdp", cfg, base, StackedComm(4), device="cpu")
    with pytest.raises(ValueError, match="chunk domain to pack"):
        cm.attach_service(h)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in tree.items()}


def _assert_trees_equal(a: dict, b: dict):
    la, lb = dict(leaf_paths(a)), dict(leaf_paths(b))
    assert la.keys() == lb.keys()
    for path, t in la.items():
        assert t.dtype == lb[path].dtype and torch.equal(t, lb[path]), path


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    cfg = _cfg(64)
    eng = PHubEngine(cfg, TrainConfig(strategy="fsdp_stream",
                                      **STEPS["adam"]), StackedComm(4),
                     device="cpu")
    data = SyntheticTokens(cfg, B, T, seed=2)
    model, opt = eng.init_state(0)
    step = eng.make_train_step()
    model, opt, _ = step(model, opt, data.torch_batch(0, "cpu"))
    save_checkpoint(str(tmp_path), 1, snapshot_tree(model, opt))
    s, model2, opt2 = restore_train_state(str(tmp_path), eng)
    assert s == 1
    _assert_trees_equal(model2.param_tree(), model.param_tree())
    for n in opt:
        _assert_trees_equal(opt2[n], opt[n])
    model, opt, _ = step(model, opt, data.torch_batch(1, "cpu"))
    model2, opt2, _ = step(model2, opt2, data.torch_batch(1, "cpu"))
    _assert_trees_equal(model2.param_tree(), model.param_tree())
    # a snapshot of another strategy's layout is refused
    other = PHubEngine(cfg, TrainConfig(**STEPS["adam"]), StackedComm(4),
                       device="cpu")
    with pytest.raises(ValueError, match="opt slot"):
        restore_train_state(str(tmp_path), other)


def test_resize_4_3_4_is_bitwise():
    cfg = _cfg(64)
    tc = TrainConfig(strategy="fsdp_stream", **STEPS["nesterov-decay"])
    data = SyntheticTokens(cfg, B, T, seed=5)
    cm = PHubConnectionManager()
    h = cm.create_service("A", cfg, tc, StackedComm(4), device="cpu")
    model, opt = cm.init_service(h, 0)
    model, opt, _ = cm.push_pull(h, model, opt, data.torch_batch(0, "cpu"))
    snap_p, snap_o = _clone(model.param_tree()), _clone(opt)
    model, opt = cm.resize(StackedComm(3), states={"A": (model, opt)})["A"]
    assert cm.connect_service(h).comm.n_workers == 3
    _assert_trees_equal(model.param_tree(), snap_p)
    _assert_trees_equal(opt, snap_o)
    m3, o3 = copy.deepcopy(model), _clone(opt)
    batch6 = {k: v[:6] for k, v in data.torch_batch(1, "cpu").items()}
    m3, o3, met = cm.push_pull(h, m3, o3, batch6)
    assert np.isfinite(float(met["loss"]))
    model, opt = cm.resize(StackedComm(4), states={"A": (model, opt)})["A"]
    _assert_trees_equal(model.param_tree(), snap_p)
    _assert_trees_equal(opt, snap_o)
    model, opt, _ = cm.push_pull(h, model, opt, data.torch_batch(1, "cpu"))
    # a run that never resized
    eng = PHubEngine(cfg, tc, StackedComm(4), device="cpu")
    ref, ropt = eng.init_state(0)
    step = eng.make_train_step()
    for i in range(2):
        ref, ropt, _ = step(ref, ropt, data.torch_batch(i, "cpu"))
    _assert_trees_equal(model.param_tree(), ref.param_tree())
    _assert_trees_equal(opt, ropt)
