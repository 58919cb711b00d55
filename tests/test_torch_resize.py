"""The port's elastic rack resize (``core/api.py::PHubConnectionManager.
resize``, ``elastic/rebalance.py::migrate_engine_state``, the checkpoint
restore at another world size) against the JAX package's.

The reference runs in one subprocess on 12 forced host devices, its meshes
built with ``AxisType.Auto`` (ROADMAP.md queue C): reduced llama3.2-1b
(d_model 64), Adam over the int8 wire in 2 windows, 1 KB chunks, as its
``tests/multidevice/check_elastic.py`` (``check_resize``,
``check_padtail``, ``check_checkpoint``) runs them.  Every slot comparison
is bitwise; the losses of steps taken on both sides hold to the rtol of
the port's engine-parity tests (1e-5).

1. Solo, caller-held state, 8 -> 6 -> 8: the port's own trained slots
   (m, v, k1, k2, wire_ef) equal their pre-resize values on the live
   region, the epoch is 2 and training goes on; the same injected state
   moved by both packages is equal after each resize, pad included.
2. Steps at worlds 8, 6 and 8 from the reference's weights: the losses
   within LOSS_RTOL of the reference's.
3. Padtail: a round trip between steps 2 and 3 of a 4-step run equals the
   run that never resized, on the full buffers.
4. Two co-scheduled tenants, 8 -> 6 -> 8: after detach each tenant's slots
   equal their pre-resize values on the live region; the same injected
   state gives the reference's packed buffers at world 6 and its
   ``last_rebalance`` (``moved_bytes`` > 0); a co-step afterwards is
   finite.
5. A snapshot the reference wrote at world 8 restores here at 6 and 12,
   equal to the reference's own restore; the port's own snapshots (tree
   and flat store) restore at 6 and 12 bitwise on live regions and
   training goes on; the same world at another epoch still fails, naming
   both epochs.
6. Over a ``ProcessGroupComm`` (gloo, 2 ranks) ``resize`` raises, citing
   queue A item 4b.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (restore_train_state, save_checkpoint,
                                    snapshot_tree)
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core import PHubConnectionManager, PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import Membership
from repro_torch.launch import dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 1024
B, T = 24, 32                    # the batch splits over worlds 6, 8, 12
LOSS_RTOL = 1e-5                 # tests/test_torch_engine_wire.py's
ADAM_EPS = 1e-3                  # Lipschitz in g (test_torch_engine_optim)
D_MODELS = {"A": 64, "B": 128}
LRS = {"A": 1e-3, "B": 3e-3}
TIMEOUT = 900
SLOTS = ("m", "v", "k1", "k2", "wire_ef")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def deterministic():
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(False)


def cfg_of(d_model=64, f32=False):
    cfg = reduced(get_arch("llama3.2-1b"), d_model=d_model)
    return dataclasses.replace(cfg, dtype="float32") if f32 else cfg


def tc_of(**kw) -> TrainConfig:
    base = dict(strategy="sharded_ps", optimizer="adam", lr=1e-3,
                loss_chunk=32, pipeline_windows=2, wire_format="int8",
                chunk_size_bytes=CHUNK)
    return TrainConfig(**dict(base, **kw))


def batch(cfg, seed=0):
    return SyntheticTokens(cfg, B, T, seed=seed).torch_batch(0, "cpu")


def live_rows(eng, opt) -> dict:
    """{slot: (R, live_elems)} copies of each slot's live region."""
    (g,) = eng.chunk_plan.groups
    return {n: v.reshape(-1, g.padded)[:, :g.live_elems].clone()
            for n, v in opt[g.key].items()}


def full_rows(opt) -> dict:
    return {n: v.reshape(-1).clone() for n, v in opt["float32"].items()}


# --------------------------------------------- the reference, one spawn

_REF_SCRIPT = r"""
import dataclasses
import json
import sys

import jax
import numpy as np

from repro.checkpoint import restore_train_state, save_checkpoint
from repro.configs import ARCHS, TrainConfig, reduced
from repro.core import PHubConnectionManager, PHubEngine
from repro.data import SyntheticTokens
from repro.elastic import Membership

spec = json.load(open(sys.argv[1]))
d = np.load(sys.argv[2])
dst, ckdir = sys.argv[3], sys.argv[4]
Auto = jax.sharding.AxisType.Auto
out, meta = {}, {}


def mesh_of(n):
    return jax.make_mesh((n, 1), ("data", "model"), axis_types=(Auto,) * 2,
                         devices=jax.devices()[:n])


def cfg_of(d_model, f32=False):
    cfg = reduced(ARCHS["llama3.2-1b"], d_model=d_model)
    return dataclasses.replace(cfg, dtype="float32") if f32 else cfg


def engine_opt(eng, flats):
    shapes = eng.opt_state_shapes()
    return {k: {n: np.asarray(flats[n], sd.dtype).reshape(sd.shape)
                for n, sd in slots.items()} for k, slots in shapes.items()}


def dump(prefix, opt):
    for key, slots in opt.items():
        for n, v in slots.items():
            out[f"{prefix}/{n}"] = np.asarray(v).reshape(-1)


def device_batch(eng, cfg, seed):
    b = SyntheticTokens(cfg, spec["B"], spec["T"], seed=seed).batch_at(0)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b.items()}
    return {k: jax.device_put(v, s) for (k, v), s in
            zip(b.items(), eng.batch_shardings(shapes).values())}


# 1. solo, an injected state moved 8 -> 6 -> 8
cm = PHubConnectionManager()
h = cm.create_service("job", cfg_of(64), TrainConfig(**spec["tc"]),
                      mesh_of(8))
p, _ = cm.init_service(h, jax.random.PRNGKey(0))
o = engine_opt(cm.connect_service(h),
               {n: d[f"solo/{n}"] for n in spec["slots"]})
p, o = cm.resize(mesh_of(6), states={"job": (p, o)})["job"]
dump("solo6", o)
meta["solo6"] = cm.last_rebalance
p, o = cm.resize(mesh_of(8), states={"job": (p, o)})["job"]
dump("solo8", o)
meta["solo_epoch"] = cm.membership.epoch

# 4. two co-scheduled tenants, injected states
cm = PHubConnectionManager()
hs, opts = [], {}
for ns, dm in spec["d_models"].items():
    hh = cm.create_service(ns, cfg_of(dm), TrainConfig(
        **dict(spec["tc"], lr=spec["lrs"][ns])), mesh_of(8))
    opts[ns] = engine_opt(cm.connect_service(hh),
                          {n: d[f"co/{ns}/{n}"] for n in spec["slots"]})
    hs.append(hh)
cm.attach_services(hs, opts)
cm.resize(mesh_of(6))
dump("co6", cm._co.opt)
meta["co6"] = cm.last_rebalance
cm.resize(mesh_of(8))
meta["co8"] = cm.last_rebalance
for hh in hs:
    dump(f"codet/{hh.namespace}", cm.detach_service(hh))

# 2. steps at worlds 8, 6, 8 from seed 1's weights (f32 activations),
# and 5. the snapshot after the first one
tc = TrainConfig(**dict(spec["tc"], adam_eps=spec["adam_eps"]))
cfg = cfg_of(64, f32=True)
cm = PHubConnectionManager()
h = cm.create_service("mid", cfg, tc, mesh_of(8))
p, o = cm.init_service(h, jax.random.PRNGKey(1))
for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
    out["p0/" + jax.tree_util.keystr(path)] = np.asarray(v)
losses = []
for world in (8, 6, 8):
    if world != 8 or losses:
        p, o = cm.resize(mesh_of(world), states={"mid": (p, o)})["mid"]
    eng = cm.connect_service(h)
    p, o, m = cm.push_pull(h, p, o, device_batch(eng, cfg, 1))
    losses.append(float(m["loss"]))
    if len(losses) == 1:
        m8 = Membership.full(8).leave(2).join(2)        # epoch 2
        save_checkpoint(ckdir, 1, {"params": p, "opt": o}, membership=m8)
        dump("ck8", o)
        for w in (6, 12):
            _, _, ow = restore_train_state(ckdir, PHubEngine(
                cfg=cfg, tc=tc, mesh=mesh_of(w)))
            dump(f"ck{w}", ow)
meta["losses"] = losses
json.dump(meta, open(dst + ".json", "w"))
np.savez(dst, **out)
"""


def injected(eng, seed) -> dict:
    """Integer-valued slots on the live region, zero on the pad: {slot:
    (padded,) f32}."""
    (g,) = eng.chunk_plan.groups
    rng = np.random.default_rng(seed)
    out = {}
    for n in SLOTS:
        a = np.zeros(g.padded, np.float32)
        a[:g.live_elems] = rng.integers(-4, 5, g.live_elems)
        out[n] = a
    return out


def to_opt(eng, flats) -> dict:
    (g,) = eng.chunk_plan.groups
    return {g.key: {s.name: torch.from_numpy(flats[s.name].copy()).view(
        eng.slot_shape(g, s)) for s in eng.exchange_slots}}


def solo_engine(d_model=64, W=8, **kw):
    return PHubEngine(cfg_of(d_model), tc_of(**kw), StackedComm(W),
                      device="cpu")


@functools.lru_cache(maxsize=None)
def reference_results(tmp: str) -> tuple:
    arrays = {f"solo/{n}": v for n, v in injected(solo_engine(), 0).items()}
    for i, (ns, dm) in enumerate(D_MODELS.items()):
        arrays.update({f"co/{ns}/{n}": v for n, v in
                       injected(solo_engine(dm), 10 + i).items()})
    spec, src, dst, ckdir = (os.path.join(tmp, f) for f in
                             ("spec.json", "in.npz", "out.npz", "ck"))
    tc = dict(strategy="sharded_ps", optimizer="adam", lr=1e-3,
              loss_chunk=32, pipeline_windows=2, wire_format="int8",
              chunk_size_bytes=CHUNK)
    with open(spec, "w") as f:
        json.dump({"tc": tc, "slots": SLOTS, "d_models": D_MODELS,
                   "lrs": LRS, "adam_eps": ADAM_EPS, "B": B, "T": T}, f)
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=12",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _REF_SCRIPT, spec, src, dst,
                          ckdir], env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert res.returncode == 0, res.stderr[-4000:]
    with open(dst + ".json") as f:
        meta = json.load(f)
    return dict(np.load(dst)), meta, arrays, ckdir


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_results(str(tmp_path_factory.mktemp("ref_resize")))


# ------------------------------------------------------------ 1. solo

def test_solo_resize_keeps_trained_slots_and_training_goes_on():
    cfg = cfg_of()
    cm = PHubConnectionManager()
    h = cm.create_service("job", cfg, tc_of(), StackedComm(8), device="cpu")
    m, o = cm.init_service(h)
    for _ in range(2):
        m, o, _ = cm.push_pull(h, m, o, batch(cfg))
    eng = cm.connect_service(h)
    pre = live_rows(eng, o)
    assert float(pre["wire_ef"].abs().max()) > 0
    m, o = cm.resize(StackedComm(6), states={"job": (m, o)})["job"]
    assert cm.connect_service(h).comm.n_workers == 6
    m, o = cm.resize(StackedComm(8), states={"job": (m, o)})["job"]
    eng = cm.connect_service(h)
    post = live_rows(eng, o)
    assert set(post) == set(SLOTS)
    for n in SLOTS:
        assert torch.equal(post[n], pre[n]), n
    assert cm.membership.epoch == 2 and cm.membership.world == 8
    m, o, met = cm.push_pull(h, m, o, batch(cfg))
    assert np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("world", [6, 8])
def test_solo_resize_equals_the_reference(reference, world):
    ref, meta, arrays, _ = reference
    cm = PHubConnectionManager()
    h = cm.create_service("job", cfg_of(), tc_of(), StackedComm(8),
                          device="cpu")
    m, _ = cm.init_service(h)
    o = to_opt(cm.connect_service(h),
               {n: arrays[f"solo/{n}"] for n in SLOTS})
    m, o = cm.resize(StackedComm(6), states={"job": (m, o)})["job"]
    if world == 6:
        assert cm.last_rebalance == meta["solo6"]
        assert cm.last_rebalance["solo"]["job"]["moved_bytes"] == 0
    else:
        m, o = cm.resize(StackedComm(8), states={"job": (m, o)})["job"]
        assert cm.membership.epoch == meta["solo_epoch"] == 2
    eng = cm.connect_service(h)
    (g,) = eng.chunk_plan.groups
    for n, v in full_rows(o).items():
        np.testing.assert_array_equal(v.numpy(), ref[f"solo{world}/{n}"],
                                      err_msg=n)
        np.testing.assert_array_equal(v.numpy()[:g.live_elems],
                                      arrays[f"solo/{n}"][:g.live_elems])
        assert not v[g.live_elems:].any()


# -------------------------------------------- 2. steps across a resize

def test_steps_at_worlds_8_6_8_match_the_reference(reference):
    ref, meta, _, _ = reference
    cfg = cfg_of(f32=True)
    tree: dict = {}
    for key, v in ref.items():
        if not key.startswith("p0/"):
            continue
        node = tree
        keys = [k.strip("'") for k in key[3:][1:-1].split("][")]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = v
    cm = PHubConnectionManager()
    h = cm.create_service("mid", cfg, tc_of(adam_eps=ADAM_EPS),
                          StackedComm(8), device="cpu")
    m = params_from_numpy(cfg, tree, device="cpu")
    o = cm.connect_service(h).init_opt()
    losses = []
    for world in (8, 6, 8):
        if losses:
            m, o = cm.resize(StackedComm(world),
                             states={"mid": (m, o)})["mid"]
        m, o, met = cm.push_pull(h, m, o, batch(cfg, 1))
        losses.append(float(met["loss"]))
    np.testing.assert_allclose(losses, meta["losses"], rtol=LOSS_RTOL)


# ---------------------------------------------------------- 3. padtail

def _pad_nonzero(eng, opt, slots=("k1", "k2")) -> int:
    (g,) = eng.chunk_plan.groups
    return sum(int((opt[g.key][n].reshape(-1, g.padded)[:, g.live_elems:]
                    != 0).sum()) for n in slots)


def test_padtail_round_trip_equals_the_run_that_never_resized():
    cfg = cfg_of()

    def run(resize: bool):
        cm = PHubConnectionManager()
        h = cm.create_service("pad", cfg, tc_of(), StackedComm(8),
                              device="cpu")
        m, o = cm.init_service(h)
        for i in range(4):
            if resize and i == 2:
                s = cm.resize(StackedComm(6), states={"pad": (m, o)})
                m, o = cm.resize(StackedComm(8), states=s)["pad"]
            m, o, _ = cm.push_pull(h, m, o, batch(cfg))
        return cm.connect_service(h), m, o

    eng, m0, o0 = run(False)
    assert _pad_nonzero(eng, o0) == 0
    _, m1, o1 = run(True)
    for n in SLOTS:
        assert torch.equal(o1["float32"][n], o0["float32"][n]), n
    for (_, a), (_, b) in zip(leaf_paths(m0.param_tree()),
                              leaf_paths(m1.param_tree())):
        assert torch.equal(a, b)


# ------------------------------------------------- 4. co-scheduled pair

def co_manager(W=8):
    cm = PHubConnectionManager()
    hs, models = [], {}
    for ns, dm in D_MODELS.items():
        h = cm.create_service(ns, cfg_of(dm), tc_of(lr=LRS[ns]),
                              StackedComm(W), device="cpu")
        models[ns] = cm.init_service(h)[0]
        hs.append(h)
    return cm, hs, models


def test_co_resize_keeps_trained_slots_and_co_steps_go_on():
    cm, hs, models = co_manager()
    opts = {}
    for h in hs:
        ns = h.namespace
        o = cm.connect_service(h).init_opt()
        for _ in range(2):
            models[ns], o, _ = cm.push_pull(h, models[ns], o,
                                            batch(cfg_of(D_MODELS[ns])))
        opts[ns] = o
    pre = {h.namespace: live_rows(cm.connect_service(h), opts[h.namespace])
           for h in hs}
    cm.attach_services(hs, opts)
    del opts
    cm.resize(StackedComm(6))
    co6 = cm.last_rebalance["co"]
    assert co6["moved_bytes"] > 0 and 0 < co6["moved_fraction"] <= 1
    assert cm.packed_domain.n_shards == 6 and cm.last_rebalance["solo"] == {}
    cm.resize(StackedComm(8))
    opts = {}
    for h in hs:
        opts[h.namespace] = cm.detach_service(h)
        post = live_rows(cm.connect_service(h), opts[h.namespace])
        for n in SLOTS:
            assert torch.equal(post[n], pre[h.namespace][n]), \
                (h.namespace, n)
    cm.attach_services(hs, opts)
    models, met = cm.co_step(hs, models, {ns: batch(cfg_of(dm)) for ns, dm
                                          in D_MODELS.items()})
    assert all(np.isfinite(float(v["loss"])) for v in met.values())


def test_co_resize_equals_the_reference(reference):
    ref, meta, arrays, _ = reference
    cm, hs, _ = co_manager()
    opts = {h.namespace: to_opt(cm.connect_service(h), {
        n: arrays[f"co/{h.namespace}/{n}"] for n in SLOTS}) for h in hs}
    cm.attach_services(hs, opts)
    cm.resize(StackedComm(6))
    assert cm.last_rebalance["co"] == meta["co6"]["co"]
    assert cm.last_rebalance["co"]["moved_bytes"] > 0
    for n, v in full_rows(cm._co.opt).items():
        np.testing.assert_array_equal(v.numpy(), ref[f"co6/{n}"],
                                      err_msg=n)
    cm.resize(StackedComm(8))
    assert cm.last_rebalance["co"] == meta["co8"]["co"]
    for h in hs:
        back = full_rows(cm.detach_service(h))
        for n, v in back.items():
            np.testing.assert_array_equal(
                v.numpy(), ref[f"codet/{h.namespace}/{n}"], err_msg=n)


# ---------------------------------------------------------- 5. snapshots

@pytest.mark.parametrize("world", [6, 12])
def test_reference_snapshot_restores_at_another_world(reference, world):
    ref, _, _, ckdir = reference
    cfg = cfg_of(f32=True)
    eng = PHubEngine(cfg, tc_of(adam_eps=ADAM_EPS), StackedComm(world),
                     device="cpu")
    step, m, o = restore_train_state(ckdir, eng)
    assert step == 1
    (g,) = eng.chunk_plan.groups
    for n, v in full_rows(o).items():
        np.testing.assert_array_equal(v.numpy(), ref[f"ck{world}/{n}"],
                                      err_msg=n)
        np.testing.assert_array_equal(v.numpy()[:g.live_elems],
                                      ref[f"ck8/{n}"][:g.live_elems])
    m, o, met = eng.make_train_step()(m, o, batch(cfg, 1))
    assert np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("flat", [False, True], ids=["tree", "flat"])
def test_port_snapshot_restores_at_6_and_12(tmp_path, flat):
    cfg = cfg_of()
    eng8 = PHubEngine(cfg, tc_of(flat_residency=flat), StackedComm(8),
                      device="cpu")
    m, o = eng8.init_state()
    step = eng8.make_train_step()
    for _ in range(2):
        m, o, _ = step(m, o, batch(cfg))
    pre = live_rows(eng8, o)
    m8 = Membership.full(8).leave(2).join(2)             # epoch 2
    save_checkpoint(str(tmp_path), 2, snapshot_tree(m, o), membership=m8)
    want = [t.clone() for _, t in leaf_paths(m.param_tree())]
    for world in (6, 12):
        eng = PHubEngine(cfg, tc_of(flat_residency=flat), StackedComm(world),
                         device="cpu")
        st, mw, ow = restore_train_state(str(tmp_path), eng,
                                         membership=Membership.full(world))
        assert st == 2
        (g,) = eng.chunk_plan.groups
        assert (mw.flat_store is not None) == flat
        if flat:
            assert mw.flat_store["float32"].shape == (1, g.padded)
            assert not mw.flat_store["float32"][0, g.live_elems:].any()
        got = live_rows(eng, ow)
        for n in SLOTS:
            assert torch.equal(got[n], pre[n]), (world, n)
        for a, (_, b) in zip(want, leaf_paths(mw.param_tree())):
            assert torch.equal(a, b)
        mw, ow, met = eng.make_train_step()(mw, ow, batch(cfg))
        assert np.isfinite(float(met["loss"]))
    # the same world at another epoch is membership drift, not a resize
    with pytest.raises(ValueError, match="epoch 2") as e:
        restore_train_state(str(tmp_path), eng8,
                            membership=Membership.full(8))
    assert "epoch 0" in str(e.value)


# ------------------------------------------------- argument checks

def test_resize_refuses_what_it_cannot_move():
    cm = PHubConnectionManager()
    with pytest.raises(ValueError, match="no services"):
        cm.resize(StackedComm(6))
    cm2, hs, _ = co_manager(4)
    with pytest.raises(ValueError, match="unknown namespace"):
        cm2.resize(StackedComm(2), states={"nope": (None, None)})
    cm2.attach_services(hs[:1])
    with pytest.raises(ValueError, match="is attached"):
        cm2.resize(StackedComm(2), states={"A": (None, None)})
    # the DCN tier's residual keeps one row a pod: pods are not elastic
    cm3 = PHubConnectionManager()
    cm3.create_service("h", cfg_of(), tc_of(
        strategy="hierarchical", wire_format="identity",
        wire_format_dcn="int8", optimizer="nesterov"), StackedComm(4, 2),
        device="cpu")
    with pytest.raises(ValueError, match="rows slot"):
        cm3.resize(StackedComm(6, 3))
    # nothing changed: the rack is as it was
    assert cm3.membership.epoch == 0 and cm3.membership.world == 4


def test_dcn_tier_resize_keeps_each_pods_residual():
    cfg = cfg_of()
    tc = tc_of(strategy="hierarchical", wire_format="identity",
               wire_format_dcn="int8", optimizer="nesterov")
    cm = PHubConnectionManager()
    h = cm.create_service("h", cfg, tc, StackedComm(8, 2), device="cpu")
    m, o = cm.init_service(h)
    for _ in range(2):
        m, o, _ = cm.push_pull(h, m, o, batch(cfg))
    pre = live_rows(cm.connect_service(h), o)
    assert pre["wire_ef"].shape[0] == 2 and pre["wire_ef"].abs().max() > 0
    m, o = cm.resize(StackedComm(6, 2), states={"h": (m, o)})["h"]
    m, o = cm.resize(StackedComm(8, 2), states={"h": (m, o)})["h"]
    post = live_rows(cm.connect_service(h), o)
    for n in pre:
        assert torch.equal(post[n], pre[n]), n
    m, o, met = cm.push_pull(h, m, o, batch(cfg))
    assert np.isfinite(float(met["loss"]))


# ------------------------------------------------- 6. a process group

def _rank_resize(comm, device):
    cm = PHubConnectionManager()
    cm.create_service("job", cfg_of(), tc_of(), comm, device=device)
    try:
        cm.resize(StackedComm(1))
    except NotImplementedError as e:
        return str(e)
    return None


def test_resize_over_a_process_group_raises():
    init = "file://" + os.path.join(tempfile.mkdtemp(), "pg_init")
    for r, msg in enumerate(dist.run(_rank_resize, 2, "gloo", "cpu", 120.0,
                                     init_method=init, threads=1)):
        assert msg is not None and "item 4b" in msg, f"rank {r}: {msg}"
        assert "resizing the rack" in msg
