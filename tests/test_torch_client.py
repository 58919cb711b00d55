"""The port's ``PHubClient`` (``core/client.py``) on stacked workers against
the JAX package's, and the tree-level optimizer API (``optim/api.py``).

1. ``register`` on the reference test's ``LIKE`` tree gives the
   reference's plan (totals, padding, chunk elements, leaf order, bytes),
   and ``slot_shapes`` its slot names; ``fsdp_stream`` and an unregistered
   ``push_pull`` raise as the reference's do.
2. One worker: the reference's client on a 1-device mesh against
   ``PHubClient(StackedComm(1), device="cpu")`` on integer-valued trees at
   lr 0.25 and momentum 0.5 (every sum and product exact, so the two
   frameworks' FMA contraction cannot differ), 3 steps: Nesterov and SGD
   bitwise, Adam (eps 1e-3) within ``ADAM_ATOL``, the bound of the kernel's
   textbook EMAs against the protocol's residual form (ROADMAP.md queue
   C).  Both clients against both packages' ``make_optimizer``.
3. Flat mode equals tree mode bitwise, and chunk-ready dispatch of a
   finished push equals the windows (port only).
4. Four workers: the reference's client on a ``(pod=2, data=2)`` mesh of 4
   forced host devices (``AxisType.Auto``) in one subprocess against
   ``StackedComm(4, pods=2)``: sharded_ps, hierarchical, allreduce and
   centralized_ps x Nesterov and SGD x windows {1, 2} (the baselines have
   no shard dimension to window) on integer-valued pushes, 3 steps; a
   3-of-4 membership whose pushes are nonnegative multiples of 3 (XLA
   contracts the mean's ``* (1/3)`` into the next add); the int8 wire
   (sharded_ps) and the int8 DCN tier (hierarchical) on pushes whose every
   encoded chunk peaks at 127 times a power of two, so the int8 scale is
   exact both ways (XLA turns ``/127`` into ``* (1/127)``).  Bitwise.
5. Inside the port: int8 and bf16 in 2 windows equal one window bitwise
   on random inputs, as do the int8 DCN tier's; the watchdog retries an
   injected ``TransientExchangeError`` and raises ``WatchdogExhausted``
   once its retries are spent; the engine is a thin client consumer.
6. ``examples/torch_external_loop.py`` on the CPU, 4 workers, 60 steps:
   the mse falls and stays finite.
"""
import functools
import importlib.util
import json
import math
import os
import subprocess
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import TrainConfig as JaxTrainConfig
from repro.core import PHubClient as JaxClient
from repro.optim import make_optimizer as jax_make_optimizer
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import (PHubClient, PHubEngine, StackedComm,
                              module_tree)
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.elastic import Membership
from repro_torch.models import DecoderLM, param_specs
from repro_torch.optim import make_optimizer
from repro_torch.resilience import (ExchangeWatchdog, TransientExchangeError,
                                    WatchdogConfig, WatchdogExhausted)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR, MU = 0.25, 0.5              # exact on integer-valued inputs
ADAM_EPS = 1e-3
ADAM_ATOL = 1e-6                # textbook vs residual-form EMAs (queue C)
SHAPES = {"dense": {"w": (64, 48), "b": (48,)}, "scale": (17,)}
# the 4-worker tree: 3062 elements, 64-element chunks (256 B): 12 chunks a
# shard at S = 4, 24 at S = 2, so 2 windows take effect, and no chunk is
# all padding
SHAPES4 = {"dense": {"w": (60, 48), "b": (48,)}, "scale": (134,)}
CHUNK4 = 256
STEPS = 3
STRATEGIES = ("sharded_ps", "hierarchical", "allreduce", "centralized_ps")
RULES = ("nesterov", "sgd")
DEAD = 1
TIMEOUT = 600


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def like_torch(shapes=SHAPES):
    return _map(lambda s: torch.empty(s, device="meta"), shapes)


def like_jax(shapes=SHAPES):
    return _map(lambda s: jax.ShapeDtypeStruct(s, jnp.float32), shapes)


def int_tree(rng, lo, hi, lead=None, shapes=SHAPES):
    return _map(lambda s: rng.integers(
        lo, hi, ((lead,) + s) if lead else s).astype(np.float32), shapes)


def to_torch(tree):
    return _map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def to_jax(tree):
    return _map(jnp.asarray, tree)


def flat_np(tree) -> np.ndarray:
    return np.concatenate([np.asarray(v, np.float32).reshape(-1)
                           for _, v in leaf_paths(tree)])


def mesh1():
    return jax.make_mesh((1,), ("data",),
                         axis_types=(jax.sharding.AxisType.Auto,))


def _tc(rule, **kw):
    return dict(optimizer=rule, lr=LR, momentum=MU, adam_eps=ADAM_EPS, **kw)


# ---------------------------------------------------- 1. plan and refusals

@pytest.mark.parametrize("kw", [
    dict(), dict(optimizer="adam"), dict(optimizer="sgd"),
    dict(wire_format="int8"), dict(chunk_size_bytes=256),
    dict(chunk_size_bytes=64, wire_format="bf16", optimizer="adam")],
    ids=["nesterov", "adam", "sgd", "int8", "chunk256", "bf16-adam"])
def test_register_gives_the_reference_plan_and_slots(kw):
    kw = dict(dict(chunk_size_bytes=1024), **kw)
    ref = JaxClient(JaxTrainConfig(**kw), mesh1()).register(like_jax())
    port = PHubClient(TrainConfig(**kw), StackedComm(1),
                      device="cpu").register(like_torch())
    assert len(port.plan.groups) == len(ref.plan.groups) == 1
    for rg, pg in zip(ref.plan.groups, port.plan.groups):
        assert (pg.total, pg.padded, pg.chunk_elems, pg.shard_len,
                pg.n_shards) == (rg.total, rg.padded, rg.chunk_elems,
                                 rg.shard_len, rg.n_shards)
        assert list(pg.paths) == list(rg.paths)
        assert list(pg.sizes) == list(rg.sizes)
    assert port.registered_bytes() == ref.registered_bytes()
    rs, ps = ref.slot_shapes(), port.slot_shapes()
    assert {k: list(d) for k, d in ps.items()} == \
        {k: list(d) for k, d in rs.items()}
    for key in rs:
        for name, sd in rs[key].items():
            t = ps[key][name]
            assert t.numel() == math.prod(sd.shape)
            assert str(t.dtype).removeprefix("torch.") == str(sd.dtype)


def test_module_tree_registers_the_engine_plan():
    cfg = reduced(get_arch("llama3.2-1b"))
    gen = torch.Generator().manual_seed(0)
    model = DecoderLM(cfg, device="cpu", generator=gen)
    tc = TrainConfig(chunk_size_bytes=4096)
    a = PHubClient(tc, StackedComm(4), device="cpu").register(
        module_tree(model))
    b = PHubClient(tc, StackedComm(4), device="cpu").register(
        param_specs(cfg))
    assert a.plan == b.plan
    tree = module_tree(model)
    assert all(x is y for (_, x), (_, y) in zip(
        leaf_paths(tree), leaf_paths(model.param_tree())))


def test_client_refuses_fsdp_stream_and_an_unregistered_push():
    with pytest.raises(ValueError, match="chunk domain"):
        JaxClient(JaxTrainConfig(strategy="fsdp_stream"), mesh1())
    with pytest.raises(ValueError, match="chunk domain"):
        PHubClient(TrainConfig(strategy="fsdp_stream"), StackedComm(1),
                   device="cpu")
    ref = JaxClient(JaxTrainConfig(), mesh1())
    port = PHubClient(TrainConfig(), StackedComm(1), device="cpu")
    for client in (ref, port):
        with pytest.raises(ValueError, match="register"):
            client.push_pull({}, {}, {})
    with pytest.raises(ValueError, match="register"):
        port.push_pull_flat({}, {}, {})
    with pytest.raises(ValueError, match="shard dimension"):
        PHubClient(TrainConfig(strategy="allreduce"), StackedComm(2),
                   device="cpu", wire_format="int8")
    with pytest.raises(ValueError, match="hierarchical"):
        PHubClient(TrainConfig(), StackedComm(4, 2), device="cpu",
                   wire_format_dcn="int8")
    client = PHubClient(TrainConfig(), StackedComm(2),
                        device="cpu").register(like_torch())
    g = _map(lambda s: torch.zeros((3,) + s), SHAPES)
    with pytest.raises(ValueError, match="2 workers"):
        client.push_pull(g, to_torch(int_tree(np.random.default_rng(0),
                                              0, 1)), client.init_state())


# ------------------------------------------------------------ 2. one worker

@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
def test_one_worker_equals_the_reference_client(rule):
    """3 steps of the same integer push: the port's client against the
    reference's and both ``make_optimizer``s."""
    kw = _tc(rule, chunk_size_bytes=1024)
    rng = np.random.default_rng(0)
    p0 = int_tree(rng, -4, 5)
    grads = int_tree(rng, -8, 9, lead=1)
    ref = JaxClient(JaxTrainConfig(**kw), mesh1()).register(like_jax())
    port = PHubClient(TrainConfig(**kw), StackedComm(1),
                      device="cpu").register(like_torch())
    pr, orr = to_jax(p0), ref.init_state()
    pp, op = to_torch(p0), port.init_state()
    pp_ids = [id(v) for _, v in leaf_paths(pp)]
    jinit, jupd = jax_make_optimizer(JaxTrainConfig(**kw))
    tinit, tupd = make_optimizer(TrainConfig(**kw))
    pj, sj = to_jax(p0), jinit(to_jax(p0))
    pt, st = to_torch(p0), tinit(to_torch(p0))
    g1 = _map(lambda g: g[0], grads)
    for _ in range(STEPS):
        pr, orr = ref.push_pull(to_jax(grads), pr, orr)
        out, op = port.push_pull(to_torch(grads), pp, op)
        assert out is pp
        pj, sj = jupd(pj, to_jax(g1), sj)
        pt, st = tupd(pt, to_torch(g1), st)
    assert [id(v) for _, v in leaf_paths(pp)] == pp_ids   # written in place
    port_p = flat_np(_map(lambda t: t.numpy(), pp))
    tree_p = flat_np(_map(lambda t: t.numpy(), pt))
    ref_p, jax_p = flat_np(pr), flat_np(pj)
    # the two packages' tree-level rules: the protocol bodies, bitwise
    np.testing.assert_array_equal(tree_p, jax_p)
    if rule == "adam":
        for a, b in ((port_p, ref_p), (port_p, tree_p), (ref_p, jax_p)):
            assert np.max(np.abs(a - b)) <= ADAM_ATOL
        assert not np.array_equal(port_p, flat_np(p0))
        return
    for other in (ref_p, tree_p):
        np.testing.assert_array_equal(port_p, other)
    for name in port.sopt.slot_names:
        np.testing.assert_array_equal(
            op["float32"][name].numpy().reshape(-1),
            np.asarray(orr["float32"][name]).reshape(-1))


@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("rule", ["nesterov", "adam"])
def test_flat_mode_equals_tree_mode(rule, W):
    kw = _tc(rule, chunk_size_bytes=CHUNK4, pipeline_windows=2)
    client = PHubClient(TrainConfig(**kw), StackedComm(W),
                        device="cpu").register(like_torch(SHAPES4))
    rng = np.random.default_rng(W)
    p0 = int_tree(rng, -4, 5, shapes=SHAPES4)
    pt, ot = to_torch(p0), client.init_state()
    pstore, of = client.flatten(to_torch(p0)), client.init_state()
    for _ in range(2):
        grads = to_torch(int_tree(rng, -8, 9, lead=W, shapes=SHAPES4))
        pt, ot = client.push_pull(grads, pt, ot)
        gstore = {k: torch.stack([client.flatten(_map(
            lambda g, w=w: g[w], grads))[k] for w in range(W)])
            for k in pstore}
        pstore, of = client.push_pull_flat(gstore, pstore, of)
    for (_, a), (_, b) in zip(leaf_paths(client.unflatten(pstore)),
                              leaf_paths(pt)):
        assert torch.equal(a, b)
    for k in ot:
        for n in ot[k]:
            assert torch.equal(ot[k][n], of[k][n])


@pytest.mark.parametrize("wire", ["identity", "int8"])
@pytest.mark.parametrize("strategy", ["sharded_ps", "hierarchical"])
def test_chunk_ready_push_equals_the_windows(strategy, wire):
    """``overlap_backward`` dispatches the windows of a finished push as
    they become ready: the same bits as the windowed exchange."""
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal(3062).astype(np.float32)
    pushes = [rng.standard_normal((4, 3062)).astype(np.float32)
              for _ in range(2)]
    out = {}
    for overlap in (False, True):
        tc = TrainConfig(strategy=strategy, wire_format=wire,
                         chunk_size_bytes=CHUNK4, pipeline_windows=2,
                         overlap_backward=overlap)
        client = PHubClient(tc, StackedComm(4, 2), device="cpu").register(
            {"w": torch.empty(3062, device="meta")})
        p, opt = {"w": torch.from_numpy(p0.copy())}, client.init_state()
        for g in pushes:
            p, opt = client.push_pull({"w": torch.from_numpy(g)}, p, opt)
        out[overlap] = (p["w"], opt)
    assert torch.equal(out[True][0], out[False][0])
    for k, d in out[True][1].items():
        for n, v in d.items():
            assert torch.equal(v, out[False][1][k][n])


# ---------------------------------------------- 4. four workers, reference

def ref_cases() -> list:
    """(name, spec) of every 4-worker case against the reference."""
    out = []
    for st in STRATEGIES:
        for rule in RULES:
            for win in ((1, 2) if st in ("sharded_ps", "hierarchical")
                        else (1,)):
                out.append(dict(kind="identity", strategy=st, rule=rule,
                                windows=win, dead=None, steps=STEPS,
                                mu=MU))
    for st in ("sharded_ps", "hierarchical"):
        out.append(dict(kind="identity", strategy=st, rule="nesterov",
                        windows=1, dead=DEAD, steps=STEPS, mu=MU))
    for win in (1, 2):
        # SGD over 2 steps; Nesterov at momentum 1 (its first step moves
        # p by 0.5 g) for 1
        out.append(dict(kind="int8", strategy="sharded_ps", rule="sgd",
                        windows=win, dead=None, steps=2, mu=MU))
        out.append(dict(kind="int8", strategy="sharded_ps",
                        rule="nesterov", windows=win, dead=None, steps=1,
                        mu=1.0))
        out.append(dict(kind="dcn", strategy="hierarchical",
                        rule="nesterov", windows=win, dead=None, steps=2,
                        mu=MU))
    return [(f"{c['kind']}-{c['strategy']}-{c['rule']}-win{c['windows']}"
             + ("" if c["dead"] is None else f"-dead{c['dead']}"), c)
            for c in out]


def _config(c) -> dict:
    kw = _tc(c["rule"], strategy=c["strategy"], chunk_size_bytes=CHUNK4,
             pipeline_windows=c["windows"])
    kw["momentum"] = c["mu"]
    if c["kind"] == "int8":
        kw["wire_format"] = "int8"
    if c["kind"] == "dcn":
        kw["wire_format_dcn"] = "int8"
    return kw


def ref_pushes(name: str, c, group) -> list:
    """Per step the (4, padded) integer pushes of a case, the pad zero."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n, total, ce = group.padded, group.total, group.chunk_elems
    lead = np.zeros(n, bool)
    lead[::ce] = True
    out = []
    for _ in range(c["steps"]):
        if c["kind"] == "identity" and c["dead"] is None:
            g = rng.integers(-8, 9, (4, n)).astype(np.float32)
        elif c["kind"] == "identity":
            # multiples of 3 (the mean over 3 exact), nonnegative: XLA
            # contracts (sum * (1/3)) + mu * m into one FMA, which is the
            # exact k + mu * m only where nothing cancels
            g = 3 * rng.integers(0, 9, (4, n)).astype(np.float32)
            g[c["dead"]] = 0
        elif c["kind"] == "dcn":
            # every chunk of each pod's partial (rows 2q, 2q+1) peaks at
            # 127: the DCN tier's int8 scale is 1
            g = rng.integers(-4, 5, (4, n)).astype(np.float32)
            g[:, lead] = 3
            g[0::2][:, lead] = 124
        else:
            # the ring of shard j: rows j+1, j+2, j+3 encoded in turn, the
            # owner j added after.  Each partial's chunks peak at 127 (row
            # j+1's lead, the others' 0) and the pulled delta -f * mean
            # (f = lr (SGD), lr (1 + mu) at Nesterov's first step) at
            # -127: the owner's lead makes the sum 4 * 127 / f, the
            # others' sums multiples of 4 / f
            f = LR if c["rule"] == "sgd" else LR * (1 + c["mu"])
            unit = int(round(4 / f))
            g = rng.integers(-4, 5, (4, n)).astype(np.float32)
            L = n // 4
            for j in range(4):
                cols = slice(j * L, (j + 1) * L)
                blk = g[:, cols]
                ld = lead[cols]
                rest = blk[[(j + 1) % 4, (j + 2) % 4, (j + 3) % 4]].sum(0)
                blk[j] = unit * rng.integers(-1, 2, L) - rest
                blk[(j + 1) % 4, ld] = 127
                blk[(j + 2) % 4, ld] = 0
                blk[(j + 3) % 4, ld] = 0
                blk[j, ld] = 4 * 127 / f - 127
        g[:, total:] = 0
        out.append(g)
    return out


_REF_SCRIPT = r"""
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import TrainConfig
from repro.core import PHubClient
from repro.elastic import Membership

spec_path, src, dst = sys.argv[1:4]
spec = json.load(open(spec_path))
d = np.load(src)
Auto = jax.sharding.AxisType.Auto
mesh = jax.make_mesh((2, 2), ("pod", "data"), axis_types=(Auto, Auto))
out = {}


def tree(flat, lead=None):
    res, off = {}, 0
    for path, shape in spec["leaves"]:
        n = int(np.prod(shape))
        x = flat[..., off:off + n]
        off += n
        node = res
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = jnp.asarray(x.reshape(
            (flat.shape[0],) + tuple(shape) if lead else tuple(shape)))
    return res


for name, c, kw in spec["cases"]:
    client = PHubClient(TrainConfig(**kw), mesh).register(
        tree(d["p0"][: spec["total"]]))
    if c["dead"] is not None:
        client.set_membership(Membership.full(4).leave(c["dead"]))
    p, opt = tree(d["p0"][: spec["total"]]), client.init_state()
    for s in range(c["steps"]):
        g = d[f"{name}/g{s}"][:, : spec["total"]]
        p, opt = client.push_pull(tree(g, lead=True), p, opt)
        leaves = [np.asarray(x, np.float32).reshape(-1)
                  for x in jax.tree.leaves(p)]
        out[f"{name}/p{s}"] = np.concatenate(leaves)
        for slot, v in opt["float32"].items():
            out[f"{name}/{slot}{s}"] = np.asarray(v, np.float32)
np.savez(dst, **out)
"""


def _plan_group(c):
    client = PHubClient(TrainConfig(**_config(c)), StackedComm(4, 2),
                        device="cpu").register(like_torch(SHAPES4))
    (group,) = client.plan.groups
    return client, group


@functools.lru_cache(maxsize=None)
def reference_results(tmp: str) -> dict:
    cases = ref_cases()
    arrays = {"p0": np.random.default_rng(11).integers(
        -8, 9, 3062).astype(np.float32)}
    leaves = [([k.strip("[]'") for k in path.split("][")], list(v.shape))
              for path, v in leaf_paths(like_torch(SHAPES4))]
    for name, c in cases:
        _, group = _plan_group(c)
        for s, g in enumerate(ref_pushes(name, c, group)):
            arrays[f"{name}/g{s}"] = g
    spec, src, dst = (os.path.join(tmp, f) for f in
                      ("cases.json", "in.npz", "out.npz"))
    with open(spec, "w") as f:
        json.dump({"cases": [(n, c, _config(c)) for n, c in cases],
                   "leaves": leaves, "total": 3062}, f)
    np.savez(src, **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _REF_SCRIPT, spec, src, dst],
                         env=env, capture_output=True, text=True,
                         timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr[-4000:]
    return dict(np.load(dst)), arrays


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_results(str(tmp_path_factory.mktemp("ref_client")))


@pytest.mark.parametrize("name,case", ref_cases(), ids=[n for n, _ in
                                                        ref_cases()])
def test_four_workers_equal_the_reference_client(reference, name, case):
    ref, arrays = reference
    client, group = _plan_group(case)
    assert effective_windows(group, case["windows"]) == case["windows"]
    if case["dead"] is not None:
        client.set_membership(Membership.full(4).leave(case["dead"]))
    p0 = torch.from_numpy(arrays["p0"].copy())
    params = client.unflatten({"float32": torch.cat(
        [p0, torch.zeros(group.padded - 3062)])})
    params = _map(lambda t: t.clone(), params)
    opt = client.init_state()
    for s in range(case["steps"]):
        g = torch.from_numpy(arrays[f"{name}/g{s}"])
        grads = _stack_trees([client.unflatten({"float32": g[w]})
                              for w in range(4)])
        params, opt = client.push_pull(grads, params, opt)
        got = flat_np(_map(lambda t: t.numpy(), params))
        np.testing.assert_array_equal(got, ref[f"{name}/p{s}"],
                                      err_msg=f"p after step {s}")
        for slot, v in opt["float32"].items():
            want = ref[f"{name}/{slot}{s}"]
            have = v.numpy()
            if slot == "wire_ef" and case["kind"] == "dcn":
                # the reference keeps pod 0's view of the per-pod residual
                have = have[: want.shape[0]]
            np.testing.assert_array_equal(have.reshape(-1),
                                          want.reshape(-1),
                                          err_msg=f"{slot} after step {s}")


def _stack_trees(trees: list) -> dict:
    first = trees[0]
    return {k: (_stack_trees([t[k] for t in trees])
                if isinstance(v, dict) else
                torch.stack([t[k] for t in trees]))
            for k, v in first.items()}


# ------------------------------------------------------- 5. inside the port

@pytest.mark.parametrize("kw", [
    dict(wire_format="int8"), dict(wire_format="bf16"),
    dict(wire_format="int8", strategy="hierarchical"),
    dict(wire_format_dcn="int8", strategy="hierarchical"),
    dict(wire_format="int8", optimizer="adam")],
    ids=["int8", "bf16", "int8-hierarchical", "dcn", "int8-adam"])
def test_encoded_wires_in_two_windows_equal_one(kw):
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal(3062).astype(np.float32)
    pushes = [rng.standard_normal((4, 3062)).astype(np.float32)
              for _ in range(2)]
    out = []
    for windows in (1, 2):
        tc = TrainConfig(chunk_size_bytes=CHUNK4, pipeline_windows=windows,
                         lr=0.05, adam_eps=ADAM_EPS, **kw)
        client = PHubClient(tc, StackedComm(4, 2), device="cpu").register(
            {"w": torch.empty(3062, device="meta")})
        (group,) = client.plan.groups
        assert effective_windows(group, windows) == windows
        p, opt = {"w": torch.from_numpy(p0.copy())}, client.init_state()
        for g in pushes:
            p, opt = client.push_pull({"w": torch.from_numpy(g)}, p, opt)
        assert client.exchange_slots[-1].name == "wire_ef"
        out.append((p["w"], opt))
    assert torch.equal(out[0][0], out[1][0])
    assert not torch.equal(out[0][0], torch.from_numpy(p0))
    for k, d in out[0][1].items():
        for n, v in d.items():
            assert torch.equal(v, out[1][1][k][n])


def _watched(retries):
    client = PHubClient(TrainConfig(chunk_size_bytes=CHUNK4),
                        StackedComm(4), device="cpu").register(
        like_torch(SHAPES4))
    wd = ExchangeWatchdog(WatchdogConfig(retries=retries,
                                         backoff_base_s=0.0, jitter=0.0))
    return client.set_watchdog(wd), wd


def test_watchdog_retries_a_transient_fault_and_gives_up_when_spent():
    rng = np.random.default_rng(5)
    p0 = int_tree(rng, -4, 5, shapes=SHAPES4)
    grads = to_torch(int_tree(rng, -8, 9, lead=4, shapes=SHAPES4))
    plain = PHubClient(TrainConfig(chunk_size_bytes=CHUNK4), StackedComm(4),
                       device="cpu").register(like_torch(SHAPES4))
    want, _ = plain.push_pull(grads, to_torch(p0), plain.init_state())
    client, wd = _watched(2)
    wd.inject_fault(TransientExchangeError("injected"), attempts=2)
    got, _ = client.push_pull(grads, to_torch(p0), client.init_state())
    assert wd.pending_faults() == 0 and wd.total_retries == 2
    for (_, a), (_, b) in zip(leaf_paths(got), leaf_paths(want)):
        assert torch.equal(a, b)
    client, wd = _watched(1)
    wd.inject_fault(TransientExchangeError("injected"), attempts=3)
    with pytest.raises(WatchdogExhausted):
        client.push_pull(grads, to_torch(p0), client.init_state())
    client.set_watchdog(None)
    client.push_pull(grads, to_torch(p0), client.init_state())


def test_engine_is_a_thin_client_consumer():
    cfg = reduced(get_arch("llama3.2-1b"))
    for tc in (TrainConfig(), TrainConfig(optimizer="adam",
                                          wire_format="int8")):
        eng = PHubEngine(cfg, tc, StackedComm(2), device="cpu")
        assert isinstance(eng.client, PHubClient)
        assert eng.client.plan is eng.chunk_plan
        assert eng.client.sopt == eng.sopt
        assert eng.exchange_slots == eng.client.exchange_slots
        assert eng.grad_buffers() is eng.client.grad_buffers()
        opt = eng.init_opt()
        assert {k: {n: tuple(v.shape) for n, v in d.items()}
                for k, d in opt.items()} == \
            {k: {n: tuple(v.shape) for n, v in d.items()}
             for k, d in eng.client.slot_shapes().items()}
    src = open(os.path.join(ROOT, "src", "repro_torch", "core",
                            "engine.py")).read()
    # no exchange dispatch of its own: every wire's runs in the client
    for name in ("run_exchange", "run_wire_exchange", "run_dcn_exchange",
                 "run_chunk_ready_exchange", "WIRE_EF_SLOT"):
        assert f"{name}(" not in src and f"import {name}" not in src, name


# ------------------------------------------------------ 6. external loop

def test_external_loop_example_trains_on_the_cpu():
    path = os.path.join(ROOT, "examples", "torch_external_loop.py")
    spec = importlib.util.spec_from_file_location("torch_external_loop",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    losses = mod.main(["--device", "cpu", "--workers", "4", "--steps",
                       "60"])
    assert len(losses) == 60 and all(math.isfinite(x) for x in losses)
    assert losses[-1] <= losses[0] / 4
