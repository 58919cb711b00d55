"""The int8 wire in every mode of the port's step: windows, chunk-ready
dispatch, k-of-n membership and the sanity gate, against the JAX
package's and against the port's own one-window int8 step.

1. The windowed schedule (``core/pipeline.py``): at S = 1 .. 4 stacked
   workers and under Nesterov, SGD and Adam, f32 and bf16, the encoded
   exchange in 3 windows and chunk-ready (leaves arriving in reverse
   order) equals the one-window exchange bitwise: p', the slots and
   ``wire_ef``.  Windows are whole chunks and the codec works chunk by
   chunk, so nothing may differ (the reference's oracle,
   ``tests/multidevice/check_pipeline.py``, holds its own the same way).
2. The engine, W = 4: int8 in 5 windows, chunk-ready and flat, equal the
   one-window int8 step bitwise for the three rules (two steps), and one
   step calls the codec and the tail kernels as often as the card's main
   path must launch them (``chip_smoke.py`` and ``PERF.md`` take these
   counts: quantize 3 a window + 1, dequantize 2 a window + 1, the int8
   tail one a window).
3. W = 1 in 4 windows against the JAX ``PHubEngine`` on a (1, 1) mesh with
   ``wire_format="int8"`` and ``pipeline_windows=4`` (the Pallas kernels
   in interpret mode), within one grid step, with the bounds and reasons
   of tests/test_torch_engine_wire.py.
4. A 3-of-4 static membership over int8 (the dead worker's row zeroed,
   ``n_live`` 3 by value) equals, bitwise, an eager composition of the
   reference's functions in its ring order: ``dequant_agg_opt_ref`` with
   ``inv_n = 1/3`` (Nesterov; the reference bakes ``1/n_live`` in its
   kernel), or the decoded sum plus the own rows divided by 3 and the
   rule's jnp oracle (SGD, Adam), at one window and in 3.
5. The sanity gate over int8 (``n_live`` a tensor): the exchange equals
   the reference's jnp tail bitwise (decode, own rows, ``/ n_live`` by an
   array, the rule's oracle: the reference's gate cannot take its kernel
   there, and the port's kernel divides by the count on the card); in the
   engine, worker 1 poisoned under the gate equals worker 1 dead at 5
   workers (n_live 4: ``* 1/4`` and ``/ 4`` agree) bitwise.  At n_live 3
   the static kernel multiplies and the gate divides, a last-bit
   difference, so the two are held each to its own reference form.
6. ``dequant_agg_opt_ref`` (B7's plain version) on a window's strips, read
   in place, and with a divisor, bitwise against the reference's
   ``dequant_agg_opt_ref`` at integer-valued inputs (divisor 4) and
   against the jnp tail (divisor 3); the wrapper's in-place form.

Every file here pins one intra-op thread (see
tests/test_torch_engine_pipeline.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro.core.pipeline import effective_windows as jax_effective_windows
from repro.core.wire import WireFormat as JaxWire
from repro.data import SyntheticTokens as JaxTokens
from repro.kernels.agg_opt.ref import (adam_opt_ref as jax_adam_ref,
                                       agg_opt_ref as jax_agg_opt_ref,
                                       dequant_agg_opt_ref as jax_dequant_ref,
                                       sgd_opt_ref as jax_sgd_ref)
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm, chunking
from repro_torch.core.chunking import flatten_groups, leaf_paths
from repro_torch.core.pipeline import (ChunkReadyExchange, effective_windows,
                                       own_strips, pipelined_wire_exchange)
from repro_torch.core.wire import WIRE_EF_SLOT, WireFormat
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import Membership
from repro_torch.kernels import quant
from repro_torch.kernels.agg_opt import LAUNCHES, ops, reset_launches
from repro_torch.kernels.agg_opt.ref import dequant_agg_opt_ref
from repro_torch.optim.protocol import (AdamOptimizer, NesterovOptimizer,
                                        SGDOptimizer)
from repro_torch.resilience import SanityConfig

T, LOSS_CHUNK, W4, CHUNK_BYTES = 32, 16, 4, 7680
LOSS_RTOL, ATOL = 1e-5, 1e-6
KW = {"nesterov": dict(lr=0.05, momentum=0.9),
      "sgd": dict(lr=0.05),
      "adam": dict(lr=1e-4, adam_eps=1e-3)}
RULES = {"nesterov": (NesterovOptimizer(), (0.05, 0.9)),
         "sgd": (SGDOptimizer(), (0.05,)),
         "adam": (AdamOptimizer(), (3e-4,))}
_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def deterministic():
    """Two runs of one CPU step are comparable bitwise only with the
    embedding backward's row sums in a fixed order."""
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(_JNP.get(t.dtype,
                                                          jnp.float32))


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ------------------------------------------------- 1. the windowed schedule

def _group(S, dtype=torch.float32):
    """One group of four leaves in chunks of 64: 6 chunks a shard at every
    S, so 3 windows take effect."""
    n = S * 6 * 64
    sizes = (n // 5, n // 3, n // 4)
    tree = {"a": torch.zeros(sizes[0], dtype=dtype),
            "b": torch.zeros(sizes[1], dtype=dtype),
            "c": torch.zeros(3, sizes[2] // 3, dtype=dtype),
            "d": torch.zeros(n - sum(sizes) - 40, dtype=dtype)}
    (g,) = chunking.build_plan(tree, chunk_bytes=64 * torch.tensor(
        [], dtype=dtype).element_size(), n_shards=S).groups
    assert g.chunk_elems == 64 and g.padded == n
    return g


def _setup(S, rule, dtype, n, seed):
    """Stacked gradients, p, the rule's slots and a nonzero residual."""
    rng = np.random.default_rng(seed)

    def f(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    g = f(S, n, scale=1e-2).to(dtype)
    g[:, ::11] = 0
    p = f(n).to(dtype)
    opt, _ = RULES[rule]
    slots = []
    for spec in opt.slots:
        t = f(n, scale=1e-2)
        if spec.name in ("v", "k1", "k2"):
            t = t.abs()
        if spec.name in ("k1", "k2"):
            t[::7] = 0
        slots.append(t.to(spec.resolve_dtype(dtype)))
    r = f(n, scale=1e-4)
    return g, p, tuple(slots), r


def _exchange(S, rule, g, p, slots, r, ce, windows=1, n_live=None,
              ready_group=None):
    """The port's encoded exchange on copies of the state; with
    ``ready_group`` through ``ChunkReadyExchange``, the leaves arriving in
    reverse order."""
    opt, coefs = RULES[rule]
    inv = 1.0 / (n_live if isinstance(n_live, float) else S)
    fd = opt.kernel_dequant_update(ce, coefs, inv)
    args = (StackedComm(S), g, p.clone(), tuple(t.clone() for t in slots),
            opt.kernel_update(ce, coefs))
    if ready_group is None:
        return pipelined_wire_exchange(*args, WireFormat("int8"), ce,
                                       r.clone(), fd, windows, n_live)
    ex = ChunkReadyExchange(*args, ready_group, windows, n_live,
                            wire=WireFormat("int8"), residual=r.clone(),
                            fused_dequant=fd)
    for i in reversed(range(len(ready_group.paths))):
        ex.leaf_ready(i)
    assert sorted(ex.order) == list(range(windows))
    return ex.finish()


def _assert_same(a, b):
    (pa, sa, ra), (pb, sb, rb) = a, b
    assert torch.equal(pa, pb) and torch.equal(ra, rb)
    assert len(sa) == len(sb)
    assert all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int8_windows_and_chunk_ready_equal_one_window_bitwise(S, rule,
                                                               dtype):
    group = _group(S, dtype)
    assert effective_windows(group, 3) == 3
    g, p, slots, r = _setup(S, rule, dtype, group.padded, seed=S + len(rule))
    one = _exchange(S, rule, g, p, slots, r, 64)
    _assert_same(_exchange(S, rule, g, p, slots, r, 64, windows=3), one)
    _assert_same(_exchange(S, rule, g, p, slots, r, 64, windows=3,
                           ready_group=group), one)
    assert float(one[2].abs().max()) > 0       # error feedback engaged


# ------------------------------------------------------------- 2. engine

def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype="float32")
    return jcfg, pcfg


def _tc(rule, **mode):
    return TrainConfig(optimizer=rule, loss_chunk=LOSS_CHUNK,
                       chunk_size_bytes=CHUNK_BYTES, wire_format="int8",
                       **KW[rule], **mode)


def _engine_run(rule, W, mode, *, membership=None, health=None, steps=2,
                batch=8):
    _, pcfg = _cfgs()
    eng = PHubEngine(pcfg, _tc(rule, **mode), StackedComm(W), device="cpu")
    (g,) = eng.chunk_plan.groups
    want = mode.get("pipeline_windows", 1)
    assert effective_windows(g, want) == want
    model, opt = eng.init_state(seed=7)
    data = SyntheticTokens(pcfg, batch, T, seed=6)
    if health is not None:
        step = eng.make_train_step(membership=membership,
                                   sanity=SanityConfig(allow_injection=True))
        extra = (health,)
    else:
        step = eng.make_train_step(membership=membership)
        extra = ()
    losses = []
    for i in range(steps):
        model, opt, m = step(model, opt, data.torch_batch(i, "cpu"), *extra)
        losses.append(m["loss"])
    return losses, dict(leaf_paths(model.param_tree())), opt


def _assert_same_run(a, b):
    (la, pa, oa), (lb, pb, ob) = a, b
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert oa["float32"].keys() == ob["float32"].keys()
    for n in oa["float32"]:
        assert torch.equal(oa["float32"][n], ob["float32"][n]), n


@pytest.mark.parametrize("rule", list(RULES))
def test_engine_int8_modes_equal_the_one_window_step_bitwise(
        rule, deterministic):
    base = _engine_run(rule, W4, {})
    for mode in (dict(pipeline_windows=5),
                 dict(pipeline_windows=5, overlap_backward=True),
                 dict(pipeline_windows=5, overlap_backward=True,
                      flat_residency=True)):
        _assert_same_run(_engine_run(rule, W4, mode), base)


def _count_calls(monkeypatch):
    calls = {}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("fused_agg_opt", "fused_multi_agg_opt", "fused_sgd_opt",
                 "fused_adam_opt", "fused_dequant_agg_opt"):
        counting(ops, name)
    for name in ("quantize_int8", "dequantize_int8"):
        counting(quant.ops, name)
    return calls


# one step in 5 windows at W = 4 (4 shards) and in 4 windows at W = 1
WINDOWED_CALLS = {
    ("nesterov", 4): {"quantize_int8": 3 * 5 + 1, "dequantize_int8": 2 * 5 + 1,
                      "fused_dequant_agg_opt": 5},
    ("sgd", 4): {"quantize_int8": 3 * 5 + 1, "dequantize_int8": 3 * 5 + 1,
                 "fused_sgd_opt": 5 * 4},
    ("adam", 4): {"quantize_int8": 3 * 5 + 1, "dequantize_int8": 3 * 5 + 1,
                  "fused_adam_opt": 5 * 4},
    ("nesterov", 1): {"quantize_int8": 1, "dequantize_int8": 1,
                      "fused_agg_opt": 4},
}


@pytest.mark.parametrize("rule,W", sorted(WINDOWED_CALLS))
@pytest.mark.parametrize("overlap", [False, True])
def test_windowed_int8_step_calls_each_kernel_as_the_card_must(
        rule, W, overlap, monkeypatch):
    _, pcfg = _cfgs()
    windows = 5 if W == 4 else 4
    eng = PHubEngine(pcfg, _tc(rule, pipeline_windows=windows,
                               overlap_backward=overlap),
                     StackedComm(W), device="cpu")
    (g,) = eng.chunk_plan.groups
    assert effective_windows(g, windows) == windows
    model, opt = eng.init_state()
    calls = _count_calls(monkeypatch)
    data = SyntheticTokens(pcfg, 8, T, seed=0)
    eng.make_train_step()(model, opt, data.torch_batch(0, "cpu"))
    assert calls == WINDOWED_CALLS[rule, W]


# ---------------------------------------------------- 3. W = 1 vs the JAX

def _flat(engine, tree):
    (flat,) = flatten_groups(engine.chunk_plan, tree).values()
    return flat.detach().clone()


@pytest.mark.parametrize("rule", list(RULES))
def test_w1_int8_windows_match_jax_engine_within_a_grid_step(rule):
    jcfg, pcfg = _cfgs()
    kw = dict(optimizer=rule, loss_chunk=LOSS_CHUNK, wire_format="int8",
              chunk_size_bytes=CHUNK_BYTES, pipeline_windows=4, **KW[rule])
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(use_pallas=True, **kw),
                     mesh=jax.make_mesh((1, 1), ("data", "model")))
    (jg,) = jeng.chunk_plan.groups
    assert jax_effective_windows(jg, 4) == 4
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(shapes)
    params, opt, _ = jstep(params, opt, jdata.device_batch(0))
    carried = jax.device_get(params), jax.device_get(opt)
    jlosses = []
    for i in (1, 2):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        jlosses.append(float(jm["loss"]))
    jparams, jopt = jax.device_get(params), jax.device_get(opt)

    peng = PHubEngine(pcfg, TrainConfig(**kw), StackedComm(1), device="cpu")
    (group,) = peng.chunk_plan.groups
    assert effective_windows(group, 4) == 4
    model = params_from_numpy(pcfg, carried[0], device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, carried[1],
                          slots=peng.exchange_slots, device="cpu")
    pstep = peng.make_train_step()
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)
    reset_launches()
    losses = []
    for i in (1, 2):
        p_prev = _flat(peng, model.param_tree())
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        losses.append(float(pm["loss"]))
    assert all(c == 0 for c in LAUNCHES.values())
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)
    ce = group.chunk_elems
    p_new = _flat(peng, model.param_tree())
    ef = popt["float32"][WIRE_EF_SLOT].reshape(-1)
    e = (p_new - p_prev) + ef
    bound = (e.view(-1, ce).abs().amax(1) / 127).repeat_interleave(ce) + ATOL
    jflat = _flat(peng, params_from_numpy(pcfg, jparams,
                                          device="cpu").param_tree())
    jef = torch.from_numpy(np.array(jopt["float32"][WIRE_EF_SLOT])
                           .reshape(-1))
    assert bool(((p_new - jflat).abs() <= bound).all())
    assert bool(((ef - jef).abs() <= bound).all())
    assert float(ef.abs().max()) > 0


# ------------------------------------- 4. and 5. membership and the gate

def _reference(S, rule, g, p, slots, r, ce, n_live, gate):
    """The reference's per-device ring over the stacked rows, shard by
    shard, from its eager jnp functions; the tail as the reference takes
    it: Nesterov's kernel form with ``inv_n = 1/n_live`` for a static
    count, else the decoded sum plus the own rows divided by ``n_live``
    (an array under the gate) and the rule's oracle.  Returns (p',
    slots', r') as numpy f32."""
    wire = JaxWire("int8")
    _, coefs = RULES[rule]
    n = p.numel()
    L = n // S
    G, P, R = _jnp(g), _jnp(p), _jnp(r)
    SL = [_jnp(t) for t in slots]
    N = jnp.asarray(n_live, jnp.float32) if gate else n_live
    p_out, s_out, r_out = [], [[] for _ in slots], []
    for j in range(S):
        cols = slice(j * L, (j + 1) * L)
        row = lambda w: G[w % S, cols].astype(jnp.float32)
        own = row(j)
        pw, sw = P[cols], tuple(t[cols] for t in SL)
        parts = wire.encode(row(j + 1), ce)
        for k in range(2, S):
            parts = wire.encode(wire.decode(parts, ce) + row(j + k), ce)
        if rule == "nesterov" and not gate:
            lr, mu = coefs
            p2, m2 = jax_dequant_ref(pw, *parts, own, sw[0], lr=lr,
                                     momentum=mu, inv_n=1.0 / n_live,
                                     chunk_elems=ce)
            s2 = (m2,)
        else:
            gin = (wire.decode(parts, ce) + own) / N
            if rule == "nesterov":
                p2, m2 = jax_agg_opt_ref(pw, gin, sw[0], lr=coefs[0],
                                         momentum=coefs[1])
                s2 = (m2,)
            elif rule == "sgd":
                p2, s2 = jax_sgd_ref(pw, gin, lr=coefs[0]), ()
            else:
                p2, *s2 = jax_adam_ref(pw, gin, *sw, lr=coefs[0])
        e = (p2.astype(jnp.float32) - pw.astype(jnp.float32)) + R[cols]
        pull = wire.encode(e, ce)
        r_out.append(e - wire.decode(pull, ce))
        p_out.append((pw.astype(jnp.float32) + wire.decode(pull, ce))
                     .astype(pw.dtype))
        for acc, t in zip(s_out, s2):
            acc.append(t)
    cat = lambda xs: _np(jnp.concatenate(xs))
    return cat(p_out), tuple(cat(x) for x in s_out), cat(r_out)


def _assert_equals_reference(got, want):
    (p2, s2, r2), (wp, ws, wr) = got, want
    np.testing.assert_array_equal(p2.float().numpy(), wp)
    np.testing.assert_array_equal(r2.numpy(), wr)
    assert len(s2) == len(ws)
    for a, b in zip(s2, ws):
        np.testing.assert_array_equal(a.float().numpy(), b)


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("dead", [0, 3])
@pytest.mark.parametrize("windows", [1, 3])
def test_int8_membership_equals_reference_ring_bitwise(rule, dead, windows):
    group = _group(W4)
    g, p, slots, r = _setup(W4, rule, torch.float32, group.padded,
                            seed=dead + 5 * windows + len(rule))
    g[dead] = 0                                 # the k-of-n push mask
    got = _exchange(W4, rule, g, p, slots, r, 64, windows=windows,
                    n_live=3.0)
    _assert_equals_reference(got, _reference(W4, rule, g, p, slots, r, 64,
                                             3.0, gate=False))


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("windows", [1, 3])
def test_int8_gate_equals_reference_jnp_tail_bitwise(rule, windows):
    group = _group(W4)
    g, p, slots, r = _setup(W4, rule, torch.float32, group.padded,
                            seed=11 + windows + len(rule))
    g[1] = 0                                    # the gate zeroed worker 1
    n_live = torch.tensor(3.0)
    got = _exchange(W4, rule, g, p, slots, r, 64, windows=windows,
                    n_live=n_live)
    _assert_equals_reference(got, _reference(W4, rule, g, p, slots, r, 64,
                                             3.0, gate=True))
    if rule == "nesterov":
        # the static kernel multiplies by 1/3: not the gate's bits (the
        # momentum shows it; the pull's grid step hides it in p)
        static = _exchange(W4, rule, g, p, slots, r, 64, windows=windows,
                           n_live=3.0)
        assert not torch.equal(static[1][0], got[1][0])


@pytest.mark.parametrize("rule", list(RULES))
def test_engine_int8_gated_poisoned_equals_static_dead_at_4_live(
        rule, deterministic):
    """Five workers, worker 1 NaN-poisoned under the gate or dead in the
    membership: 4 live, where ``* 1/4`` and ``/ 4`` agree, so the two
    steps are equal bitwise (in 5 windows and chunk-ready too)."""
    mode = dict(pipeline_windows=3)
    dead = _engine_run(rule, 5, mode, batch=10,
                       membership=Membership.full(5).leave(1))
    gated = _engine_run(rule, 5, mode, batch=10,
                        health={"norm_hi": np.float32(np.inf),
                                "inject": np.asarray([1, np.nan, 1, 1, 1],
                                                     np.float32)})
    _assert_same_run(gated, dead)
    chunk_ready = _engine_run(rule, 5, dict(mode, overlap_backward=True),
                              batch=10,
                              membership=Membership.full(5).leave(1))
    _assert_same_run(chunk_ready, dead)


# ------------------------------------------- 6. B7's plain version, strips

def _dequant_inputs(S, windows, w, ce, seed, dtype=torch.float32):
    """Integer-valued p, m, stacked g (S, n), codes and scales of window
    w's strips, and the strips' views."""
    rng = np.random.default_rng(seed)
    n = S * windows * 2 * ce
    ints = lambda *shape: torch.from_numpy(
        rng.integers(-64, 64, shape).astype(np.float32)).to(dtype)
    p, m, g = ints(n), ints(n), ints(S, n)
    nw = n // windows
    q = torch.from_numpy(rng.integers(-127, 128, nw).astype(np.int8))
    s = torch.from_numpy(2.0 ** rng.integers(-3, 3, nw // ce)
                         .astype(np.float32))
    L = n // S
    Lw = L // windows
    strip = lambda v: v.view(S, L)[:, w * Lw:(w + 1) * Lw]
    return p, m, g, q, s, strip


@pytest.mark.parametrize("S", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequant_plain_on_window_strips_matches_reference_bitwise(S, dtype):
    ce, windows, w = 32, 3, 1
    p, m, g, q, s, strip = _dequant_inputs(S, windows, w, ce, seed=S,
                                           dtype=dtype)
    own = own_strips(g, windows, w)
    assert own.stride() == (g.shape[1] + g.shape[1] // S, 1)
    for j in range(S):
        assert torch.equal(own[j], strip(g[j])[j])
    kw = dict(lr=0.5, momentum=0.5, chunk_elems=ce)
    got = dequant_agg_opt_ref(strip(p), q, s, own, strip(m), inv_n=0.25,
                              **kw)
    want = jax_dequant_ref(_jnp(strip(p).reshape(-1)), jnp.asarray(q.numpy()),
                           jnp.asarray(s.numpy()),
                           _jnp(own.reshape(-1)), _jnp(strip(m).reshape(-1)),
                           inv_n=0.25, **kw)
    for a, b in zip(got, want):
        assert a.shape == (S, p.numel() // S // windows)
        np.testing.assert_array_equal(a.float().numpy().reshape(-1),
                                      _np(b))
    # a divisor of 4 on integer values: the same bits as * 1/4
    div = dequant_agg_opt_ref(strip(p), q, s, own, strip(m), inv_n=0.5,
                              divisor=torch.tensor([4.0]), **kw)
    assert all(torch.equal(a, b) for a, b in zip(div, got))


def test_dequant_divisor_3_matches_the_jnp_tail_bitwise():
    ce, S, windows, w = 32, 4, 3, 2
    rng = np.random.default_rng(3)
    n = S * windows * 2 * ce
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    p, m, g = f(n), f(n), f(S, n) * 1e-2
    L, Lw = n // S, n // S // windows
    strip = lambda v: v.view(S, L)[:, w * Lw:(w + 1) * Lw]
    q, s = quant.ops.quantize_int8(f(S * Lw), chunk_elems=ce)
    own = own_strips(g, windows, w)
    got = dequant_agg_opt_ref(strip(p), q, s, own, strip(m), lr=0.05,
                              momentum=0.9, inv_n=1 / 3, chunk_elems=ce,
                              divisor=torch.tensor([3.0]))
    wire = JaxWire("int8")
    gin = ((wire.decode((jnp.asarray(q.numpy()), jnp.asarray(s.numpy())), ce)
            + _jnp(own.reshape(-1))) / jnp.asarray(3.0, jnp.float32))
    want = jax_agg_opt_ref(_jnp(strip(p).reshape(-1)), gin,
                           _jnp(strip(m).reshape(-1)), lr=0.05, momentum=0.9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().reshape(-1), _np(b))
    inv = dequant_agg_opt_ref(strip(p), q, s, own, strip(m), lr=0.05,
                              momentum=0.9, inv_n=1 / 3, chunk_elems=ce)
    assert not torch.equal(inv[0], got[0])      # * 1/3 is not / 3


def test_dequant_wrapper_writes_window_strips_in_place():
    """The windowed form: p' into p_out's strips, m's strips updated in
    place, everything outside the window untouched; the layout checks."""
    ce, S, windows, w = 32, 4, 3, 1
    p, m, g, q, s, strip = _dequant_inputs(S, windows, w, ce, seed=9)
    own = own_strips(g, windows, w)
    kw = dict(lr=0.5, momentum=0.5, inv_n=0.25, chunk_elems=ce)
    want = dequant_agg_opt_ref(strip(p), q, s, own, strip(m), **kw)
    p_out = torch.full_like(p, 7.0)
    m0 = m.clone()
    ops.fused_dequant_agg_opt(strip(p), q, s, own, strip(m), p_out=strip(
        p_out), **kw)
    assert torch.equal(strip(p_out), want[0])
    assert torch.equal(strip(m), want[1])
    outside = torch.ones_like(p, dtype=torch.bool)
    strip(outside).zero_()
    assert bool((p_out[outside] == 7.0).all())
    assert torch.equal(m[outside], m0[outside])
    with pytest.raises(ValueError, match="pass p_out"):
        ops.fused_dequant_agg_opt(strip(p), q, s, own, strip(m), **kw)
    with pytest.raises(ValueError, match="whole chunks"):
        ops.fused_dequant_agg_opt(strip(p)[:, :-1], q, s, own[:, :-1],
                                  strip(m)[:, :-1], p_out=strip(p_out)[:, :-1],
                                  **kw)
