"""The port's SGD and Adam rules against the JAX package: the plain versions
of ``sgd_opt_chunks`` / ``adam_opt_chunks`` and their wrappers against the
jnp oracles (run eagerly) and the Pallas kernels (interpret mode), and the
protocol bodies ``SGDOptimizer.update`` / ``AdamOptimizer.update`` against
the reference's.  The CUDA kernels themselves are held against the plain
versions on the card in tests/test_torch_gpu.py.

Tolerances:
- Against the eager jnp oracles (``sgd_opt_ref``, ``adam_opt_ref``, fed the
  worker mean summed in worker order and divided by W) the port is
  bitwise, f32 and bf16, every W.
- The port's ``update`` bodies equal the reference's protocol bodies
  bitwise, f32 and bf16: in a bf16 body both round each Python constant to
  bf16 first (JAX's weak typing).
- XLA:CPU compiles the interpret-mode Pallas kernels with FMA contraction
  (one rounding where the port rounds twice), so against them the port is
  held within a stated bound, twice the largest gap seen over 30 seeds:
  SGD |dp'| <= 2 ulp(|p| + lr*|g|); Adam |dm'| <= 2 ulp(b1*|m| + (1-b1)*|g|),
  |dv'| <= 2 ulp(b2*v + (1-b2)*g*g), |dk'| <= 2 ulp(b*k + (1-b)), and
  |dp'| <= ulp(p') + 4 ulp(A*(b1*|m| + (1-b1)*|g|)) with
  A = lr*sqrt(k2')/(k1'*(sqrt(v') + eps*sqrt(k2'))), the step's size had
  every term of m' one sign.  bf16 results may differ by one bf16 ulp more.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_opt.kernel import adam_opt_chunks, sgd_opt_chunks
from repro.kernels.agg_opt.ref import (adam_opt_ref as jax_adam_ref,
                                       sgd_opt_ref as jax_sgd_ref)
from repro.optim import protocol as jproto
from repro_torch.configs import TrainConfig
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, sgd_opt_ref,
                                             worker_mean)
from repro_torch.optim import protocol as pproto

NC, CE = 4, 256
LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8
ADAM = dict(lr=LR, b1=B1, b2=B2, eps=EPS)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _adam_inputs(seed, W, shape):
    """p, g (W, ...), m, v, k1, k2 as f32 numpy: gradients over six decades
    with zero runs (dead positions), slots mid-run, k1/k2 zero on a run."""
    rng = np.random.default_rng(seed)
    p = rng.standard_normal(shape).astype(np.float32)
    g = (rng.standard_normal((W, *shape))
         * 10.0 ** rng.integers(-6, 0, (W, *shape))).astype(np.float32)
    g[..., :8] = 0
    m = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    v = (np.abs(rng.standard_normal(shape)) * 1e-4).astype(np.float32)
    k1 = rng.uniform(0, 1, shape).astype(np.float32)
    k2 = rng.uniform(0, 1, shape).astype(np.float32)
    k1[..., :4] = k2[..., :4] = 0
    m[..., :4] = v[..., :4] = 0
    return p, g, m, v, k1, k2


def _to_t(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax_mean(g, jdt):
    """The worker mean as the port takes it: f32, worker order, / W."""
    g = jnp.asarray(g).astype(jdt).astype(jnp.float32)
    acc = g[0]
    for w in range(1, g.shape[0]):
        acc = acc + g[w]
    return acc / g.shape[0] if g.shape[0] > 1 else acc


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a).astype(jnp.float32))


def _ulp(x):
    return np.spacing(np.abs(x).astype(np.float32)).astype(np.float64)


def _bf16_ulp(x):
    return np.where(np.abs(x) > 0, 2.0 ** (np.floor(np.log2(
        np.maximum(np.abs(x), 1e-38))) - 7), 0)


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_adam_bitwise_against_jnp_oracle(W, dt):
    tdt, jdt = DTYPES[dt]
    p, g, m, v, k1, k2 = _adam_inputs(W, W, (NC, CE))
    gg = _to_t(g, tdt)
    got = adam_opt_ref(_to_t(p, tdt), gg if W > 1 else gg[0], _to_t(m, tdt),
                       _to_t(v, tdt), _to_t(k1, torch.float32),
                       _to_t(k2, torch.float32), **ADAM)
    want = jax_adam_ref(jnp.asarray(p).astype(jdt), _jax_mean(g, jdt),
                        jnp.asarray(m).astype(jdt),
                        jnp.asarray(v).astype(jdt), jnp.asarray(k1),
                        jnp.asarray(k2), **ADAM)
    assert [a.dtype for a in got] == [tdt, tdt, tdt, torch.float32,
                                      torch.float32]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_f32(a), _f32(b))


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_sgd_bitwise_against_jnp_oracle(W, dt):
    tdt, jdt = DTYPES[dt]
    p, g = _adam_inputs(20 + W, W, (NC, CE))[:2]
    gg = _to_t(g, tdt)
    got = sgd_opt_ref(_to_t(p, tdt), gg if W > 1 else gg[0], lr=0.05)
    want = jax_sgd_ref(jnp.asarray(p).astype(jdt), _jax_mean(g, jdt),
                       lr=0.05)
    assert got.dtype == tdt
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("W", [1, 3, 4])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_adam_within_fma_bound_of_pallas_kernel(W, dt):
    """The TPU kernel takes a pre-aggregated g: it gets the f32 worker
    mean, the port the stacked gradients."""
    tdt, jdt = DTYPES[dt]
    p, g, m, v, k1, k2 = _adam_inputs(40 + W, W, (NC, CE))
    gg = _to_t(g, tdt)
    got = adam_opt_ref(_to_t(p, tdt), gg if W > 1 else gg[0], _to_t(m, tdt),
                       _to_t(v, tdt), _to_t(k1, torch.float32),
                       _to_t(k2, torch.float32), **ADAM)
    pal = adam_opt_chunks(jnp.asarray(p).astype(jdt),
                          _jax_mean(g, jdt), jnp.asarray(m).astype(jdt),
                          jnp.asarray(v).astype(jdt), jnp.asarray(k1),
                          jnp.asarray(k2), interpret=True, **ADAM)
    got, pal = [_f32(a) for a in got], [_f32(a) for a in pal]
    p, m, v = (_f32(_to_t(a, tdt)) for a in (p, m, v))
    gm = _f32(worker_mean(gg) if W > 1 else gg[0].float()).astype(np.float64)
    s_m = B1 * np.abs(m) + (1 - B1) * np.abs(gm)
    s_v = B2 * v + (1 - B2) * gm * gm
    k1n, k2n = got[3].astype(np.float64), got[4].astype(np.float64)
    rk2 = np.sqrt(k2n)
    with np.errstate(divide="ignore", invalid="ignore"):
        a = np.where(k1n > 0, LR * rk2 / k1n
                     / (np.sqrt(got[2].astype(np.float64)) + EPS * rk2), 0)
    bounds = [_ulp(got[0]) + 4 * _ulp(a * s_m), 2 * _ulp(s_m),
              2 * _ulp(s_v), 2 * _ulp(B1 * k1 + (1 - B1)),
              2 * _ulp(B2 * k2 + (1 - B2))]
    for i, (x, y, bound) in enumerate(zip(got, pal, bounds)):
        if dt == "bfloat16" and i < 3:
            bound = bound + _bf16_ulp(x)
        err = np.abs(x.astype(np.float64) - y)
        assert np.all(err <= bound), (i, float((err - bound).max()))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_plain_sgd_within_fma_bound_of_pallas_kernel(dt):
    tdt, jdt = DTYPES[dt]
    p, g = _adam_inputs(60, 1, (NC, CE))[:2]
    got = _f32(sgd_opt_ref(_to_t(p, tdt), _to_t(g[0], tdt), lr=0.05))
    pal = _f32(sgd_opt_chunks(jnp.asarray(p).astype(jdt),
                              jnp.asarray(g[0]).astype(jdt), lr=0.05,
                              interpret=True))
    pp, gg = _f32(_to_t(p, tdt)), _f32(_to_t(g[0], tdt))
    bound = 2 * _ulp(np.abs(pp) + 0.05 * np.abs(gg))
    if dt == "bfloat16":
        bound = bound + _bf16_ulp(got)
    assert np.all(np.abs(got.astype(np.float64) - pal) <= bound)


@pytest.mark.parametrize("W", [1, 4])
def test_wrappers_ragged_n_match_reference_and_update_slots_in_place(W):
    """n not a multiple of ce (the wrappers pad to whole chunks): the
    results equal the jnp oracle on the unpadded vectors, and Adam's slots
    come back as the very tensors passed in."""
    n, ce = 5000, 1024
    p, g, m, v, k1, k2 = _adam_inputs(70 + W, W, (n,))
    tp, tg, tm, tv, tk1, tk2 = (torch.from_numpy(a.copy())
                                for a in (p, g, m, v, k1, k2))
    ops.reset_launches()
    out = ops.fused_adam_opt(tp, tg if W > 1 else tg[0], tm, tv, tk1, tk2,
                             chunk_elems=ce, **ADAM)
    sgd = ops.fused_sgd_opt(tp, tg if W > 1 else tg[0], lr=0.05,
                            chunk_elems=ce)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert all(c == 0 for c in ops.LAUNCHES.values())
    assert all(a is b for a, b in zip(out[1:], (tm, tv, tk1, tk2)))
    np.testing.assert_array_equal(tp.numpy(), p)        # p is not written
    got = [t.numpy() for t in out]
    assert all(a.shape == (n,) for a in got)
    want = jax_adam_ref(jnp.asarray(p), _jax_mean(g, jnp.float32),
                        jnp.asarray(m), jnp.asarray(v), jnp.asarray(k1),
                        jnp.asarray(k2), **ADAM)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(
        sgd.numpy(), np.asarray(jax_sgd_ref(jnp.asarray(p),
                                            _jax_mean(g, jnp.float32),
                                            lr=0.05)))


def test_pad_tails_stay_zero_through_the_gate():
    """A zero tail of g into zero slots is a dead position: five Adam steps
    leave its m, v, k1, k2 at +0 and its p bitwise (-0.0 included)."""
    n, live = 3000, 2500
    rng = np.random.default_rng(5)
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    p[live::2] = -0.0
    slots = (torch.zeros(n), torch.zeros(n), torch.zeros(n), torch.zeros(n))
    tail = p[live:].clone()
    for step in range(5):
        g = torch.from_numpy(rng.standard_normal((4, n)).astype(np.float32))
        g[:, live:] = 0
        p, *_ = ops.fused_adam_opt(p, g, *slots, chunk_elems=1024, **ADAM)
    for s in slots:
        assert torch.equal(s[live:], torch.zeros(n - live))
        assert not torch.signbit(s[live:]).any()
        assert (s[:live] != 0).any()
    assert torch.equal(p[live:], tail)
    assert torch.equal(torch.signbit(p[live:]), torch.signbit(tail))
    k1 = torch.zeros(())
    for _ in range(5):
        k1 = 0.9 * k1 + (1 - 0.9)
    assert torch.equal(slots[2][:live], k1.expand(live))


@pytest.mark.parametrize("rule", ["sgd", "adam"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_protocol_update_bitwise_against_jax_protocol(rule, dt):
    """Three steps of the protocol body from zero slots, a dead tail
    included, against the reference's body run eagerly."""
    tdt, jdt = DTYPES[dt]
    n = 2000
    rng = np.random.default_rng(7)
    p = rng.standard_normal(n).astype(np.float32)
    jopt = jproto.make_sharded_optimizer(_jax_tc(rule))
    popt = pproto.make_sharded_optimizer(TrainConfig(optimizer=rule,
                                                     lr=LR))
    coefs = popt.coefs(TrainConfig(optimizer=rule, lr=LR))
    assert coefs == jopt.coefs(_jax_tc(rule)) == (LR,)
    assert popt.slot_names == jopt.slot_names
    js = tuple(jnp.zeros(n, jnp.float32 if s.dtype else jdt)
               for s in jopt.slots)
    ts = tuple(torch.zeros(n, dtype=s.resolve_dtype(tdt))
               for s in popt.slots)
    jp, tp = jnp.asarray(p).astype(jdt), _to_t(p, tdt)
    for _ in range(3):
        g = rng.standard_normal(n).astype(np.float32) * 1e-2
        g[-100:] = 0
        jp, js = jproto.tuple_update(jopt, coefs)(jp, jnp.asarray(g)
                                                  .astype(jdt), js)
        tp, ts = pproto.tuple_update(popt, coefs)(tp, _to_t(g, tdt), ts)
        assert tp.dtype == tdt
        np.testing.assert_array_equal(_f32(tp), _f32(jp))
        for a, b in zip(ts, js):
            assert a.dtype == getattr(torch, str(b.dtype))
            np.testing.assert_array_equal(_f32(a), _f32(b))


def _jax_tc(rule):
    from repro.configs import TrainConfig as JaxTrainConfig
    return JaxTrainConfig(optimizer=rule, lr=LR)


@pytest.mark.parametrize("W", [1, 3])
def test_kernel_form_equals_protocol_form_to_1e6(W):
    """The reference holds its fused Adam kernel to its protocol body at
    atol 1e-6 (tests/test_optim.py); the port's two forms agree as well."""
    n = 3000
    rng = np.random.default_rng(3)
    p = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((W, n)).astype(np.float32))
    m = torch.from_numpy(rng.standard_normal(n).astype(np.float32)) * 0.1
    v = torch.from_numpy(np.abs(rng.standard_normal(n))
                         .astype(np.float32)) * 0.01
    k1 = torch.full((n,), 1 - 0.9 ** 3)
    k2 = torch.full((n,), 1 - 0.999 ** 3)
    opt = pproto.AdamOptimizer()
    gm = g[0] if W == 1 else worker_mean(g)
    want_p, want_s = pproto.tuple_update(opt, (0.01,))(p, gm, (m, v, k1, k2))
    got_p, got_s = opt.kernel_update(1024, (0.01,))(
        p, g[0] if W == 1 else g, tuple(t.clone() for t in (m, v, k1, k2)))
    torch.testing.assert_close(got_p, want_p, atol=1e-6, rtol=0)
    for a, b in zip(got_s, want_s):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    sgd = pproto.SGDOptimizer()
    got_p, () = sgd.kernel_update(1024, (0.05,))(p, g[0] if W == 1 else g,
                                                 ())
    want_p, () = pproto.tuple_update(sgd, (0.05,))(p, gm, ())
    assert torch.equal(got_p, want_p)


def test_make_sharded_optimizer_returns_each_rule():
    assert isinstance(pproto.make_sharded_optimizer(TrainConfig()),
                      pproto.NesterovOptimizer)
    assert isinstance(pproto.make_sharded_optimizer(
        TrainConfig(optimizer="sgd")), pproto.SGDOptimizer)
    adam = pproto.make_sharded_optimizer(TrainConfig(
        optimizer="adam", adam_b1=0.8, adam_b2=0.99, adam_eps=1e-3))
    assert adam == pproto.AdamOptimizer(b1=0.8, b2=0.99, eps=1e-3)
    assert adam.slot_names == ("m", "v", "k1", "k2")
    assert [s.resolve_dtype(torch.bfloat16) for s in adam.slots] == [
        torch.bfloat16, torch.bfloat16, torch.float32, torch.float32]
    assert pproto.SGDOptimizer().slots == ()
    assert tuple(pproto.OPTIMIZERS) == tuple(jproto.OPTIMIZERS)
    with pytest.raises(ValueError, match="unknown optimizer"):
        pproto.make_sharded_optimizer(TrainConfig(optimizer="lamb"))
    # weight decay reaches Nesterov and Adam, not SGD (the reference's
    # make_sharded_optimizer builds SGDOptimizer() without it)
    for name in ("nesterov", "sgd", "adam"):
        tc = TrainConfig(optimizer=name, weight_decay=0.1)
        got = pproto.make_sharded_optimizer(tc)
        want = jproto.make_sharded_optimizer(tc)
        assert got.weight_decay == want.weight_decay
        assert got.weight_decay == (0.0 if name == "sgd" else 0.1)
    with pytest.raises(TypeError, match="grad_clip"):
        TrainConfig(grad_clip=0.1)


@pytest.mark.parametrize("bad", ["k_dtype", "m_dtype", "alias", "shape"])
def test_adam_wrapper_rejects_what_the_kernel_does_not_take(bad):
    n = 512
    p, g = torch.zeros(n), torch.zeros(2, n)
    m, v, k1, k2 = (torch.zeros(n) for _ in range(4))
    if bad == "k_dtype":
        k1 = k1.to(torch.bfloat16)
    elif bad == "m_dtype":
        m = m.to(torch.bfloat16)
    elif bad == "alias":
        v = m
    else:
        k2 = torch.zeros(n + 1)
    with pytest.raises((TypeError, ValueError)):
        ops.fused_adam_opt(p, g, m, v, k1, k2, lr=LR)
