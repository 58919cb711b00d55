"""Weight decay (``TrainConfig.weight_decay``) in the port against the JAX
package's.

1. The protocol bodies (``NesterovOptimizer.update``, ``AdamOptimizer.
   update`` with ``weight_decay``) against the reference's, both jitted:
   bitwise on integer-valued inputs at power-of-two coefficients (every
   product and sum exact, so XLA:CPU's FMA contraction cannot show), within
   2 ulp on random inputs at lr 0.05, wd 0.1 (XLA contracts the jnp body
   into FMAs, ROADMAP.md queue C), the ulp of the largest magnitude among
   the operands, the decayed gradient ``g + wd*p`` and the results at each
   position (where an update cancels to near 0, the result's own ulp is no
   measure); the reference's body run eagerly (no contraction) is equal
   bitwise.  SGD ignores the decay in both.
2. The plain versions of the kernels (``kernels/agg_opt/ref.py``, what the
   CUDA kernels are held to on the card): the decayed rule equals the rule
   without decay on ``g + wd * p`` formed by hand (f32, the term after the
   worker mean, the divisor, or the int8 tail's decode and scale), and for
   Nesterov equals the protocol body bitwise (bf16 through f32 as the
   kernel computes); on a strided strip of a stacked buffer, bf16 groups,
   a ragged length, NaN and Inf; wd = 0 leaves the bits as they were.
3. A reduced llama3.2-1b W=1 step under Nesterov and under Adam with decay
   against the reference's ``PHubEngine`` on a one-device mesh
   (``use_pallas=False``: the reference's kernels have no decay), losses to
   rtol 1e-5 and parameters to 1e-6 (``tests/test_torch_engine.py``'s).
4. Two co-scheduled tenants that differ only in ``weight_decay`` (two
   rules, the dataclasses are frozen) each equal their solo run bitwise
   over the identity wire.
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
from repro.optim import protocol as jproto
from repro_torch.configs import TrainConfig, get_arch, reduced as preduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubConnectionManager, StackedComm
from repro_torch.core import PHubEngine
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (adam_opt_ref, agg_opt_ref,
                                             decayed, dequant_agg_opt_ref,
                                             multi_agg_opt_ref, worker_mean)
from repro_torch.optim import protocol as pproto

N = 3001                        # ragged against every chunk size here
WD, LR, MU = 0.1, 0.05, 0.9
T, LOSS_CHUNK = 32, 16
LOSS_RTOL, PARAM_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps_of(a: np.ndarray, b: np.ndarray, scale: np.ndarray) -> float:
    """Largest |a - b| in f32 units in the last place of max(|a|, scale),
    ``scale`` the operands' largest magnitude at each position."""
    mag = np.maximum(np.abs(a), scale).astype(np.float32)
    return float((np.abs(a.astype(np.float64) - b.astype(np.float64))
                  / np.spacing(mag)).max())


def _rule(name, wd, **kw):
    cls_p = {"nesterov": pproto.NesterovOptimizer,
             "adam": pproto.AdamOptimizer, "sgd": pproto.SGDOptimizer}[name]
    cls_j = {"nesterov": jproto.NesterovOptimizer,
             "adam": jproto.AdamOptimizer, "sgd": jproto.SGDOptimizer}[name]
    return cls_p(weight_decay=wd, **kw), cls_j(weight_decay=wd, **kw)


def _draw(name, exact, seed):
    """p, g and the rule's slots (f32): integer-valued or random."""
    rng = np.random.default_rng(seed)
    if exact:
        p = rng.integers(-64, 64, N).astype(np.float32)
        g = rng.integers(-64, 64, N).astype(np.float32)
        m = rng.integers(-64, 64, N).astype(np.float32)
    else:
        p, g, m = (rng.standard_normal(N).astype(np.float32)
                   for _ in range(3))
    if name == "nesterov":
        return p, g, (m,)
    if name == "sgd":
        return p, g, ()
    v = np.abs(m) if exact else rng.random(N).astype(np.float32)
    k = (np.where(rng.random(N) < 0.5, 0.5, 0.0).astype(np.float32)
         if exact else rng.random(N).astype(np.float32) * 0.5)
    return p, g, (m, v, k, k * 0.5 if exact else k * k)


@pytest.mark.parametrize("exact", [True, False], ids=["exact", "random"])
@pytest.mark.parametrize("name", ["nesterov", "adam", "sgd"])
def test_protocol_body_with_decay_matches_reference(name, exact):
    wd = 0.5 if exact else WD
    kw = {"eps": 2.0 ** -10, "b1": 0.5, "b2": 0.75} if name == "adam" \
        and exact else {}
    popt, jopt = _rule(name, wd, **kw)
    coefs = {"nesterov": (0.25, 0.5) if exact else (LR, MU),
             "sgd": (0.25,) if exact else (LR,),
             "adam": (0.25,) if exact else (1e-3,)}[name]
    p, g, slots = _draw(name, exact, seed=len(name))
    jp, js = jax.jit(lambda p, g, s: jopt.update(p, g, s, coefs))(
        jnp.asarray(p), jnp.asarray(g), tuple(map(jnp.asarray, slots)))
    tp, ts = popt.update(torch.from_numpy(p), torch.from_numpy(g),
                         tuple(torch.from_numpy(s) for s in slots), coefs)
    pairs = [(tp, jp)] + list(zip(ts, js))
    scale = np.max(np.abs(np.stack(
        [p, g, g + np.float32(wd) * p, *slots, tp.numpy(),
         *(t.numpy() for t in ts)])), axis=0)
    for a, b in pairs:
        a, b = a.numpy(), np.asarray(b)
        if exact:
            assert a.tobytes() == b.tobytes()
        else:
            assert _ulps_of(a, b, scale) <= 2
    ep, es = jopt.update(jnp.asarray(p), jnp.asarray(g),
                         tuple(map(jnp.asarray, slots)), coefs)
    for a, b in zip((tp, *ts), (ep, *es)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    nodecay, _ = _rule(name, 0.0, **kw)
    tp0, _ = nodecay.update(torch.from_numpy(p), torch.from_numpy(g),
                            tuple(torch.from_numpy(s) for s in slots),
                            coefs)
    assert torch.equal(tp0, tp) == (name == "sgd"), \
        "decay must move Nesterov and Adam, and never SGD"


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.contiguous().view(torch.int16 if a.dtype ==
                                                torch.bfloat16
                                                else torch.int32),
                            b.contiguous().view(torch.int16 if b.dtype ==
                                                torch.bfloat16
                                                else torch.int32)))


def _specials(x: torch.Tensor) -> torch.Tensor:
    x = x.clone()
    x[5], x[17], x[101] = float("nan"), float("inf"), -float("inf")
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [1, 3])
def test_plain_nesterov_decay_is_the_term_before_the_rule(W, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(W)
    p = _specials(torch.randn(N, generator=gen)).to(dt)
    m = torch.randn(N, generator=gen).to(dt)
    buf = (torch.randn(W, N + 64, generator=gen) * 1e-2).to(dt)
    g = buf[:, 16:16 + N]               # a strip, rows N + 64 apart
    gin = g[0] if W == 1 else g
    ref = agg_opt_ref if W == 1 else multi_agg_opt_ref
    got = ref(p, gin, m, lr=LR, momentum=MU, weight_decay=WD)
    g32 = gin.float() if W == 1 else worker_mean(g)
    want = agg_opt_ref(p, decayed(g32, p, WD), m, lr=LR, momentum=MU)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    # the protocol body, in f32 as the kernel computes, rounded once
    body_p, (body_m,) = pproto.NesterovOptimizer(weight_decay=WD).update(
        p.float(), g32, (m.float(),), (LR, MU))
    assert _bits_equal(got[0], body_p.to(dt))
    assert _bits_equal(got[1], body_m.to(dt))
    # the wrapper (the plain version on the CPU) on the strip in place
    fused = (ops.fused_agg_opt if W == 1 else ops.fused_multi_agg_opt)(
        p, gin, m.clone(), lr=LR, momentum=MU, weight_decay=WD,
        chunk_elems=1024)
    assert all(_bits_equal(a, b) for a, b in zip(fused, got))
    assert torch.isnan(got[0][5]) and torch.isinf(got[1][17])
    # wd = 0: the term is left out, not added as 0 * p (0 * inf = NaN)
    plain = ref(p, gin, m, lr=LR, momentum=MU)
    zero = ref(p, gin, m, lr=LR, momentum=MU, weight_decay=0.0)
    assert all(_bits_equal(a, b) for a, b in zip(plain, zero))
    assert not torch.isnan(zero[0][17])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("W", [1, 4])
def test_plain_adam_decay_is_the_term_before_the_rule(W, dtype):
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(10 + W)
    p = _specials(torch.randn(N, generator=gen)).to(dt)
    m, v = torch.randn(N, generator=gen).to(dt), \
        torch.rand(N, generator=gen).to(dt)
    k1, k2 = torch.rand(N, generator=gen), torch.rand(N, generator=gen)
    k1[::5] = 0                          # positions that never saw gradient
    g = (torch.randn(W, N, generator=gen) * 1e-2).to(dt)
    g[:, ::5] = 0
    gin = g[0] if W == 1 else g
    d = torch.tensor([3.0]) if W > 1 else None
    got = adam_opt_ref(p, gin, m, v, k1, k2, lr=1e-3, eps=1e-3, divisor=d,
                       weight_decay=WD)
    g32 = gin.float() if W == 1 else worker_mean(g, d)
    want = adam_opt_ref(p, decayed(g32, p, WD), m, v, k1, k2, lr=1e-3,
                        eps=1e-3)
    assert all(_bits_equal(a, b) for a, b in zip(got, want))
    # decay makes a zero-gradient position with p != 0 alive: its k ticks
    alive = (p != 0) & (k1 == 0) & (g32 == 0)
    assert bool(alive.any()) and bool((got[3][alive] > 0).all())
    zero = adam_opt_ref(p, gin, m, v, k1, k2, lr=1e-3, eps=1e-3, divisor=d,
                        weight_decay=0.0)
    plain = adam_opt_ref(p, gin, m, v, k1, k2, lr=1e-3, eps=1e-3, divisor=d)
    assert all(_bits_equal(a, b) for a, b in zip(zero, plain))
    # the wrapper, slots in place
    slots = [t.clone() for t in (m, v, k1, k2)]
    fused = ops.fused_adam_opt(p, gin, *slots, lr=1e-3, eps=1e-3,
                               divisor=d, weight_decay=WD, chunk_elems=512)
    assert all(_bits_equal(a, b) for a, b in zip(fused, got))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_dequant_tail_decays_after_the_decode(dtype):
    dt = getattr(torch, dtype)
    ce, S = 128, 3
    n = ce * 4 * S
    gen = torch.Generator().manual_seed(7)
    p = _specials(torch.randn(n, generator=gen)).to(dt)
    m = torch.randn(n, generator=gen).to(dt)
    own = (torch.randn(S, n, generator=gen) * 1e-2).to(dt)
    q = torch.randint(-127, 128, (n,), generator=gen, dtype=torch.int8)
    scales = torch.rand(n // ce, generator=gen) * 1e-3
    for div in (None, torch.tensor([3.0])):
        got = dequant_agg_opt_ref(p, q, scales, own, m, lr=LR, momentum=MU,
                                  inv_n=1 / 3, chunk_elems=ce, divisor=div,
                                  weight_decay=WD)
        gm = (q.float().view(-1, ce) * scales[:, None]).reshape(-1) + \
            ops.own_strips(own).reshape(-1).float()
        gm = gm / div if div is not None else gm * (1 / 3)
        want = agg_opt_ref(p, decayed(gm, p, WD), m, lr=LR, momentum=MU)
        assert all(_bits_equal(a, b) for a, b in zip(got, want))
        fused = ops.fused_dequant_agg_opt(
            p, q, scales, own, m.clone(), lr=LR, momentum=MU, inv_n=1 / 3,
            chunk_elems=ce, divisor=div, weight_decay=WD)
        assert all(_bits_equal(a, b) for a, b in zip(fused, got))


# ------------------------------------------- 3. the engine against the JAX's

def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(preduced(get_arch("llama3.2-1b"),
                                        d_model=128), dtype="float32")
    return jcfg, pcfg


@pytest.mark.parametrize("rule", ["nesterov", "adam"])
def test_w1_decay_steps_match_jax_engine(rule):
    jcfg, pcfg = _cfgs()
    kw = dict(optimizer=rule, lr=LR if rule == "nesterov" else 1e-4,
              weight_decay=WD, loss_chunk=LOSS_CHUNK)
    if rule == "adam":
        kw["adam_eps"] = 1e-3
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(use_pallas=False, **kw),
                     mesh=jax.make_mesh((1, 1), ("data", "model")))
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    peng = PHubEngine(pcfg, TrainConfig(**kw), StackedComm(1), device="cpu")
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, jax.device_get(opt),
                          slots=peng.exchange_slots, device="cpu")
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)
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


# ------------------------------------------ 4. co-scheduled tenants, bitwise

def test_co_step_tenants_differing_only_in_decay_equal_solo_runs():
    torch.use_deterministic_algorithms(True)
    try:
        cfg = preduced(get_arch("llama3.2-1b"), d_model=64)
        tcs = {"A": TrainConfig(loss_chunk=16, weight_decay=0.0),
               "B": TrainConfig(loss_chunk=16, weight_decay=WD)}
        batches = {ns: SyntheticTokens(cfg, 4, 16, seed=i)
                   for i, ns in enumerate(tcs)}
        comm = StackedComm(2)
        solo = {}
        for i, (ns, tc) in enumerate(tcs.items()):
            eng = PHubEngine(cfg, tc, comm, device="cpu")
            model, opt = eng.init_state(i)
            step = eng.make_train_step()
            for s in range(2):
                model, opt, _ = step(model, opt,
                                     batches[ns].torch_batch(s, "cpu"))
            solo[ns] = dict(leaf_paths(model.param_tree()))
        cm = PHubConnectionManager()
        hs = {ns: cm.create_service(ns, cfg, tc, comm, device="cpu")
              for ns, tc in tcs.items()}
        models = {ns: cm.init_service(h, i)[0]
                  for i, (ns, h) in enumerate(hs.items())}
        cm.attach_services(list(hs.values()))
        assert cm.connect_service(hs["A"]).sopt != \
            cm.connect_service(hs["B"]).sopt
        for s in range(2):
            models, _ = cm.co_step(list(hs.values()), models,
                                   {ns: b.torch_batch(s, "cpu")
                                    for ns, b in batches.items()})
        for ns in tcs:
            for path, t in leaf_paths(models[ns].param_tree()):
                assert _bits_equal(t.detach(), solo[ns][path].detach()), \
                    (ns, path)
    finally:
        torch.use_deterministic_algorithms(False)
