"""The port's Hymba hybrid (``models/ssm.py`` and the hybrid branches of
``models/model.py``) against the JAX package's, on the CPU.

``ssm_scan`` and ``ssm_branch``: the same recurrence in f32, products in
the reference's order, the outputs summed over N in another order; output
and last state within rtol 1e-5 of their largest entry, from a zero and a
nonzero state, in one block of steps and in several (the block length cut
to 5 steps).

The model: the reduced hymba-1.5b has 2 layers and ``global_layer_every``
16, so both layers are global; the checks take 4 layers with
``global_layer_every`` 3 (windows [0, 64, 64, 0]: global, sliding,
sliding, global) and, for the head ratio, a case with hymba's 5 query
heads a KV head (10 and 2, d_model 320).  Errors are max |got - want|
over max |want|, measured and then stated.  With f32 activations: the
prefill's logits within 1e-5 (measured 4.8e-6), the last state
``ssm_S`` within 1e-5 (4.2e-6), the cache's k/v (f32) within 5e-5 (the
deepest layer's sum differences add up over four layers, measured
1.5e-5), and 4 decode steps teacher-forced from the reference's cache
within 1e-5 (3.5e-6).  With bf16 activations a residual entry can round to
the neighbouring bf16 in one framework and not the other (2^-8
relative): the prefill's logits within 5e-3 (2.9e-3), decode within 1e-2
(4.2e-3).  Prefill then decode against the full forward, as the
reference's ``test_prefill_decode_consistency``: within its own bound
(0.08 of the largest entry).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.data import SyntheticTokens as JaxTokens
from repro.models import forward as jax_forward
from repro.models import init as jax_init
from repro.models import layer_windows as jax_windows
from repro.models import lm_head_weight, prefill as jax_prefill
from repro.models.model import cache_capacity as jax_capacity
from repro.models.model import init_cache as jax_init_cache
from repro.models.ssm import ssm_branch as jax_branch
from repro.models.ssm import ssm_scan as jax_scan
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs import reduced as port_reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.models import (GLOBAL_DECODE_CAP, cache_capacity,
                                init_cache, layer_windows, ssm)

ARCH = "hymba-1.5b"
B, T, N = 2, 32, 4
PREFILL_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
DECODE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
CACHE_TOL = {"k": 5e-5, "v": 5e-5, "ssm_S": 1e-5}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfgs(dtype="float32", heads=None):
    """The reduced hymba at 4 layers, windows [0, 64, 64, 0]; ``heads``
    (nh, kv) replaces the reduced 4/2, at d_model 320 and head_dim 320 /
    nh (the block norms the attention's output, d wide, with ``ln_attn``,
    nh * hd wide: hymba has nh * hd = d)."""
    d = 320 if heads else 256
    out = []
    for cfg in (reduced(ARCHS[ARCH], layers=4, d_model=d),
                port_reduced(get_arch(ARCH), layers=4, d_model=d)):
        cfg = dataclasses.replace(cfg, global_layer_every=3, dtype=dtype)
        if heads:
            cfg = dataclasses.replace(cfg, n_heads=heads[0],
                                      n_kv_heads=heads[1],
                                      head_dim=d // heads[0])
        out.append(cfg)
    return out


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# --------------------------------------------------------------- the scan

def _scan_inputs(seed, Bz=2, Tz=23, H=3, hd=8, Nz=4, zero_state=True):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((Bz, Tz, H, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((Bz, Tz, H)))).astype(
        np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm = rng.standard_normal((Bz, Tz, Nz)).astype(np.float32)
    Cm = rng.standard_normal((Bz, Tz, Nz)).astype(np.float32)
    S0 = (np.zeros((Bz, H, Nz, hd), np.float32) if zero_state else
          rng.standard_normal((Bz, H, Nz, hd)).astype(np.float32))
    return xh, dt, A, Bm, Cm, S0


@pytest.mark.parametrize("zero_state", [True, False])
@pytest.mark.parametrize("block", [None, 5])
def test_ssm_scan_matches_reference(zero_state, block, monkeypatch):
    if block:           # several blocks of 5 steps (the last one ragged)
        monkeypatch.setattr(ssm, "_BLOCK_ELEMS", block * 2 * 3 * 4 * 8)
    arrays = _scan_inputs(1, zero_state=zero_state)
    y_ref, s_ref = jax_scan(*(jnp.asarray(a) for a in arrays))
    y, s = ssm.ssm_scan(*(torch.from_numpy(a) for a in arrays))
    assert y.dtype == s.dtype == torch.float32
    assert _rel(y, y_ref) <= 1e-5 and _rel(s, s_ref) <= 1e-5


def test_ssm_branch_matches_reference():
    _, pcfg = _cfgs()
    rng = np.random.default_rng(2)
    d, H, hd, Nz = pcfg.d_model, pcfg.n_heads, pcfg.hd, pcfg.ssm_state
    p = {"w_in": rng.standard_normal((d, H * hd)) / np.sqrt(d),
         "w_gate": rng.standard_normal((d, H * hd)) / np.sqrt(d),
         "w_dt": rng.standard_normal((d, H)) / np.sqrt(d),
         "dt_bias": rng.standard_normal(H) * 0.1,
         "a_log": np.log(np.linspace(1.0, 16.0, H)),
         "w_B": rng.standard_normal((d, Nz)) / np.sqrt(d),
         "w_C": rng.standard_normal((d, Nz)) / np.sqrt(d),
         "w_out": rng.standard_normal((H * hd, d)) / np.sqrt(H * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((B, 17, d)).astype(np.float32)
    S0 = rng.standard_normal((B, H, Nz, hd)).astype(np.float32)
    y_ref, s_ref = jax_branch({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), pcfg, jnp.asarray(S0))
    y, s = ssm.ssm_branch({k: torch.from_numpy(v) for k, v in p.items()},
                          torch.from_numpy(x), pcfg, torch.from_numpy(S0))
    assert _rel(y, y_ref) <= 1e-5 and _rel(s, s_ref) <= 1e-5


def test_ssm_scan_grads_match_reference():
    arrays = _scan_inputs(3, Tz=12, zero_state=False)
    rng = np.random.default_rng(4)
    wy = rng.standard_normal((2, 12, 3, 8)).astype(np.float32)
    ws = rng.standard_normal((2, 3, 4, 8)).astype(np.float32)

    def jloss(*a):
        y, s = jax_scan(*a)
        return jnp.sum(y * wy) + jnp.sum(s * ws)
    want = jax.grad(jloss, argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, s = ssm.ssm_scan(*ts)
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (s * torch.from_numpy(ws)).sum(), ts)
    for name, g, w in zip(("xh", "dt", "A", "Bm", "Cm", "S0"), got, want):
        assert _rel(g, w) <= 1e-5, name


# ------------------------------------------------ windows and the cache

def test_windows_hymba():
    """The reference's ``test_windows_hymba``, in the port."""
    cfg = get_arch(ARCH)
    w = layer_windows(cfg)
    assert w[0] == 0 and w[16] == 0 and w[-1] == 0
    assert (w[1:16] == cfg.sliding_window).all()
    np.testing.assert_array_equal(w, jax_windows(ARCHS[ARCH]))
    assert cache_capacity(cfg, 524_288) == GLOBAL_DECODE_CAP == 32_768
    assert cache_capacity(get_arch("h2o-danube-3-4b"), 524_288) == 4096
    assert cache_capacity(get_arch("llama3.2-1b"), 32_768) == 32_768
    jcfg, pcfg = _cfgs()
    np.testing.assert_array_equal(layer_windows(pcfg), [0, 64, 64, 0])
    for seq in (1, 40, 2080, 32_768, 40_000):
        assert cache_capacity(pcfg, seq) == jax_capacity(jcfg, seq)
        assert cache_capacity(cfg, seq) == jax_capacity(ARCHS[ARCH], seq)


def test_init_cache_matches_reference():
    jcfg, pcfg = _cfgs()
    want = jax.device_get(jax_init_cache(jcfg, 2, 40))
    got = init_cache(pcfg, 2, 40, device="cpu")
    for name in ("k", "v", "pos", "ssm_S"):
        assert tuple(got[name].shape) == want[name].shape, name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name], np.float32))
    assert got["ssm_S"].dtype == torch.float32


# ------------------------------------------------------------ the model

def _setup(dtype, heads=None, prompt=T):
    jcfg, pcfg = _cfgs(dtype, heads)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    tok = JaxTokens(jcfg, B, prompt + N, seed=3).batch_at(0)["tokens"]
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    return jcfg, pcfg, params, tok, model


def _jax_logits(cfg, params, x):
    return np.asarray(x[:, -1].astype(jnp.float32)
                      @ lm_head_weight(cfg, params).astype(jnp.float32))


@pytest.mark.parametrize("dtype,heads,prompt", [
    ("float32", None, 80), ("bfloat16", None, 80), ("float32", (10, 2), 40),
    ("bfloat16", (10, 2), 40)])
def test_prefill_and_decode_match_reference(dtype, heads, prompt):
    """Prompt 80 > the window 64: the sliding layers mask the oldest
    keys.  Decode runs from the reference's own cache (``ssm_S`` included),
    teacher-forced."""
    jcfg, pcfg, params, tok, model = _setup(dtype, heads, prompt)
    cache_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_prefill(jcfg, params, jnp.asarray(tok[:, :prompt]),
                      cache_dtype=cache_dt, max_new_tokens=N)
    eng = PHubEngine(pcfg, TrainConfig(), StackedComm(1), device="cpu")
    torch_dt = getattr(torch, dtype)
    x, cache = model.prefill(torch.from_numpy(tok[:, :prompt]).long(),
                             max_new_tokens=N, cache_dtype=torch_dt)
    logits = eng._last_logits(model, x)
    assert _rel(logits, _jax_logits(jcfg, params, ref["x"])) <= (
        PREFILL_TOL[dtype])
    want = jax.device_get(ref["cache"])
    np.testing.assert_array_equal(cache["pos"].numpy(), want["pos"])
    assert cache["next"] == int(want["next"]) == prompt
    assert cache["ssm_S"].dtype == torch.float32
    if dtype == "float32":
        for name in ("k", "v", "ssm_S"):
            assert _rel(cache[name], want[name]) <= CACHE_TOL[name], name

    # decode from the reference's cache, one token at a time
    jc = ref["cache"]
    pc = cache_from_numpy(pcfg, want, device="cpu")
    step = eng.make_serve_step()
    for i in range(N):
        t = tok[:, prompt + i:prompt + i + 1]
        out = jax_forward(jcfg, params, jnp.asarray(t), cache=jc,
                          remat=False)
        jc = out["cache"]
        got, pc = step(model, pc, torch.from_numpy(t).long())
        assert _rel(got, _jax_logits(jcfg, params, out["x"])) <= (
            DECODE_TOL[dtype]), i
    assert pc["next"] == prompt + N
    assert _rel(pc["ssm_S"], jax.device_get(jc["ssm_S"])) <= (
        CACHE_TOL["ssm_S"] if dtype == "float32" else DECODE_TOL[dtype])


@pytest.mark.parametrize("heads", [None, (10, 2)])
def test_prefill_decode_consistency(heads):
    """The reference's ``test_prefill_decode_consistency`` in the port:
    decoding token T after a prefill of T tokens matches the full forward
    over T + 1 tokens (ring cache and SSM state end to end)."""
    jcfg, pcfg = _cfgs("bfloat16", heads)
    params = jax_init(jcfg, jax.random.PRNGKey(1))
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    tok = torch.arange(B * (T + 1)).reshape(B, T + 1) % pcfg.vocab_size
    with torch.no_grad():
        full = model(tok, remat=False)
    _, cache = model.prefill(tok[:, :T], max_new_tokens=1,
                             cache_dtype=torch.float32)
    got = model.decode(tok[:, T:], cache)[:, 0].float()
    want = full[:, T].float()
    err = float((want - got).abs().max() / (want.abs().max() + 1e-6))
    assert err < 0.08, err
    # the same check on the reference, for the record of its own error
    jfull = jax_forward(jcfg, params, jnp.asarray(tok.numpy()), remat=False)
    np.testing.assert_allclose(full.float().numpy(),
                               np.asarray(jfull["x"], np.float32),
                               atol=5e-2 * float(want.abs().max()))
