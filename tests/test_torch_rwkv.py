"""The port's RWKV6 blocks (``repro_torch/models/rwkv.py``) and its ssm
model (prefill, decode, the state cache) against the JAX package's, on the
CPU, at the reduced rwkv6-3b (2 layers, d_model 256, 4 heads of 64, d_ff
768, decay LoRA 16) with the reference's own weights carried over by
``params_from_numpy`` and, for decode, the reference's own prefill cache
by ``cache_from_numpy``.  On the CPU the prefill's scan takes the kernel's
plain version.

Tolerances, measured and then stated (max |got - want| over max |want|):
- f32 activations: the two differ only in the order f32 sums are taken,
  so blocks, hidden states, logits and every cache entry within 1e-5
  (measured at most 1.9e-6).
- bf16 activations (the default): a residual, a token shift's difference
  or a normed input near a bf16 rounding boundary can round to the
  neighbouring bf16 in one framework and not the other (2^-8 relative;
  XLA also keeps some fused bf16 intermediates in f32), so logits and
  cache entries within 2e-2 (measured at most 7.6e-3 for logits, 8.7e-3
  for the cache).
- Cache dtypes exactly: S and x_prev_ffn f32, x_prev_att in the
  activation dtype, as the reference's cache holds them after its prefill.
- ``token_shift`` bitwise (elementwise, one rounding each).
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
from repro.models import lm_head_weight, prefill as jax_prefill
from repro.models import rwkv as jrwkv
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.kernels import rwkv_scan
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import rwkv

ARCH = "rwkv6-3b"
B, N = 2, 4                       # batch, decode steps
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CACHE = ("S", "x_prev_att", "x_prev_ffn")


def _cfgs(dtype):
    return (dataclasses.replace(reduced(ARCHS[ARCH]), dtype=dtype),
            dataclasses.replace(port_reduced(get_arch(ARCH)), dtype=dtype))


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_logits(cfg, params, x):
    return np.asarray(x[:, -1].astype(jnp.float32)
                      @ lm_head_weight(cfg, params).astype(jnp.float32))


def _setup(dtype):
    jcfg, pcfg = _cfgs(dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    engine = PHubEngine(pcfg, TrainConfig(), StackedComm(1), device="cpu")
    return jcfg, pcfg, params, model, engine


def _layer0(dtype="float32"):
    """(reference layer-0 params, port layer-0 params, configs)."""
    jcfg, pcfg = _cfgs(dtype)
    params = jax.device_get(jax_init(jcfg, jax.random.PRNGKey(1)))
    jp = {k: jnp.asarray(v[0]) for k, v in params["blocks"].items()}
    pp = {k: torch.from_numpy(np.array(v[0]))
          for k, v in params["blocks"].items()}
    return jp, pp, jcfg, pcfg


def _x(T, d, dtype, seed):
    x = np.random.default_rng(seed).standard_normal((B, T, d)) \
        .astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(
        getattr(torch, dtype))


# ----------------------------------------------------------------- blocks

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["no_carry", "carry_prompt", "carry_one"])
def test_token_shift_bitwise(dtype, case):
    T = 1 if case == "carry_one" else 9
    jx, px = _x(T, 16, dtype, seed=1)
    mu = np.random.default_rng(2).random(16).astype(np.float32)
    jprev = pprev = None
    if case != "no_carry":
        jprev, pprev = _x(1, 16, dtype, seed=3)
    want = jrwkv.token_shift(jx, jnp.asarray(mu), jprev)
    got = rwkv.token_shift(px, torch.from_numpy(mu), pprev)
    assert str(got.dtype).split(".")[-1] == want.dtype.name
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("T,use_kernel", [(64, False), (40, False),
                                          (128, True), (40, True)])
def test_time_mix_matches_reference(T, use_kernel):
    """T 64: both take the chunked form; T 40: both the recurrence; with
    ``use_kernel`` the port's scan goes through ``rwkv_scan`` (its plain
    version on the CPU) against the reference's own choice; all from a
    nonzero state and with a carried x_prev."""
    jp, pp, jcfg, pcfg = _layer0()
    jx, px = _x(T, pcfg.d_model, "float32", seed=4)
    jprev, pprev = _x(1, pcfg.d_model, "float32", seed=5)
    S = np.random.default_rng(6).standard_normal(
        (B, pcfg.n_heads, pcfg.hd, pcfg.hd)).astype(np.float32) * 0.3
    want, wS = jrwkv.time_mix(jp, jx, jcfg, jnp.asarray(S), x_prev=jprev)
    rwkv_scan.reset_launches()
    got, gS = rwkv.time_mix(pp, px, pcfg, torch.from_numpy(S),
                            x_prev=pprev, use_kernel=use_kernel)
    assert rwkv_scan.LAUNCHES["rwkv_scan_kernel"] == 0     # CPU: plain
    assert gS.dtype == torch.float32 and wS.dtype == jnp.float32
    assert _rel(got, want) <= TOL["float32"]
    assert _rel(gS, wS) <= TOL["float32"]


@pytest.mark.parametrize("carry", [False, True])
def test_channel_mix_matches_reference(carry):
    jp, pp, jcfg, pcfg = _layer0()
    jx, px = _x(24, pcfg.d_model, "float32", seed=7)
    jprev = pprev = None
    if carry:
        jprev, pprev = _x(1, pcfg.d_model, "float32", seed=8)
    want = jrwkv.channel_mix(jp, jx, jprev)
    got = rwkv.channel_mix(pp, px, pprev)
    assert _rel(got, want) <= TOL["float32"]


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [40, 64])
def test_forward_matches_reference(dtype, T):
    """The training forward from the zero state (T 40: the recurrence, T
    64: the chunked form, in both packages), compared through the logits
    of every position."""
    jcfg, pcfg, params, model, _ = _setup(dtype)
    tok = JaxTokens(jcfg, B, T, seed=3).batch_at(0)["tokens"]
    x = jax_forward(jcfg, params, jnp.asarray(tok), remat=False)["x"]
    want = np.asarray(x.astype(jnp.float32)
                      @ lm_head_weight(jcfg, params).astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(tok).long(), remat=False).float() \
            @ model.lm_head_weight().float()
    assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [40, 128])
def test_prefill_and_decode_match_reference(dtype, T):
    """Prefill (T 40: one ragged chunk; T 128: two full chunks) and four
    teacher-forced decode steps from the reference's prefill cache carried
    over bit for bit: logits, and every cache entry's values and dtypes
    at every step; the port updates its cache in place."""
    jcfg, pcfg, params, model, engine = _setup(dtype)
    tok = JaxTokens(jcfg, B, T + N, seed=3).batch_at(0)["tokens"]
    out = jax_prefill(jcfg, params, jnp.asarray(tok[:, :T]), remat=False,
                      max_new_tokens=N)
    jcache = out["cache"]
    rwkv_scan.reset_launches()
    logits, cache = engine.make_prefill_step(T, N)(
        model, torch.from_numpy(tok[:, :T]).long())
    assert rwkv_scan.LAUNCHES["rwkv_scan_kernel"] == 0      # CPU: plain
    assert logits.shape == (B, pcfg.vocab_size)
    assert _rel(logits, _jax_logits(jcfg, params, out["x"])) <= TOL[dtype]
    assert cache["next"] == T == int(jcache["next"])

    def check_cache(cache, jcache, what):
        want = jax.device_get(jcache)
        for name in CACHE:
            assert str(cache[name].dtype).split(".")[-1] == \
                want[name].dtype.name, (what, name)
            assert tuple(cache[name].shape) == want[name].shape
            assert _rel(cache[name], want[name]) <= TOL[dtype], (what, name)

    check_cache(cache, jcache, "prefill")
    assert cache["S"].dtype == torch.float32
    assert cache["x_prev_att"].dtype == getattr(torch, dtype)
    assert cache["x_prev_ffn"].dtype == torch.float32

    cache = cache_from_numpy(pcfg, jax.device_get(jcache), device="cpu")
    s_buf = cache["S"].data_ptr()
    step = engine.make_serve_step()
    for i in range(N):
        t = tok[:, T + i:T + i + 1]
        o = jax_forward(jcfg, params, jnp.asarray(t), cache=jcache,
                        remat=False)
        jcache = o["cache"]
        logits, cache2 = step(model, cache, torch.from_numpy(t).long())
        assert cache2 is cache and cache["S"].data_ptr() == s_buf
        assert cache["next"] == T + i + 1 == int(jcache["next"])
        assert _rel(logits, _jax_logits(jcfg, params, o["x"])) \
            <= TOL[dtype], i
        check_cache(cache, jcache, f"decode {i}")


def test_cache_from_numpy_takes_the_state_cache():
    jcfg, pcfg = _cfgs("bfloat16")
    from repro.models.model import init_cache as jax_init_cache
    want = jax.device_get(jax_init_cache(jcfg, 2, 16))
    got = cache_from_numpy(pcfg, want, device="cpu")
    assert got["next"] == 0 and set(got) == {*CACHE, "next"}
    for name in CACHE:          # the reference's init_cache: all bf16
        assert got[name].dtype == torch.bfloat16
    bad = dict(want, S=np.asarray(want["S"])[:, :, :1])
    with pytest.raises(ValueError, match="S"):
        cache_from_numpy(pcfg, bad, device="cpu")


def test_serve_launcher_runs_the_ssm_family():
    args = ["--arch", ARCH, "--reduced", "--batch", "2", "--prompt-len",
            "40", "--decode-steps", "3", "--device", "cpu"]
    gen = serve_main(args)
    assert gen.shape == (2, 3) and gen.dtype == np.int32
    np.testing.assert_array_equal(gen, serve_main(args))
