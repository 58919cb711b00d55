"""The port's serving path (ring KV cache, prefill, decode, the engine's
serving steps and the launcher) against the JAX package's, on the CPU.

The reduced llama3.2-1b (2 layers, d_model 256, full causal attention,
prompt 24 < C = 28) and the reduced h2o-danube-3-4b (window 64, prompt 96
>= C = 64, so the prefill takes the ring's tail-and-roll branch and the
decode steps evict the oldest slots) run from the reference's own weights
(``params_from_numpy``) and, for decode, from the reference's own cache
(``cache_from_numpy``).  On the CPU the port's attention takes the
kernels' plain versions.

Tolerances, measured and then stated (max |got - want| over max |want|):
- f32 activations: the two differ only in the order f32 products are
  summed.  Prefill logits within 1e-5 (measured 1.3e-6).  The cache holds
  bf16, so each k/v entry is within one bf16 ulp of the reference's plus
  1e-6 of the layer's largest entry (the projection's f32 rounding can
  move a value across a bf16 rounding boundary, and a value near zero is
  the difference of larger terms; measured at most 1.8e-7 past one ulp).
- bf16 activations (the default): a residual entry near a bf16 rounding
  boundary can round to the neighbouring bf16 in one framework and not
  the other (2^-8 relative), so prefill logits are held within 5e-3
  (measured 8.9e-4); the first layer's k/v, computed from the same
  embeddings, within one bf16 ulp (measured 0), deeper layers within one
  ulp plus 1e-3 of the layer's largest entry (measured 2.6e-4).
- Decode, 4 steps teacher-forced with the same tokens from the same
  cache: the new token's k/v are rounded into the bf16 cache, where an
  f32 last-place difference can flip one entry by 2^-8, so logits within
  1e-3 (measured 1.1e-4) at every step.
- Cache ``pos`` exactly.
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
from repro.models.model import (cache_capacity as jax_capacity,
                                init_cache as jax_init_cache,
                                layer_windows as jax_windows)
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.kernels import decode_attn, swa_attn
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import cache_capacity, init_cache, layer_windows

ARCH_IDS = ["llama3.2-1b", "h2o-danube-3-4b"]
PROMPT = {"llama3.2-1b": 24, "h2o-danube-3-4b": 96}
B, N = 2, 4                      # batch, decode steps
LOGIT_TOL = {"float32": 1e-5, "bfloat16": 5e-3}
DECODE_TOL = 1e-3


def _cfgs(arch, dtype):
    return (dataclasses.replace(reduced(ARCHS[arch]), dtype=dtype),
            dataclasses.replace(port_reduced(get_arch(arch)), dtype=dtype))


def _jax_logits(cfg, params, x):
    return np.asarray(x[:, -1].astype(jnp.float32)
                      @ lm_head_weight(cfg, params).astype(jnp.float32))


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / np.abs(np.asarray(want)).max())


def _beyond_one_ulp(got, want) -> float:
    """Largest |got - want| past one bf16 ulp of the larger magnitude,
    over the largest |want|."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    m = np.maximum(np.abs(got), np.abs(want))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(m, 1e-38))) - 7)
    return float(((np.abs(got - want) - ulp) / np.abs(want).max()).max())


def _setup(arch, dtype):
    jcfg, pcfg = _cfgs(arch, dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    T = PROMPT[arch]
    tok = JaxTokens(jcfg, B, T + N, seed=3).batch_at(0)["tokens"]
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    engine = PHubEngine(pcfg, TrainConfig(), StackedComm(1), device="cpu")
    return jcfg, pcfg, params, tok, model, engine


# ------------------------------------------------------------------ helpers

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_cache_helpers_match_reference(arch, size):
    jcfg, pcfg = ARCHS[arch], get_arch(arch)
    if size == "reduced":
        jcfg, pcfg = reduced(jcfg), port_reduced(pcfg)
    np.testing.assert_array_equal(layer_windows(pcfg), jax_windows(jcfg))
    assert layer_windows(pcfg).dtype == np.int32
    for seq in (1, 17, 64, 96, 2080, 4624, 524_288):
        assert cache_capacity(pcfg, seq) == jax_capacity(jcfg, seq), seq
    want = jax.device_get(jax_init_cache(jcfg, 2, 40))
    got = init_cache(pcfg, 2, 40, device="cpu")
    assert got["next"] == 0 and isinstance(got["next"], int)
    assert int(want["next"]) == 0
    for name in ("k", "v", "pos"):
        assert tuple(got[name].shape) == want[name].shape, name
        assert str(got[name].dtype).split(".")[-1] == want[name].dtype.name
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name], np.float32))


def test_danube_window_caps_the_cache():
    assert cache_capacity(get_arch("h2o-danube-3-4b"), 524_288) == 4096
    assert cache_capacity(get_arch("llama3.2-1b"), 32_768) == 32_768
    assert cache_capacity(get_arch("h2o-danube-3-4b"), 4608 + 16) == 4096
    assert cache_capacity(get_arch("llama3.2-1b"), 2048 + 32) == 2080


def test_danube_builds_an_untied_lm_head():
    from repro_torch.models import param_specs
    cfg = get_arch("h2o-danube-3-4b")
    specs = param_specs(cfg)
    assert tuple(specs["lm_head"].shape) == (cfg.d_model, cfg.vocab_size)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(
        {k: v for k, v in specs.items() if k != "blocks"})) + sum(
        t.numel() for t in specs["blocks"].values())
    assert n == cfg.n_params() == ARCHS["h2o-danube-3-4b"].n_params()


# ------------------------------------------------------- prefill and decode

@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(arch, dtype):
    jcfg, pcfg, params, tok, model, engine = _setup(arch, dtype)
    T = PROMPT[arch]
    out = jax_prefill(jcfg, params, jnp.asarray(tok[:, :T]), remat=False,
                      max_new_tokens=N)
    want_logits = _jax_logits(jcfg, params, out["x"])
    want = jax.device_get(out["cache"])
    swa_attn.reset_launches()
    logits, cache = engine.make_prefill_step(T, N)(
        model, torch.from_numpy(tok[:, :T]).long())
    assert swa_attn.LAUNCHES["swa_attention_kernel"] == 0   # CPU: plain
    assert logits.shape == (B, pcfg.vocab_size)
    assert logits.dtype == torch.float32
    assert _rel(logits.numpy(), want_logits) <= LOGIT_TOL[dtype]
    assert cache["next"] == T == int(want["next"])
    C = cache["k"].shape[2]
    assert C == cache_capacity(pcfg, T + N) and (T >= C) == (
        arch == "h2o-danube-3-4b")
    np.testing.assert_array_equal(cache["pos"].numpy(), want["pos"])
    assert cache["k"].dtype == torch.bfloat16
    for name in ("k", "v"):
        got = cache[name].float().numpy()
        for layer in range(pcfg.n_layers):
            slack = 1e-6 if dtype == "float32" else (
                0.0 if layer == 0 else 1e-3)
            assert _beyond_one_ulp(got[layer], want[name][layer]) <= slack, (
                name, layer)


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference_from_its_cache(arch, dtype):
    """Four decode steps, teacher-forced with the same tokens, from the
    reference's prefill cache carried over bit for bit; the port updates
    its cache in place and its pos equals the reference's every step."""
    jcfg, pcfg, params, tok, model, engine = _setup(arch, dtype)
    T = PROMPT[arch]
    jcache = jax_prefill(jcfg, params, jnp.asarray(tok[:, :T]), remat=False,
                         max_new_tokens=N)["cache"]
    cache = cache_from_numpy(pcfg, jax.device_get(jcache), device="cpu")
    assert cache["next"] == T
    k_buf = cache["k"].data_ptr()
    step = engine.make_serve_step()
    decode_attn.reset_launches()
    for i in range(N):
        t = tok[:, T + i:T + i + 1]
        out = jax_forward(jcfg, params, jnp.asarray(t), cache=jcache,
                          remat=False)
        jcache = out["cache"]
        logits, cache2 = step(model, cache, torch.from_numpy(t).long())
        assert cache2 is cache and cache["k"].data_ptr() == k_buf
        assert cache["next"] == T + i + 1 == int(jcache["next"])
        assert _rel(logits.numpy(), _jax_logits(jcfg, params, out["x"])) \
            <= DECODE_TOL, i
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
    assert decode_attn.LAUNCHES["decode_attention_kernel"] == 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode_consistency(arch):
    """Decoding token T after a prefill of length T matches the port's own
    full forward over T+1 tokens (the reference's
    test_prefill_decode_consistency), at f32 activations and an f32 cache
    so only summation order separates the two: within 1e-5 of the
    largest entry (measured below 1e-6)."""
    _, pcfg = _cfgs(arch, "float32")
    engine = PHubEngine(pcfg, TrainConfig(), StackedComm(1), device="cpu")
    model = engine.init_model(seed=1)
    T = PROMPT[arch]
    tok = (torch.arange(B * (T + 1)).reshape(B, T + 1) % pcfg.vocab_size)
    with torch.no_grad():
        full = model(tok, remat=False)[:, T]
    _, cache = model.prefill(tok[:, :T], max_new_tokens=1,
                             cache_dtype=torch.float32)
    got = model.decode(tok[:, T:], cache)[:, 0]
    assert _rel(got.numpy(), full.numpy()) <= 1e-5


def test_decode_rejects_more_than_one_token():
    _, pcfg = _cfgs("llama3.2-1b", "bfloat16")
    model = PHubEngine(pcfg, TrainConfig(), StackedComm(1),
                       device="cpu").init_model()
    _, cache = model.prefill(torch.zeros(1, 8, dtype=torch.long))
    with pytest.raises(ValueError, match="one token"):
        model.decode(torch.zeros(1, 2, dtype=torch.long), cache)


def test_cache_from_numpy_checks_shapes():
    _, pcfg = _cfgs("llama3.2-1b", "bfloat16")
    want = jax.device_get(jax_init_cache(reduced(ARCHS["llama3.2-1b"]),
                                         2, 16))
    got = cache_from_numpy(pcfg, want, device="cpu")
    assert got["k"].dtype == torch.bfloat16 and got["next"] == 0
    bad = dict(want, pos=np.asarray(want["pos"])[:, :, :3])
    with pytest.raises(ValueError, match="pos"):
        cache_from_numpy(pcfg, bad, device="cpu")


# ---------------------------------------------------------------- launcher

ARGS = ["--arch", "llama3.2-1b", "--reduced", "--batch", "2",
        "--prompt-len", "16", "--decode-steps", "4", "--device", "cpu"]


def test_serve_greedy_smoke():
    gen = serve_main(ARGS)
    assert gen.shape == (2, 4)
    assert gen.dtype == np.int32
    np.testing.assert_array_equal(gen, serve_main(ARGS))


def test_serve_no_greedy_flag_actually_disables_greedy():
    g_greedy = serve_main(ARGS)
    g_hot = serve_main(ARGS + ["--no-greedy", "--temperature", "5.0",
                               "--seed", "3"])
    assert g_hot.shape == g_greedy.shape
    assert not np.array_equal(g_hot, g_greedy)


def test_serve_sampling_seeded():
    args = ARGS + ["--no-greedy", "--temperature", "2.0", "--seed", "11"]
    np.testing.assert_array_equal(serve_main(args), serve_main(args))


def test_serve_windowed_arch_and_same_prompts_as_reference(capsys):
    """The danube launcher runs on the CPU past its window (prompt 80 >
    window 64); both launchers read the same prompts."""
    gen = serve_main(["--arch", "h2o-danube-3-4b", "--reduced", "--batch",
                      "2", "--prompt-len", "80", "--decode-steps", "3",
                      "--device", "cpu"])
    assert gen.shape == (2, 3) and gen.dtype == np.int32
    assert "on the CPU" in capsys.readouterr().out
    from repro_torch.data import SyntheticTokens
    cfg = port_reduced(get_arch("llama3.2-1b"))
    np.testing.assert_array_equal(
        SyntheticTokens(cfg, 2, 16, seed=7).batch_at(0)["tokens"],
        JaxTokens(reduced(ARCHS["llama3.2-1b"]), 2, 16,
                  seed=7).batch_at(0)["tokens"])
