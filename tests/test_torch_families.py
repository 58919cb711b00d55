"""The port's other model families against the JAX package's, on the CPU:
the registry's ten architectures, and one reduced training step and the
serving path of each new one (grok-1-314b and arctic-480b: top-k experts,
arctic's beside a dense residual MLP; hymba-1.5b; internvl2-2b and
musicgen-medium: a prefix of frontend embeddings), from the reference's
own weights (``params_from_numpy``).

The loss is the reference's ``PHubEngine.build_loss_fn`` (its total: the
cross-entropy, labels with a -1 prefix as long as the frontend's, plus
``router_aux_weight`` times the experts' mean load-balance loss) and its
gradient ``jax.value_and_grad``'s.  The MoE configs run at a capacity
factor of 0.5, so every layer drops assignments (S * k of them into E * C
< S * k slots).  Tolerances, as ``tests/test_torch_model.py`` states them:
with f32 activations the two differ only in the order f32 products are
summed, so the loss within rtol 1e-5 and every gradient leaf within 1e-4
of its largest entry; with bf16 activations a residual entry near a bf16
rounding boundary can round the other way (2^-8 relative), so rtol 1e-3 on
the loss and 2e-2 of each leaf's largest entry.  The 4-layer hybrid's
gradients are far more sensitive to rounding: scaling the port's own
weights by 1 + 2^-23 (one f32 ulp) moves them by up to 8.4e-5 (f32) and
2.4e-2 (bf16) of a leaf's largest entry (llama's by 2.4e-6 and 4.0e-3),
and they differ from the reference's by up to 1.9e-4 and 3.0e-2 (measured),
so the hybrid's leaves are held within 5e-4 and 6e-2.  Serving: prefill logits
and 2 teacher-forced decode steps from the reference's cache within 1e-5
(f32) and 1e-2 (bf16) of the largest logit; prefill then decode against
the full forward within the reference's own bound (0.08).
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
from repro.models import forward as jax_forward
from repro.models import init as jax_init
from repro.models import lm_head_weight, prefill as jax_prefill
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import TrainConfig, get_arch
from repro_torch.configs import reduced as port_reduced
from repro_torch.convert import cache_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import PrefixedTokens, SyntheticTokens, batch_specs
from repro_torch.models import DecoderLM, param_specs

NEW = ["grok-1-314b", "arctic-480b", "hymba-1.5b", "internvl2-2b",
       "musicgen-medium"]
B, T, N, CHUNK = 2, 24, 2, 16
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-2)}
SERVE_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
HYBRID_GTOL = {"float32": 5e-4, "bfloat16": 6e-2}


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cfgs(arch, dtype="float32"):
    """The reduced config of both packages; MoE at capacity factor 0.5
    (drops in every layer), hymba at 4 layers with windows [0, 64, 64,
    0]."""
    out = []
    for cfg, red in ((ARCHS[arch], reduced), (get_arch(arch), port_reduced)):
        cfg = dataclasses.replace(red(cfg), dtype=dtype)
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=0.5)
        if cfg.family == "hybrid":
            cfg = dataclasses.replace(red(ARCHS[arch] if red is reduced
                                          else get_arch(arch), layers=4),
                                      dtype=dtype, global_layer_every=3)
        out.append(cfg)
    return out


def _extra(cfg, seed=5):
    if not cfg.frontend:
        return None
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)).astype(
        np.float32)


def _bf16_pair(a):
    """numpy f32 -> (jax bf16, torch bf16), the same bits."""
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)


def _rel(got, want) -> float:
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------ the registry

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_arch_resolves_as_the_reference(arch):
    got, want = get_arch(arch), ARCHS[arch]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_params() == want.n_params()
    assert got.n_active_params() == want.n_active_params()
    assert dataclasses.asdict(port_reduced(got)) == dataclasses.asdict(
        reduced(want))
    assert sorted(PORT_ARCHS) == sorted(ARCHS)


@pytest.mark.parametrize("arch", NEW)
def test_parameter_tree_matches_reference(arch):
    jcfg, pcfg = reduced(ARCHS[arch]), port_reduced(get_arch(arch))
    want = dict(leaf_paths(jax.eval_shape(
        lambda k: jax_init(jcfg, k), jax.random.PRNGKey(0))))
    got = dict(leaf_paths(param_specs(pcfg)))
    assert set(got) == set(want)
    for path, t in got.items():
        assert tuple(t.shape) == want[path].shape, path
        assert str(t.dtype).split(".")[-1] == want[path].dtype.name, path
    full = dict(leaf_paths(param_specs(get_arch(arch))))
    assert str(full["['embed']"].dtype).split(".")[-1] == \
        get_arch(arch).param_dtype


def test_batch_specs_match_the_reference():
    from repro.configs.base import InputShape
    from repro.data.synthetic import make_batch_specs
    for arch in sorted(ARCHS):
        cfg = get_arch(arch)
        for kind in ("train", "prefill", "decode"):
            want = make_batch_specs(ARCHS[arch],
                                    InputShape("s", 64, 8, kind))
            got = batch_specs(cfg, 8, 64, kind)
            assert set(got) == set(want), (arch, kind)
            for k, (shape, dt) in got.items():
                assert shape == want[k].shape, (arch, kind, k)
            if "extra_embeds" in got:
                assert got["extra_embeds"][1] == torch.bfloat16
    cfg = port_reduced(get_arch("internvl2-2b"))
    b = PrefixedTokens(cfg, 4, 8, seed=2).torch_batch(3, "cpu")
    again = PrefixedTokens(cfg, 4, 8, seed=2).torch_batch(3, "cpu")
    assert b["extra_embeds"].shape == (4, cfg.frontend_tokens, cfg.d_model)
    assert torch.equal(b["extra_embeds"], again["extra_embeds"])
    assert torch.equal(b["tokens"], SyntheticTokens(cfg, 4, 8, seed=2)
                       .torch_batch(3, "cpu")["tokens"])


# ------------------------------------------------------------ training

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", NEW)
def test_loss_and_grads_match_reference(arch, dtype):
    jcfg, pcfg = _cfgs(arch, dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    batch = JaxTokens(jcfg, B, T, seed=1).batch_at(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    extra = _extra(jcfg)
    pextra = None
    if extra is not None:
        jb["extra_embeds"], pextra = _bf16_pair(extra)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(loss_chunk=CHUNK),
                     mesh=mesh)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jb.items()}
    (ref_total, ref_loss), ref_grads = jax.jit(jax.value_and_grad(
        jeng.build_loss_fn(shapes), has_aux=True))(params, jb)

    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    eng = PHubEngine(pcfg, TrainConfig(loss_chunk=CHUNK), StackedComm(1),
                     device="cpu")
    tb = SyntheticTokens(pcfg, B, T, seed=1).torch_batch(0, "cpu")
    args = () if pextra is None else (pextra,)
    total, loss = eng.build_loss_fn()(model, tb["tokens"], tb["labels"],
                                      *args)
    paths, leaves = zip(*leaf_paths(model.param_tree()))
    grads = torch.autograd.grad(total, leaves)

    rtol, gtol = TOL[dtype]
    if pcfg.family == "hybrid":
        gtol = HYBRID_GTOL[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=rtol)
    np.testing.assert_allclose(float(total.detach()), float(ref_total),
                               rtol=rtol)
    if pcfg.n_experts:
        assert float(total.detach()) > float(loss.detach())   # aux
    ref = dict(leaf_paths(jax.device_get(ref_grads)))
    assert set(paths) == set(ref)
    for path, g in zip(paths, grads):
        r = np.asarray(ref[path], np.float32)
        err = np.abs(g.float().numpy() - r).max()
        assert err <= gtol * np.abs(r).max(), (path, err, np.abs(r).max())


@pytest.mark.parametrize("arch", NEW)
def test_engine_step_trains_each_family(arch):
    """A W=2 step through PHubEngine: finite losses, every leaf moves, and
    two runs from the same weights give the same bits (the experts'
    dispatch included)."""
    torch.use_deterministic_algorithms(True)
    try:
        _, pcfg = _cfgs(arch)
        eng = PHubEngine(pcfg, TrainConfig(loss_chunk=CHUNK), StackedComm(2),
                         device="cpu")
        data = (PrefixedTokens if pcfg.frontend else SyntheticTokens)(
            pcfg, 4, 16, seed=0)
        runs = []
        for _ in range(2):
            model, opt = eng.init_state(seed=3)
            before = [t.detach().clone() for _, t in
                      leaf_paths(model.param_tree())]
            step = eng.make_train_step()
            losses = []
            for i in range(2):
                model, opt, m = step(model, opt, data.torch_batch(i, "cpu"))
                losses.append(float(m["loss"]))
            after = [t.detach().clone() for _, t in
                     leaf_paths(model.param_tree())]
            runs.append((losses, after))
        (l0, a0), (l1, a1) = runs
        assert all(np.isfinite(l0)) and l0 == l1
        assert all(torch.equal(x, y) for x, y in zip(a0, a1))
        moved = [not torch.equal(x, y) for x, y in zip(before, a0)]
        assert all(moved), [p for (p, _), m in zip(
            leaf_paths(model.param_tree()), moved) if not m]
    finally:
        torch.use_deterministic_algorithms(False)


# ------------------------------------------------------------- serving

def _jax_logits(cfg, params, x):
    return np.asarray(x[:, -1].astype(jnp.float32)
                      @ lm_head_weight(cfg, params).astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b",
                                  "internvl2-2b", "musicgen-medium"])
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill (after the frontend's prefix) and 2 teacher-forced decode
    steps from the reference's own cache.  At decode S = B = 2 tokens, so
    the experts' capacity is 1 and assignments drop, as in the reference."""
    jcfg, pcfg = _cfgs(arch, dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    tok = JaxTokens(jcfg, B, T + N, seed=3).batch_at(0)["tokens"]
    extra = _extra(jcfg)
    jx = px = None
    if extra is not None:
        jx, px = _bf16_pair(extra)
    cache_dt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref = jax_prefill(jcfg, params, jnp.asarray(tok[:, :T]), extra_embeds=jx,
                      cache_dtype=cache_dt, max_new_tokens=N)
    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    eng = PHubEngine(pcfg, TrainConfig(), StackedComm(1), device="cpu")
    x, cache = model.prefill(torch.from_numpy(tok[:, :T]).long(),
                             extra_embeds=px, max_new_tokens=N,
                             cache_dtype=getattr(torch, dtype))
    F = pcfg.frontend_tokens if pcfg.frontend else 0
    assert x.shape[1] == T + F and cache["next"] == T + F
    assert _rel(eng._last_logits(model, x),
                _jax_logits(jcfg, params, ref["x"])) <= SERVE_TOL[dtype]
    want = jax.device_get(ref["cache"])
    np.testing.assert_array_equal(cache["pos"].numpy(), want["pos"])
    jc, pc = ref["cache"], cache_from_numpy(pcfg, want, device="cpu")
    step = eng.make_serve_step()
    for i in range(N):
        t = tok[:, T + i:T + i + 1]
        out = jax_forward(jcfg, params, jnp.asarray(t), cache=jc,
                          remat=False)
        jc = out["cache"]
        got, pc = step(model, pc, torch.from_numpy(t).long())
        assert _rel(got, _jax_logits(jcfg, params, out["x"])) <= (
            SERVE_TOL[dtype]), i


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b",
                                  "internvl2-2b", "musicgen-medium"])
def test_prefill_decode_consistency(arch):
    """The reference's ``test_prefill_decode_consistency`` in the port (it
    lists musicgen-medium; the other three take the same check): the token
    after a prefill matches the full forward over one more token, within
    the reference's bound.  The prefill and the forward take the same
    frontend prefix.  The experts' capacity depends on the tokens a call
    routes (B at decode, B * (T + 1) in the forward), so the MoE configs
    take a capacity factor of E / k here: every expert can hold every
    token and nothing drops in either call."""
    _, pcfg = _cfgs(arch, "bfloat16")
    if pcfg.n_experts:
        pcfg = dataclasses.replace(
            pcfg, capacity_factor=pcfg.n_experts / pcfg.top_k)
    torch.manual_seed(1)
    model = DecoderLM(pcfg, device="cpu",
                      generator=torch.Generator().manual_seed(1))
    tok = torch.arange(B * (T + 1)).reshape(B, T + 1) % pcfg.vocab_size
    extra = None if _extra(pcfg) is None else \
        torch.from_numpy(_extra(pcfg)).to(torch.bfloat16)
    with torch.no_grad():
        full = model(tok, extra_embeds=extra, remat=False)
    _, cache = model.prefill(tok[:, :T], extra_embeds=extra,
                             max_new_tokens=1, cache_dtype=torch.float32)
    got = model.decode(tok[:, T:], cache)[:, 0].float()
    want = full[:, -1].float()
    err = float((want - got).abs().max() / (want.abs().max() + 1e-6))
    assert err < 0.08, err


# ------------------------------------------------------------ launchers

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_launchers_run_every_arch_on_cpu(arch):
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main
    losses = train_main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--steps", "1", "--batch", "2", "--seq", "16",
                         "--workers", "2"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    gen = serve_main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8",
                      "--decode-steps", "3"])
    assert gen.shape == (2, 3)
