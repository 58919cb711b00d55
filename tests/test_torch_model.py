"""The port's dense model, loss and data against the JAX package's, on
reduced llama3.2-1b (d_model=128, 2 layers) with the reference's own
weights carried over by ``params_from_numpy``.

Tolerances: with float32 activations the two differ only in the order
f32 products and sums are taken (XLA:CPU vs PyTorch's CPU kernels), so the
loss agrees to rtol 1e-5 and every gradient leaf to 1e-4 of its largest
entry.  With the default bf16 activations a residual value that lands near
a bf16 rounding boundary can round to the neighbouring bf16 in one
framework and not the other (a 2^-8 relative step), so the bound is rtol
1e-3 on the loss and 2e-2 of each leaf's largest entry on the gradients.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, reduced
from repro.data import SyntheticTokens as JaxTokens
from repro.models import (blockwise_attention as jax_attention,
                          chunked_cross_entropy as jax_ce, forward,
                          init as jax_init, lm_head_weight)
from repro_torch.configs import get_arch, reduced as port_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.models import blockwise_attention, chunked_cross_entropy

B, T, CHUNK = 2, 40, 16          # 3 loss chunks, the last one padded

TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-3, 2e-2)}


def _cfgs(dtype):
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype=dtype)
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype=dtype)
    return jcfg, pcfg


def test_synthetic_batches_bitwise():
    jcfg, pcfg = _cfgs("bfloat16")
    for step in (0, 1, 7):
        a = JaxTokens(jcfg, 4, 64, seed=3).batch_at(step)
        b = SyntheticTokens(pcfg, 4, 64, seed=3).batch_at(step)
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        t = SyntheticTokens(pcfg, 4, 64, seed=3).torch_batch(step, "cpu")
        np.testing.assert_array_equal(t["tokens"].numpy(), a["tokens"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(dtype):
    jcfg, pcfg = _cfgs(dtype)
    params = jax_init(jcfg, jax.random.PRNGKey(0))
    batch = JaxTokens(jcfg, B, T, seed=1).batch_at(0)

    def jloss(p):
        x = forward(jcfg, p, jnp.asarray(batch["tokens"]), remat=False)["x"]
        return jax_ce(x, lm_head_weight(jcfg, p), jnp.asarray(batch["labels"]),
                      chunk=CHUNK)
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(jloss))(params)

    model = params_from_numpy(pcfg, jax.device_get(params), device="cpu")
    tb = SyntheticTokens(pcfg, B, T, seed=1).torch_batch(0, "cpu")
    loss = chunked_cross_entropy(model(tb["tokens"], remat=True),
                                 model.lm_head_weight(), tb["labels"],
                                 chunk=CHUNK)
    paths, leaves = zip(*leaf_paths(model.param_tree()))
    grads = torch.autograd.grad(loss, leaves)

    rtol, gtol = TOL[dtype]
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=rtol)
    ref = dict(leaf_paths(jax.device_get(ref_grads)))
    assert set(paths) == set(ref)
    for path, g in zip(paths, grads):
        r = np.asarray(ref[path])
        err = np.abs(g.numpy() - r).max()
        assert err <= gtol * np.abs(r).max(), (path, err, np.abs(r).max())


@pytest.mark.parametrize("window", [0, 24])
def test_blockwise_attention_matches_reference(window):
    """Several KV blocks, a padded last block, empty (-1) slots, GQA."""
    rng = np.random.default_rng(window)
    Bq, Tq, nh, kv, hd = 2, 40, 4, 2, 16
    q = rng.standard_normal((Bq, Tq, nh, hd)).astype(np.float32)
    k = rng.standard_normal((Bq, Tq, kv, hd)).astype(np.float32)
    v = rng.standard_normal((Bq, Tq, kv, hd)).astype(np.float32)
    k_pos = np.tile(np.arange(Tq, dtype=np.int32), (Bq, 1))
    k_pos[1, :5] = -1
    ref = jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        q_pos=jnp.arange(Tq, dtype=jnp.int32),
                        k_pos=jnp.asarray(k_pos), window=window, block_kv=16)
    got = blockwise_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_pos=torch.arange(Tq),
                              k_pos=torch.from_numpy(k_pos).long(),
                              window=window, block_kv=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_unported_families_raise():
    """The families this once found unported (hymba's config, a model
    with experts) now resolve and build: neither call raises."""
    from repro_torch.models import DecoderLM
    assert dataclasses.asdict(get_arch("hymba-1.5b")) == dataclasses.asdict(
        ARCHS["hymba-1.5b"])
    moe = dataclasses.replace(port_reduced(get_arch("llama3.2-1b")),
                              family="moe", n_experts=4, top_k=2)
    model = DecoderLM(moe, device="cpu")
    assert tuple(model.blocks["moe_w1"].shape) == (2, 4, 256, 768)
    x, aux = model(torch.zeros((1, 8), dtype=torch.long), with_aux=True)
    assert x.shape == (1, 8, 256) and float(aux.detach()) > 0


@pytest.mark.parametrize("arch", ["granite-3-8b", "minitron-8b", "rwkv6-3b"])
def test_registered_configs_equal_reference(arch):
    assert dataclasses.asdict(get_arch(arch)) == dataclasses.asdict(
        ARCHS[arch])
    assert get_arch(arch).n_params() == ARCHS[arch].n_params()


def test_attn_free_and_sub_quadratic_agree_with_reference():
    from repro.models.model import cache_capacity as jax_capacity
    from repro_torch.configs import ARCHS as PORT_ARCHS
    from repro_torch.models import cache_capacity
    for arch, cfg in PORT_ARCHS.items():
        for pcfg, jcfg in ((cfg, ARCHS[arch]),
                           (port_reduced(cfg), reduced(ARCHS[arch]))):
            assert pcfg.attn_free == jcfg.attn_free, arch
            assert pcfg.sub_quadratic == jcfg.sub_quadratic, arch
            assert cache_capacity(pcfg, 2080) == jax_capacity(jcfg, 2080)
    assert get_arch("rwkv6-3b").attn_free
    assert cache_capacity(get_arch("rwkv6-3b"), 2080) == 0


def test_rwkv_tree_counts_six_square_matrices_a_layer():
    """The tree (3,073,313,280 f32 parameters, 12.29 GB) holds six d x d
    matrices a layer; ``n_params`` counts four, as the reference's does."""
    from repro_torch.models import param_specs
    cfg = get_arch("rwkv6-3b")
    n = sum(t.numel() for _, t in leaf_paths(param_specs(cfg)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(
        jax.eval_shape(lambda: jax_init(ARCHS["rwkv6-3b"],
                                        jax.random.PRNGKey(0)))))
    assert n == want == 3_073_313_280
    assert cfg.n_params() == ARCHS["rwkv6-3b"].n_params() == 2_653_063_680


def test_training_an_attn_free_config_raises():
    """The ssm family trains through autograd of its chunked scan (one
    W=2 step, finite loss, every leaf moved); what still raises is the
    scan kernel under autograd: it has no backward (nor has the
    reference's), so training never goes through it."""
    from repro_torch.configs import TrainConfig
    from repro_torch.core import PHubEngine, StackedComm
    from repro_torch.kernels.rwkv_scan import ops as scan_ops
    cfg = port_reduced(get_arch("rwkv6-3b"))
    eng = PHubEngine(cfg, TrainConfig(loss_chunk=16), StackedComm(2),
                     device="cpu")
    model, opt = eng.init_state(seed=0)
    before = [t.detach().clone() for _, t in leaf_paths(model.param_tree())]
    batch = SyntheticTokens(cfg, 2, 64, seed=1).torch_batch(0, "cpu")
    model, opt, m = eng.make_train_step()(model, opt, batch)
    assert np.isfinite(float(m["loss"]))
    after = [t for _, t in leaf_paths(model.param_tree())]
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
    r = torch.randn(1, 64, 1, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="no backward"):
        scan_ops.rwkv_scan(r, r, r, torch.sigmoid(r), torch.zeros(1, 64),
                           torch.zeros(1, 1, 64, 64))
