"""The port's top-k Mixture-of-Experts (``models/moe.py``) against the JAX
package's (``repro/models/moe.py``), on the CPU.

Routing is held exactly: the tokens and the router are integer-valued, so
every router logit is an integer (exact in f32 in both frameworks), two
experts' probabilities either tie exactly (the same logit) or differ by a
factor of e or more, and the argmax sweep picks the same experts in the
same order, ties to the lowest index.  Then ``idx``, the position in the
expert (``pos``) and ``keep`` are equal, and a capacity factor below 1
makes drops happen.  The gates are ratios of the two softmaxes' values,
within 1e-6 relative (each framework's exp may differ in the last place).

The outputs and the load-balance loss, with the expert weights drawn
from N(0, 1/fan_in): f32 activations within rtol 1e-5 of the largest
entry (products summed in another order); bf16 activations and
parameters within 1e-2 of the largest entry (an output entry near a bf16
rounding boundary rounds to the neighbouring bf16 in one framework and
not the other, 2^-8 relative); the aux loss within rtol 1e-6.  The
gradients of y's weighted sum (f32) within 1e-4 of each one's largest
entry.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models.moe import _top_k as jax_top_k
from repro.models.moe import load_balance_loss as jax_aux
from repro.models.moe import moe_mlp as jax_moe
from repro_torch.models import moe

S, D, FF = 48, 32, 40


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _inputs(E: int, seed: int, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (S, D)).astype(np.float32)
    router = rng.integers(-2, 3, (D, E)).astype(np.float32)
    w1 = rng.standard_normal((E, D, FF)).astype(np.float32) / np.sqrt(D)
    w3 = rng.standard_normal((E, D, FF)).astype(np.float32) / np.sqrt(D)
    w2 = rng.standard_normal((E, FF, D)).astype(np.float32) / np.sqrt(FF)
    return [a.astype(dtype) for a in (x, router, w1, w3, w2)]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _jax_routing(x, router, k, cf):
    """The reference's routing, step for step as its ``moe_mlp`` takes
    it."""
    S_, E = x.shape[0], router.shape[-1]
    C = max(1, int(cf * S_ * k / E))
    probs = jax.nn.softmax(jnp.asarray(x, jnp.float32)
                           @ jnp.asarray(router, jnp.float32), axis=-1)
    gate, idx = jax_top_k(probs, k)
    gate = gate / jnp.maximum(gate.sum(-1, keepdims=True), 1e-9)
    one_hot = jax.nn.one_hot(idx.reshape(-1), E, dtype=jnp.int32)
    pos = (jnp.cumsum(one_hot, axis=0) * one_hot).sum(-1) - 1
    return {"probs": probs, "gate": gate, "idx": idx, "C": C, "pos": pos,
            "keep": pos < C, "aux": jax_aux(probs, idx, E)}


@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (4, 2, 0.5), (8, 2, 0.75),
                                    (4, 1, 0.6), (8, 3, 1.0)])
def test_routing_is_exact(E, k, cf):
    x, router, *_ = _inputs(E, seed=E * 10 + k)
    want = _jax_routing(x, router, k, cf)
    got = moe.routing(torch.from_numpy(x), torch.from_numpy(router),
                      top_k=k, capacity_factor=cf)
    assert got["C"] == want["C"]
    for name in ("idx", "pos", "keep"):
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    np.testing.assert_allclose(got["gate"].numpy(), np.asarray(want["gate"]),
                               rtol=1e-6)
    if cf < 1:
        assert not bool(got["keep"].all()), "no assignment was dropped"


def test_top_k_breaks_ties_to_the_lowest_index():
    p = np.array([[0.2, 0.3, 0.3, 0.2], [0.25] * 4, [0.1, 0.4, 0.1, 0.4]],
                 np.float32)
    jv, ji = jax_top_k(jnp.asarray(p), 3)
    v, i = moe._top_k(torch.from_numpy(p), 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(i.numpy(), [[1, 2, 0], [0, 1, 2],
                                              [1, 3, 0]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (4, 2, 0.5), (8, 2, 0.75)])
def test_moe_mlp_matches_reference(dtype, E, k, cf):
    npd = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    arrays = _inputs(E, seed=E + int(cf * 100), dtype=npd)
    y_ref, aux_ref = jax_moe(*(jnp.asarray(a) for a in arrays), top_k=k,
                             capacity_factor=cf)
    y, aux = moe.moe_mlp(*(_torch(a) for a in arrays), top_k=k,
                         capacity_factor=cf)
    assert str(y.dtype).split(".")[-1] == y_ref.dtype.name
    want = np.asarray(y_ref, np.float32)
    tol = 1e-5 if dtype == "float32" else 1e-2
    err = np.abs(y.float().numpy() - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())
    np.testing.assert_allclose(float(aux), float(aux_ref), rtol=1e-6)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_mlp_grads_match_reference(cf):
    E, k = 4, 2
    arrays = _inputs(E, seed=7)
    rng = np.random.default_rng(8)
    proj = rng.standard_normal((S, D)).astype(np.float32)

    def jloss(*a):
        y, aux = jax_moe(*a, top_k=k, capacity_factor=cf)
        return jnp.sum(y * proj) + aux
    want = jax.grad(jloss, argnums=tuple(range(5)))(
        *(jnp.asarray(a) for a in arrays))
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, aux = moe.moe_mlp(*ts, top_k=k, capacity_factor=cf)
    got = torch.autograd.grad((y * torch.from_numpy(proj)).sum() + aux, ts)
    for name, g, w in zip(("x", "router", "w1", "w3", "w2"), got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max(), (name, err, np.abs(w).max())


def test_dropped_tokens_get_no_expert_output():
    """With capacity 1 (S * k / E below 1 at this factor) only each
    expert's first assignment is kept; a token none of whose assignments
    was kept gets a zero output."""
    E, k = 4, 2
    x, router, w1, w3, w2 = (torch.from_numpy(a) for a in _inputs(E, 3))
    cf = 1.0 / S
    r = moe.routing(x, router, top_k=k, capacity_factor=cf)
    assert r["C"] == 1
    y, _ = moe.moe_mlp(x, router, w1, w3, w2, top_k=k, capacity_factor=cf)
    kept = r["keep"].view(S, k).any(-1)
    assert int(r["keep"].sum()) == len(set(r["idx"].reshape(-1).tolist()))
    assert bool((y[~kept] == 0).all()) and bool((y[kept] != 0).any())
