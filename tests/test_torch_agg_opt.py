"""The port's fused agg+opt (plain versions and wrappers) against the JAX
package's Pallas kernels (interpret mode) and jnp oracle.  The CUDA
kernel itself is held against its plain version on the card in
tests/test_torch_gpu.py.

Tolerances: with lr=0.25 and momentum=0.5 on integer-valued inputs every
product is exact, and the port equals the jnp oracle ``agg_opt_ref``
bitwise for any W, on those inputs and on random f32 alike.  The Pallas
kernel in interpret mode is compiled by XLA:CPU, which contracts a
multiply-add into an FMA (one rounding where the port rounds twice) and
rewrites the division by the constant W into a multiplication by 1/W
(exact only for W a power of two; the port divides, as the kernel's source
does).  Against it the port is therefore bitwise on integer inputs for
W in {1, 2, 4}, and otherwise within two units in the last place of the
magnitude each expression sums:
|dm'| <= 2 ulp(mu*|m| + |g|) and |dp'| <= 2 ulp(|p| + lr*(|g| + mu*|m'|)).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_opt import ops as jops
from repro.kernels.agg_opt.kernel import agg_opt_chunks, multi_agg_opt_chunks
from repro.kernels.agg_opt.ref import agg_opt_ref as jax_agg_opt_ref
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import agg_opt_ref, multi_agg_opt_ref

NC, CE = 3, 256


def _inputs(seed, W, shape, integer):
    rng = np.random.default_rng(seed)
    if integer:
        draw = lambda s: rng.integers(-8, 9, s).astype(np.float32)
    else:
        draw = lambda s: rng.standard_normal(s).astype(np.float32)
    return draw(shape), draw((W, *shape)), draw(shape)


def _port(p, g, m, lr, mu):
    tp, tg, tm = (torch.from_numpy(a) for a in (p, g, m))
    if g.shape[0] == 1:
        out = agg_opt_ref(tp, tg[0], tm, lr=lr, momentum=mu)
    else:
        out = multi_agg_opt_ref(tp, tg, tm, lr=lr, momentum=mu)
    return tuple(t.numpy() for t in out)


def _pallas(p, g, m, lr, mu):
    if g.shape[0] == 1:
        out = agg_opt_chunks(jnp.asarray(p), jnp.asarray(g[0]),
                             jnp.asarray(m), lr=lr, momentum=mu,
                             interpret=True)
    else:
        out = multi_agg_opt_chunks(jnp.asarray(p), jnp.asarray(g),
                                   jnp.asarray(m), lr=lr, momentum=mu,
                                   interpret=True)
    return tuple(np.asarray(a) for a in out)


def _jnp_ref(p, g, m, lr, mu):
    W = g.shape[0]
    gg = jnp.asarray(g) if W > 1 else jnp.asarray(g[0])
    return tuple(np.asarray(a) for a in jax_agg_opt_ref(
        jnp.asarray(p), gg, jnp.asarray(m), lr=lr, momentum=mu, n_workers=W))


def _assert_within_fma_bound(got, pal, p, g, m, lr, mu):
    got_p, got_m = got
    pal_p, pal_m = pal
    gbar = np.abs(g.astype(np.float64).sum(0) / g.shape[0])
    bound_m = 2 * np.spacing((mu * np.abs(m) + gbar).astype(np.float32))
    bound_p = 2 * np.spacing((np.abs(p) + lr * (gbar + mu * np.abs(got_m)))
                             .astype(np.float32))
    assert np.all(np.abs(got_m - pal_m) <= bound_m)
    assert np.all(np.abs(got_p - pal_p) <= bound_p)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_plain_bitwise_on_integer_inputs(W):
    p, g, m = _inputs(W, W, (NC, CE), integer=True)
    got = _port(p, g, m, 0.25, 0.5)
    for a, b in zip(got, _jnp_ref(p, g, m, 0.25, 0.5)):
        np.testing.assert_array_equal(a, b)
    pal = _pallas(p, g, m, 0.25, 0.5)
    if W & (W - 1) == 0:
        for a, b in zip(got, pal):
            np.testing.assert_array_equal(a, b)
    else:
        _assert_within_fma_bound(got, pal, p, g, m, 0.25, 0.5)


@pytest.mark.parametrize("W", [1, 2, 3, 4])
def test_plain_within_ulp_bound_on_random_f32(W):
    lr, mu = 0.05, 0.9
    p, g, m = _inputs(10 + W, W, (NC, CE), integer=False)
    got = _port(p, g, m, lr, mu)
    for a, b in zip(got, _jnp_ref(p, g, m, lr, mu)):
        np.testing.assert_array_equal(a, b)
    _assert_within_fma_bound(got, _pallas(p, g, m, lr, mu), p, g, m, lr, mu)


@pytest.mark.parametrize("W", [1, 4])
def test_fused_wrappers_ragged_n_match_reference(W):
    """n not a multiple of ce; the reference pads to whole chunks."""
    n, ce = 5000, 1000
    p, g, m = _inputs(20 + W, W, (n,), integer=True)
    ops.reset_launches()
    tp, tg, tm = (torch.from_numpy(a) for a in (p, g, m))
    if W == 1:
        got = ops.fused_agg_opt(tp, tg[0], tm, lr=0.25, momentum=0.5,
                                chunk_elems=ce)
        want = jops.fused_agg_opt(jnp.asarray(p), jnp.asarray(g[0]),
                                  jnp.asarray(m), lr=0.25, momentum=0.5,
                                  chunk_elems=ce, interpret=True)
    else:
        got = ops.fused_multi_agg_opt(tp, tg, tm, lr=0.25, momentum=0.5,
                                      chunk_elems=ce)
        want = jops.fused_multi_agg_opt(jnp.asarray(p), jnp.asarray(g),
                                        jnp.asarray(m), lr=0.25, momentum=0.5,
                                        chunk_elems=ce, interpret=True)
    for a, b in zip(got, want):
        assert a.shape == (n,)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert all(c == 0 for c in ops.LAUNCHES.values())


def test_bf16_plain_rounds_once_from_f32():
    p, g, m = _inputs(30, 2, (NC * CE,), integer=False)
    tp, tg, tm = (torch.from_numpy(a).to(torch.bfloat16) for a in (p, g, m))
    got_p, got_m = ops.fused_multi_agg_opt(tp, tg, tm, lr=0.05, momentum=0.9)
    assert got_p.dtype == got_m.dtype == torch.bfloat16
    f_p, f_m = multi_agg_opt_ref(tp.float(), tg.float(), tm.float(), lr=0.05,
                                 momentum=0.9)
    assert torch.equal(got_p, f_p.to(torch.bfloat16))
    assert torch.equal(got_m, f_m.to(torch.bfloat16))


@pytest.mark.parametrize("bad", ["dtype", "shape", "mixed", "strided"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    p = torch.zeros(512)
    g = torch.zeros(2, 512)
    m = torch.zeros(512)
    if bad == "dtype":
        p, g, m = p.double(), g.double(), m.double()
    elif bad == "shape":
        g = torch.zeros(2, 511)
    elif bad == "mixed":
        m = m.to(torch.bfloat16)
    else:
        g = torch.zeros(512, 2).t()
    with pytest.raises((TypeError, ValueError)):
        ops.fused_multi_agg_opt(p, g, m, lr=0.1, momentum=0.9)
