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

The int8 wire's tail ``dequant_agg_opt_chunks`` computes
``g = (q*s + g_own) * inv_n`` before the same rule.  The port equals the
eager jnp oracle ``dequant_agg_opt_ref`` bitwise in f32 and bf16; against
the interpret-mode kernel, where XLA may contract ``q*s + g_own`` into
one FMA, |dg| <= 2 ulp(|q*s| + |g_own|) * inv_n, and that difference adds
|dg| to m' and lr*(1 + mu)*|dm'| to p' beyond the 2-ulp roundings above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_opt import ops as jops
from repro.kernels.agg_opt.kernel import agg_opt_chunks, multi_agg_opt_chunks
from repro.kernels.agg_opt.kernel import dequant_agg_opt_chunks
from repro.kernels.agg_opt.ref import agg_opt_ref as jax_agg_opt_ref
from repro.kernels.agg_opt.ref import (dequant_agg_opt_ref as
                                       jax_dequant_agg_opt_ref)
from repro_torch.kernels.agg_opt import ops
from repro_torch.kernels.agg_opt.ref import (agg_opt_ref, block_diagonal,
                                             dequant_agg_opt_ref,
                                             multi_agg_opt_ref)

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


def _dequant_inputs(seed, n_chunks, ce):
    rng = np.random.default_rng(seed)
    p, g_own, m = (rng.standard_normal(n_chunks * ce).astype(np.float32)
                   for _ in range(3))
    q = rng.integers(-127, 128, n_chunks * ce).astype(np.int8)
    scales = (rng.random(n_chunks) * 0.05 + 1e-3).astype(np.float32)
    return p, q, scales, g_own, m


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t if dtype == "float32" else t.to(torch.bfloat16)


def _to_jnp(t):
    return jnp.asarray(t.float().numpy()).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inv_n", [1.0, 1 / 3, 0.25])
def test_dequant_agg_opt_plain_bitwise_against_eager_jnp_oracle(dtype,
                                                                inv_n):
    p, q, s, g_own, m = _dequant_inputs(int(inv_n * 12), NC, CE)
    tp, tg, tm = (_to_torch(a, dtype) for a in (p, g_own, m))
    kw = dict(lr=0.05, momentum=0.9, inv_n=inv_n, chunk_elems=CE)
    got = ops.fused_dequant_agg_opt(tp, torch.from_numpy(q),
                                    torch.from_numpy(s), tg, tm, **kw)
    want = jax_dequant_agg_opt_ref(_to_jnp(tp), jnp.asarray(q),
                                   jnp.asarray(s), _to_jnp(tg), _to_jnp(tm),
                                   **kw)
    for a, b in zip(got, want):
        assert a.dtype == tp.dtype
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("inv_n", [1.0, 1 / 3])
def test_dequant_agg_opt_plain_within_fma_bound_of_interpret_kernel(inv_n):
    lr, mu = 0.05, 0.9
    p, q, s, g_own, m = _dequant_inputs(5, NC, CE)
    got_p, got_m = (t.numpy() for t in dequant_agg_opt_ref(
        *(torch.from_numpy(a) for a in (p, q, s, g_own, m)), lr=lr,
        momentum=mu, inv_n=inv_n, chunk_elems=CE))
    pal_p, pal_m = (np.asarray(a).reshape(-1) for a in dequant_agg_opt_chunks(
        jnp.asarray(p).reshape(NC, CE), jnp.asarray(q).reshape(NC, CE),
        jnp.asarray(s).reshape(NC, 1), jnp.asarray(g_own).reshape(NC, CE),
        jnp.asarray(m).reshape(NC, CE), lr=lr, momentum=mu, inv_n=inv_n,
        interpret=True))
    qs = np.abs(q.astype(np.float32).reshape(NC, CE) * s[:, None]).reshape(-1)
    g = (qs + np.abs(g_own)) * inv_n
    bound_g = 2 * np.spacing((qs + np.abs(g_own)).astype(np.float32)) * inv_n
    bound_m = 2 * np.spacing((mu * np.abs(m) + g).astype(np.float32)) \
        + bound_g
    bound_p = 2 * np.spacing((np.abs(p) + lr * (g + mu * np.abs(got_m)))
                             .astype(np.float32)) + lr * (1 + mu) * bound_m
    assert np.all(np.abs(got_m - pal_m) <= bound_m)
    assert np.all(np.abs(got_p - pal_p) <= bound_p)


@pytest.mark.parametrize("S", [2, 3, 4])
def test_dequant_agg_opt_reads_the_block_diagonal_of_a_stacked_g_own(S):
    """g_own given as the stacked (S, n) buffer: shard j's run of row j,
    the owner's own contribution, as the contiguous rows would give."""
    n = S * 2 * CE
    rng = np.random.default_rng(S)
    g = torch.from_numpy(rng.standard_normal((S, n)).astype(np.float32))
    diag = block_diagonal(g)
    L = n // S
    for j in range(S):
        assert torch.equal(diag[j * L:(j + 1) * L], g[j, j * L:(j + 1) * L])
    p, q, s, _, m = _dequant_inputs(S, n // CE, CE)
    args = (torch.from_numpy(p), torch.from_numpy(q), torch.from_numpy(s))
    kw = dict(lr=0.05, momentum=0.9, inv_n=1 / S, chunk_elems=CE)
    a = ops.fused_dequant_agg_opt(*args, g, torch.from_numpy(m), **kw)
    b = ops.fused_dequant_agg_opt(*args, diag, torch.from_numpy(m), **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError, match="shards of whole chunks"):
        ops.fused_dequant_agg_opt(*(t[:n - CE] for t in args[:2]),
                                  args[2][:-1], g[:, :n - CE].contiguous(),
                                  torch.from_numpy(m)[:n - CE], **kw)


def test_rules_take_an_f32_gradient_in_a_bf16_group():
    """The int8 wire hands SGD and Adam the decoded mean in f32 while the
    group is bf16; the rules compute in f32 from it, not from a bf16
    rounding of it."""
    p, g, m = _inputs(40, 1, (NC * CE,), integer=False)
    tp, tm = (torch.from_numpy(a).to(torch.bfloat16) for a in (p, m))
    tg = torch.from_numpy(g[0])
    got = ops.fused_agg_opt(tp, tg, tm, lr=0.05, momentum=0.9)
    want = jax_agg_opt_ref(_to_jnp(tp), jnp.asarray(g[0]), _to_jnp(tm),
                           lr=0.05, momentum=0.9)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert not torch.equal(ops.fused_sgd_opt(tp, tg, lr=0.05),
                           ops.fused_sgd_opt(tp, tg.to(torch.bfloat16),
                                             lr=0.05))
    with pytest.raises(TypeError):
        ops.fused_sgd_opt(tp.float(), tg.to(torch.bfloat16), lr=0.05)
