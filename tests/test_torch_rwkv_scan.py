"""The plain version of the RWKV6 chunked-scan kernel (B8,
``repro_torch/kernels/rwkv_scan``) and its wrapper against the JAX
package's kernel and oracles, on the CPU.

Inputs are drawn with numpy (r, k, v at scale 0.5, the data-dependent
decay ``exp(-exp(N(0, 0.5) - 2))`` of ``tests/test_kernels.py``, a state
at scale 0.3), in the model layout (B, T, H, 64).  Tolerances, measured
and then stated, absolute after scaling by max(1, max|want|):
- against the reference's kernel in interpret mode (zero state, T a
  multiple of 64) and ``rwkv_chunked`` (nonzero state): y and the state
  within 1e-5 (measured 1.9e-6 and 4.8e-7: the same factorization, sums
  in another order; XLA's cumprod rounds otherwise);
- against ``rwkv_recurrence`` (another algorithm): within 1e-5 (measured
  3.7e-7 relative to the largest entry);
- bf16 inputs against the kernel: y within one bf16 rounding, 2e-2.
The strong-decay sweep: for a uniform decay w >= 0.3 the chunked form is
finite and matches the recurrence; for w <= 0.25 the cumulative decay
underflows within a chunk and the output holds inf/NaN where the
recurrence is finite (the reference's ``rwkv_chunked`` too); its finite
entries still match.  A mixed decay (0.1 on channels 0-31, the data's
decay on the rest) puts finite and inf ``kd`` in one chunk: the plain
version's non-finite entries all sit where ``rwkv_chunked`` has non-finite
ones (which multiplies its triangle by a 0/1 mask, so it has NaN in more
places: measured 3200 of 8192 against 8192 at T 64), and its finite
entries match the recurrence within 1e-5 (measured 3.3e-7).

The kernel (``csrc/rwkv_scan.cu``) computes the same a, rq and kd as the
plain version bit for bit and sums its four products in another order:
the plain version with every product summed by a per-index loop, in
ascending or descending order, puts inf and NaN in the same places
(measured: every case) and agrees within 1e-5 elsewhere (measured 4.5e-7).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan.kernel import rwkv_scan_kernel
from repro.models.rwkv import rwkv_chunked, rwkv_recurrence
from repro_torch.kernels import rwkv_scan as scan
from repro_torch.kernels.rwkv_scan import rwkv_scan, rwkv_scan_ref

H, HD = 2, 64
TOL = 1e-5


def _inputs(B, T, seed, w_value=None, zero_state=False):
    g = np.random.default_rng(seed)
    r, k, v = (g.standard_normal((B, T, H, HD)).astype(np.float32) * 0.5
               for _ in range(3))
    if w_value is None:
        w = np.exp(-np.exp(g.standard_normal((B, T, H, HD)) * 0.5 - 2.0))
    else:
        w = np.full((B, T, H, HD), w_value)
    u = g.standard_normal((H, HD)) * 0.5
    S = (np.zeros((B, H, HD, HD)) if zero_state
         else g.standard_normal((B, H, HD, HD)) * 0.3)
    return (r, k, v, w.astype(np.float32), u.astype(np.float32),
            S.astype(np.float32))


def _port(inputs, dtype=torch.float32):
    r, k, v, w, u, S = (torch.from_numpy(a) for a in inputs)
    return rwkv_scan(*(x.to(dtype) for x in (r, k, v, w)), u, S)


def _jax(fn, inputs):
    return [np.asarray(a, np.float32)
            for a in fn(*(jnp.asarray(a) for a in inputs))]


def _close(got, want, tol=TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_matches_reference_kernel_zero_state(dtype):
    """B 1, T 128: two chunks a head, four grid steps in interpret mode."""
    B, T = 1, 128
    inputs = _inputs(B, T, seed=1, zero_state=True)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def fold(a):
        return (jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3)
                .reshape(B * H, T, HD))
    r, k, v, w, u, _ = inputs
    uu = jnp.broadcast_to(jnp.asarray(u)[None], (B, H, HD))
    yk, sk = rwkv_scan_kernel(fold(r), fold(k), fold(v), fold(w),
                              uu.reshape(B * H, 1, HD), interpret=True)
    yk = np.asarray(yk.astype(jnp.float32)).reshape(B, H, T, HD) \
        .transpose(0, 2, 1, 3)
    y, s = _port(inputs, dtype)
    assert y.dtype == dtype and s.dtype == torch.float32
    tol = TOL if dtype == torch.float32 else 2e-2
    _close(y, yk, tol)
    _close(s, np.asarray(sk).reshape(B, H, HD, HD), tol)


@pytest.mark.parametrize("T", [64, 128])
def test_plain_matches_rwkv_chunked_nonzero_state(T):
    inputs = _inputs(2, T, seed=2)
    yc, sc = _jax(rwkv_chunked, inputs)
    y, s = _port(inputs)
    _close(y, yc)
    _close(s, sc)


@pytest.mark.parametrize("T", [1, 40, 100])
def test_plain_matches_recurrence_ragged(T):
    """T = 1 and T < 64 are one ragged chunk; T = 100 a full and a ragged
    one; all from a nonzero state."""
    inputs = _inputs(2, T, seed=3 + T)
    yr, sr = _jax(rwkv_recurrence, inputs)
    y, s = _port(inputs)
    assert y.shape == (2, T, H, HD)
    _close(y, yr)
    _close(s, sr)


@pytest.mark.parametrize("w_value", [0.99, 0.9, 0.5, float(np.exp(-1.0)),
                                     0.3, 0.25, 0.1, 0.01])
def test_strong_decay_sweep(w_value):
    inputs = _inputs(1, 128, seed=4, w_value=w_value, zero_state=True)
    yr, sr = _jax(rwkv_recurrence, inputs)
    assert np.isfinite(yr).all() and np.isfinite(sr).all()
    y, s = (t.numpy() for t in _port(inputs))
    fin = np.isfinite(y)
    if w_value >= 0.3:
        assert fin.all() and np.isfinite(s).all()
    else:
        # the factorization's limit: a = cumprod(w) underflows in a chunk
        assert not fin.all()
        yc, _ = _jax(rwkv_chunked, inputs)
        assert not np.isfinite(yc).all()
    _close(y[fin], yr[fin])


def _mixed(inputs):
    """0.1 on channels 0-31 of the decay, the inputs' decay on the rest."""
    r, k, v, w, u, S = inputs
    w = w.copy()
    w[..., :32] = 0.1
    return r, k, v, w, u, S


@pytest.mark.parametrize("T", [64, 128])
def test_mixed_decay_nonfinite_where_chunked_has_it(T):
    inputs = _mixed(_inputs(1, T, seed=4))
    y, s = (t.numpy() for t in _port(inputs))
    yc, sc = _jax(rwkv_chunked, inputs)
    yr, sr = _jax(rwkv_recurrence, inputs)
    assert np.isfinite(yr).all() and np.isfinite(sr).all()
    for got, chunked in ((y, yc), (s, sc)):
        bad = ~np.isfinite(got)
        assert bad.any() and not bad.all()
        assert not np.isfinite(chunked[bad]).any()
    fin_y, fin_s = np.isfinite(y), np.isfinite(s)
    _close(y[fin_y], yr[fin_y])
    _close(s[fin_s], sr[fin_s])


def _reordered(r, k, v, w, u, state, *, descending, ct=64):
    """``rwkv_scan_ref`` with each of its four products (and diag) summed
    by a loop over the reduction index, ascending or descending, instead of
    a matrix product: the same a, rq, kd and kd * a_last, other sums."""
    T = r.shape[1]
    rf, kf, vf, wf = (x.float().transpose(1, 2) for x in (r, k, v, w))
    uf = u.float()[None, :, None, :]
    S = state.float()

    def loop(m):
        return reversed(range(m)) if descending else range(m)

    ys = []
    for c0 in range(0, T, ct):
        r_, k_, v_, w_ = (x[:, :, c0:c0 + ct] for x in (rf, kf, vf, wf))
        n, hd = r_.shape[2], r_.shape[3]
        a = w_.clone()
        for i in range(1, n):
            a[:, :, i] *= a[:, :, i - 1]
        a_prev = torch.cat([torch.ones_like(a[:, :, :1]), a[:, :, :-1]], 2)
        rq, kd = r_ * a_prev, k_ / a
        att = torch.zeros(*rq.shape[:2], n, n)
        for d in loop(hd):
            att = att + rq[..., :, d, None] * kd[..., None, :, d]
        lower = torch.ones(n, n, dtype=torch.bool).tril(-1)
        att = torch.where(lower, att, torch.zeros(()))
        prods = r_ * (uf * k_)
        diag = torch.zeros_like(prods[..., :1])
        for d in loop(hd):
            diag = diag + prods[..., d:d + 1]
        y_att, y_s = torch.zeros_like(v_), torch.zeros_like(v_)
        for j in loop(n):
            y_att = y_att + att[..., :, j, None] * v_[..., j, None, :]
        for d in loop(hd):
            y_s = y_s + rq[..., :, d, None] * S[..., d, None, :]
        ys.append(y_att + y_s + diag * v_)
        a_last = a[:, :, -1]
        kdl = kd * a_last[:, :, None]
        U = torch.zeros_like(S)
        for j in loop(n):
            U = U + kdl[..., j, :, None] * v_[..., j, None, :]
        S = a_last[..., None] * S + U
    return torch.cat(ys, dim=2).transpose(1, 2), S


@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("decay", ["data", 0.1, "mixed"])
def test_sum_order_keeps_the_nonfinite_places(decay, descending):
    """The property the kernel relies on: a sum's class (finite, +-inf,
    NaN) does not depend on its order, so summing in another order puts
    inf and NaN where the plain version has them."""
    inputs = _inputs(1, 130, seed=9, w_value=decay if decay == 0.1 else None)
    if decay == "mixed":
        inputs = _mixed(inputs)
    t = [torch.from_numpy(a) for a in inputs]
    got = _reordered(*t, descending=descending)
    want = rwkv_scan_ref(*t)
    for g, w_ in zip(got, want):
        assert torch.equal(torch.isnan(g), torch.isnan(w_))
        assert torch.equal(torch.isinf(g), torch.isinf(w_))
        assert torch.equal(g[torch.isinf(g)], w_[torch.isinf(w_)])
        fin = torch.isfinite(w_)
        if fin.any():               # w 0.1: the state is all inf and NaN
            _close(g[fin], w_[fin].numpy())
    assert bool(torch.isfinite(want[0]).all()) == (decay == "data")


def test_wrapper_on_the_cpu_takes_the_plain_version():
    inputs = _inputs(2, 70, seed=5)
    scan.reset_launches()
    y, s = _port(inputs)
    want = rwkv_scan_ref(*(torch.from_numpy(a) for a in inputs))
    assert torch.equal(y, want[0]) and torch.equal(s, want[1])
    assert scan.LAUNCHES == {"rwkv_scan_kernel": 0}


def test_wrapper_checks_its_inputs():
    r, k, v, w, u, S = (torch.from_numpy(a) for a in _inputs(1, 8, seed=6))
    with pytest.raises(ValueError, match="want four"):
        rwkv_scan(r, k[:, :4], v, w, u, S)
    with pytest.raises(ValueError, match="state"):
        rwkv_scan(r, k, v, w, u, S[:, :1])
    with pytest.raises(ValueError, match="T >= 1"):
        rwkv_scan(r[:, :0], k[:, :0], v[:, :0], w[:, :0], u, S)
    with pytest.raises(ValueError, match="several devices"):
        rwkv_scan(r, k, v, w, u, S.to("meta"))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rwkv_scan(r.requires_grad_(), k, v, w, u, S)
    with torch.no_grad():
        y, _ = rwkv_scan(r, k, v, w, u, S)
    assert y.shape == r.shape
