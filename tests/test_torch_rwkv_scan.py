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
entries still match.
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
