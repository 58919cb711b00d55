"""The port's flash sliding-window attention on the CPU (its plain
version, ``kernels/swa_attn/ref.py``) against the JAX package's Pallas
kernel in interpret mode and its ``ref.py`` oracle, at the reference
test's shapes (``tests/test_kernels.py::test_swa_attention_sweep``).

The inputs are drawn with numpy from a seed and handed to both packages.
Tolerances are the reference's own: f32 within 2e-5 (the two sum in
other orders), bf16 within 3e-2 (the Pallas kernel casts q to f32 before
it scales it, the plain versions scale in bf16).  Against the reference's
oracle, which the port's plain version repeats operation for operation,
f32 agrees within 2e-6.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.swa_attn.ops import swa_attention as jax_swa
from repro.kernels.swa_attn.ref import swa_attention_ref as jax_swa_ref
from repro_torch.kernels import swa_attn

SHAPES = [(128, 4, 2, 64, 0, 64), (128, 4, 2, 64, 32, 32),
          (128, 2, 2, 120, 48, 64), (64, 8, 1, 32, 0, 32)]
DTYPES = {"float32": (np.float32, torch.float32),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16)}


def _inputs(T, nh, kv, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    np_dt = DTYPES[dtype][0]
    return [rng.standard_normal((2, T, h, hd)).astype(np.float32)
            .astype(np_dt) for h in (nh, kv, kv)]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("T,nh,kv,hd,window,bq", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swa_attention_matches_reference_kernel_and_oracle(T, nh, kv, hd,
                                                          window, bq, dtype):
    q, k, v = _inputs(T, nh, kv, hd, dtype, seed=T + nh + hd + window)
    got = swa_attn.swa_attention(_torch(q), _torch(k), _torch(v),
                                 window=window)
    assert got.shape == (2, T, nh, hd) and got.dtype == DTYPES[dtype][1]
    got = got.float().numpy()
    kern = jax_swa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   window=window, bq=bq, bk=bq)
    oracle = jnp.moveaxis(jax_swa_ref(
        *(jnp.moveaxis(jnp.asarray(a), 1, 2) for a in (q, k, v)),
        window=window), 2, 1)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, np.asarray(kern, np.float32), atol=tol)
    np.testing.assert_allclose(got, np.asarray(oracle, np.float32),
                               atol=2e-6 if dtype == "float32" else tol)


def test_ref_is_the_blockwise_attention_in_the_kernel_layout():
    """ref.swa_attention_ref takes (B, H, T, hd), as the reference's; the
    wrapper takes the model layout and counts no launch on the CPU."""
    q, k, v = (_torch(a) for a in _inputs(96, 4, 2, 32, "float32", 0))
    swa_attn.reset_launches()
    got = swa_attn.swa_attention(q, k, v, window=40)
    assert swa_attn.LAUNCHES["swa_attention_kernel"] == 0
    want = swa_attn.swa_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), window=40)
    assert torch.equal(got, want.transpose(1, 2))


def test_window_masks_keys_outside_it():
    """A query at p sees keys in (p - w, p]: changing a key outside every
    query's window changes nothing."""
    q, k, v = (_torch(a) for a in _inputs(64, 2, 1, 16, "float32", 1))
    base = swa_attn.swa_attention(q, k, v, window=8)
    k2, v2 = k.clone(), v.clone()
    k2[:, 0] += 5.0
    v2[:, 0] -= 5.0
    moved = swa_attn.swa_attention(q, k2, v2, window=8)
    assert torch.equal(base[:, 8:], moved[:, 8:])
    assert not torch.equal(base[:, :8], moved[:, :8])
