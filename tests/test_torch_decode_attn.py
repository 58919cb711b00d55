"""The port's decode attention on the CPU (its plain version,
``kernels/decode_attn/ref.py``) against the JAX package's Pallas kernel in
interpret mode and its ``ref.py`` oracle, at the reference test's shapes
(``tests/test_kernels.py::test_decode_attention_sweep``): 20% of the slots
empty, and invariance under a rotation of the ring.

The inputs are drawn with numpy from a seed and handed to both packages.
Tolerance: 3e-5, the reference's own (the Pallas kernel sums over 128-slot
blocks, the plain versions over 1024-slot ones); against the reference's
oracle, which the plain version repeats operation for operation, 2e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attn.ops import decode_attention as jax_decode
from repro.kernels.decode_attn.ref import decode_attention_ref as jax_ref
from repro_torch.kernels import decode_attn


def _inputs(B, S, nh, kv, hd, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, nh, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, kv, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,nh,kv,hd,window", [
    (256, 4, 2, 64, 0), (300, 4, 2, 64, 100), (512, 8, 8, 128, 0),
    (1024, 5, 5, 64, 256)])
def test_decode_attention_matches_reference_kernel_and_oracle(S, nh, kv, hd,
                                                              window):
    B = 2
    q, k, v = _inputs(B, S, nh, kv, hd, seed=S + nh + window)
    fill = int(S * 0.8)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    pos = np.where(pos < fill, pos, -1).astype(np.int32)
    qp = np.full((B,), fill, np.int32)
    decode_attn.reset_launches()
    got = decode_attn.decode_attention(
        *(torch.from_numpy(a) for a in (q, k, v, pos, qp)), window=window)
    assert decode_attn.LAUNCHES["decode_attention_kernel"] == 0
    assert got.shape == (B, 1, nh, hd) and got.dtype == torch.float32
    kern = jax_decode(*(jnp.asarray(a) for a in (q, k, v, pos, qp)),
                      window=window, bs=128)
    oracle = jax_ref(jnp.asarray(q[:, 0].reshape(B, kv, nh // kv, hd)),
                     jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                     jnp.asarray(qp.reshape(B, 1)), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=3e-5)
    np.testing.assert_allclose(got.numpy().reshape(B, kv, nh // kv, hd),
                               np.asarray(oracle), atol=2e-6)


def test_decode_attention_ring_rotation():
    B, S, nh, kv, hd = 1, 128, 2, 1, 32
    q, k, v = (torch.from_numpy(a) for a in _inputs(B, S, nh, kv, hd, 50))
    pos = torch.arange(S, dtype=torch.int32)[None]
    qp = torch.full((B,), S - 1, dtype=torch.int32)
    base = decode_attn.decode_attention(q, k, v, pos, qp, window=0)
    rot = [torch.roll(t, 37, dims=1) for t in (k, v, pos)]
    rotated = decode_attn.decode_attention(q, *rot, qp, window=0)
    np.testing.assert_allclose(base.numpy(), rotated.numpy(), atol=1e-5)
    kern = jax_decode(*(jnp.asarray(t.numpy()) for t in (q, *rot, qp)),
                      window=0, bs=64)
    np.testing.assert_allclose(rotated.numpy(), np.asarray(kern), atol=3e-5)


def test_empty_leading_slots_and_a_bf16_cache():
    """The first blocks of the ring empty, the cache in bf16 (as the
    serving path keeps it), windowed: the plain version against the
    reference's kernel on the same bf16 values."""
    import ml_dtypes
    B, S, nh, kv, hd, window = 2, 384, 4, 2, 64, 200
    q, k, v = _inputs(B, S, nh, kv, hd, seed=7)
    k, v = (a.astype(ml_dtypes.bfloat16) for a in (k, v))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    pos[:, :150] = -1
    qp = np.full((B,), S - 1, np.int32)
    tk, tv = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
              for a in (k, v))
    got = decode_attn.decode_attention(torch.from_numpy(q), tk, tv,
                                       torch.from_numpy(pos),
                                       torch.from_numpy(qp), window=window)
    kern = jax_decode(*(jnp.asarray(a) for a in (q, k, v, pos, qp)),
                      window=window, bs=128)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=3e-5)
