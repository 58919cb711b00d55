"""The port's int8 wire codec (plain versions and wrappers) against the JAX
package's eager jnp oracle and its Pallas kernels in interpret mode.  The
CUDA kernels are held against the plain versions on the card in
tests/test_torch_gpu.py.

Tolerances: the plain quantize and dequantize equal the eager jnp oracle
(``repro/kernels/quant/ref.py``) bitwise, zero chunks, ties at .5 and the
ends +-127 included.  XLA:CPU compiles the interpret-mode kernel's
``amax / 127`` as ``amax * (1/127)``, so against it a chunk's scale is
within 1 ulp, and a payload entry within 1 (an ulp of the scale can move
x / scale across a rounding boundary); the dequantize of the same payload
and scales is one product and is bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant.ops import dequantize_int8 as jax_dequant
from repro.kernels.quant.ops import quantize_int8 as jax_quant
from repro.kernels.quant.ref import (dequantize_int8_ref as jnp_dequant_ref,
                                     quantize_int8_ref as jnp_quant_ref)
from repro_torch.kernels import quant
from repro_torch.kernels.quant.ref import (dequantize_int8_ref,
                                           quantize_int8_ref)


def _input(kind, n_chunks, ce, seed):
    """Chunks of normal * 3 values, with one all-zero chunk and one chunk
    of amax 127 (scale exactly 1) holding ties at .5 and +-127."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n_chunks, ce)) * 3).astype(np.float32)
    if kind == "special":
        x[1] = 0
        x[2] = np.clip(x[2], -126, 126)
        x[2, :8] = [127, -127, 2.5, -3.5, 0.5, -0.5, 1.5, -126.5]
    elif kind == "tiny":
        x *= np.float32(1e-30)                 # subnormal-adjacent scales
    return x.reshape(-1)


CASES = [("normal", 16, 256), ("special", 4, 256), ("normal", 3, 1000),
         ("tiny", 4, 128), ("special", 5, 16384)]


@pytest.mark.parametrize("kind,nc,ce", CASES)
def test_plain_codec_bitwise_against_eager_jnp_oracle(kind, nc, ce):
    x = _input(kind, nc, ce, seed=nc * ce)
    q, s = quantize_int8_ref(torch.from_numpy(x), ce)
    jq, js = jnp_quant_ref(jnp.asarray(x), ce)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    d = dequantize_int8_ref(q, s, ce)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jnp_dequant_ref(jq, js, ce)))
    if kind == "special":
        assert s[1] == 1.0 and not q.view(nc, ce)[1].any()
        assert q.view(nc, ce)[2, :8].tolist() == [127, -127, 2, -4, 0, 0,
                                                  2, -126]


@pytest.mark.parametrize("kind,nc,ce", [c for c in CASES if c[2] % 128 == 0])
def test_plain_codec_against_interpret_mode_kernels(kind, nc, ce):
    x = _input(kind, nc, ce, seed=7 + nc)
    q, s = quant.quantize_int8(torch.from_numpy(x), chunk_elems=ce)
    kq, ks = jax_quant(jnp.asarray(x), chunk_elems=ce)
    kq, ks = np.asarray(kq).astype(np.int32), np.asarray(ks)
    ulp = np.abs(s.numpy().view(np.int32).astype(np.int64)
                 - ks.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    assert np.abs(q.numpy().astype(np.int32) - kq).max() <= 1
    # one product: the dequantize of one payload is bitwise
    d = quant.dequantize_int8(q, s, chunk_elems=ce)
    kd = jax_dequant(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                     chunk_elems=ce)
    np.testing.assert_array_equal(d.numpy(), np.asarray(kd))


def test_roundtrip_error_is_at_most_half_a_grid_step():
    x = torch.from_numpy(_input("normal", 8, 512, seed=3))
    q, s = quant.quantize_int8(x, chunk_elems=512)
    err = (quant.dequantize_int8(q, s, chunk_elems=512) - x).abs()
    assert bool((err.view(8, 512) <= s[:, None] / 2 * (1 + 1e-6)).all())


def test_cpu_wrappers_take_the_plain_version_and_count_nothing():
    quant.reset_launches()
    x = torch.from_numpy(_input("normal", 4, 256, seed=1))
    q, s = quant.quantize_int8(x, chunk_elems=256)
    quant.dequantize_int8(q, s, chunk_elems=256)
    assert quant.LAUNCHES == {"quantize_chunks": 0, "dequantize_chunks": 0}


@pytest.mark.parametrize("bad", ["dtype", "ragged", "strided", "scales"])
def test_wrappers_reject_what_the_codec_does_not_take(bad):
    x = torch.zeros(1024)
    if bad == "dtype":
        with pytest.raises(TypeError):
            quant.quantize_int8(x.double(), chunk_elems=256)
    elif bad == "ragged":
        with pytest.raises(ValueError, match="whole chunks"):
            quant.quantize_int8(x[:1000], chunk_elems=256)
    elif bad == "strided":
        with pytest.raises(ValueError, match="contiguous"):
            quant.quantize_int8(torch.zeros(2048)[::2], chunk_elems=256)
    else:
        q, s = quant.quantize_int8(x, chunk_elems=256)
        with pytest.raises(ValueError):
            quant.dequantize_int8(q, s[:3], chunk_elems=256)
