"""The health scan (kernel B5, ``health_chunks``) and the device divisor of
the stacked rules, on the CPU.

- ``fused_health_scan`` (its plain version here) against the JAX package's
  ``fused_health_scan`` (the Pallas kernel in interpret mode) and its
  ``health_scan_ref``, on the shapes of tests/test_resilience.py, a
  stacked (W, n) buffer and a bf16 vector: rtol 1e-5 (the three sum in
  different orders), NaN and Inf exactly where the reference has them.
- ``health_chunks_ref`` repeats the CUDA kernel's summation order: held
  bitwise against a scalar float32 loop that spells the kernel out thread
  by thread, warp by warp.
- The rules' ``divisor``: equal to W gives the bits of the W path, and
  another value divides the worker sum by it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.agg_opt.ops import fused_health_scan as jax_scan
from repro.kernels.agg_opt.ref import health_scan_ref as jax_scan_ref
from repro_torch.kernels.agg_opt import (LAUNCHES, adam_opt_ref,
                                         fused_adam_opt, fused_health_scan,
                                         fused_multi_agg_opt, fused_sgd_opt,
                                         health_chunks_ref, health_scan_ref,
                                         multi_agg_opt_ref, reset_launches,
                                         sgd_opt_ref)
from repro_torch.kernels.agg_opt.ref import worker_mean
from repro_torch.optim.protocol import (AdamOptimizer, NesterovOptimizer,
                                        SGDOptimizer)

RTOL = 1e-5


def _rng_normal(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(513,), (33, 47), (8192 * 3 + 5,)])
def test_scan_matches_jax_kernel_and_oracle(shape):
    g = _rng_normal(0, shape)
    got = fused_health_scan(torch.from_numpy(g).reshape(-1))
    assert got.shape == () and got.dtype == torch.float32
    for ref in (jax_scan(jnp.asarray(g), interpret=True),
                jax_scan_ref(jnp.asarray(g))):
        np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    np.testing.assert_allclose(
        float(got), float(health_scan_ref(torch.from_numpy(g))), rtol=RTOL)


@pytest.mark.parametrize("poison", ["nan", "inf", "overflow", "zero"])
def test_nonfinite_and_zero_match_the_reference_exactly(poison):
    g = _rng_normal(1, (3, 8192 + 300))
    if poison == "nan":
        g[1, 13] = np.nan
    elif poison == "inf":
        g[2, 8200] = -np.inf
    elif poison == "overflow":
        g[0, :64] = 1e20                     # squares overflow f32 to +Inf
    else:
        g[1] = 0
    got = fused_health_scan(torch.from_numpy(g)).numpy()
    ref = np.array([float(jax_scan(jnp.asarray(r), interpret=True))
                    for r in g])
    assert (np.isnan(got) == np.isnan(ref)).all()
    assert (np.isposinf(got) == np.isposinf(ref)).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL)
    if poison == "zero":
        assert got[1] == 0.0


@pytest.mark.parametrize("W", [1, 4])
def test_stacked_scan_is_one_scan_per_row(W):
    g = _rng_normal(2, (W, 8192 * 2 + 77))
    got = fused_health_scan(torch.from_numpy(g))
    assert got.shape == (W,)
    for w in range(W):
        np.testing.assert_allclose(
            float(got[w]), float(jax_scan(jnp.asarray(g[w]), interpret=True)),
            rtol=RTOL)
        assert float(got[w]) == float(fused_health_scan(
            torch.from_numpy(g[w].copy())))


def test_bf16_scan_matches_the_reference():
    g32 = _rng_normal(3, (2, 5000))
    g = torch.from_numpy(g32).bfloat16()
    jg = jnp.asarray(g.float().numpy()).astype(jnp.bfloat16)
    got = fused_health_scan(g, chunk_elems=16384)
    for w in range(2):
        np.testing.assert_allclose(
            float(got[w]), float(jax_scan(jg[w], interpret=True)), rtol=RTOL)
        np.testing.assert_allclose(float(got[w]),
                                   float(jax_scan_ref(jg[w])), rtol=RTOL)


def _kernel_order_loop(chunk: np.ndarray) -> np.float32:
    """The CUDA kernel for one chunk, spelled out in float32 scalars:
    thread t sums the squares of its vectors in order, then the warp tree
    (lane l += lane l + off, off = 16..1), then the tree over 8 warps."""
    f = np.float32
    ce = chunk.shape[0]
    acc = [f(0)] * 256
    for t in range(256):
        for i in range(4 * t, ce, 1024):
            for c in range(4):
                v = f(chunk[i + c])
                acc[t] = f(acc[t] + f(v * v))
    warp = []
    for w in range(8):
        lane = acc[32 * w:32 * (w + 1)]
        off = 16
        while off:
            lane = [f(lane[i] + lane[i + off]) for i in range(off)]
            off //= 2
        warp.append(lane[0])
    off = 4
    while off:
        warp = [f(warp[i] + warp[i + off]) for i in range(off)]
        off //= 2
    return warp[0]


@pytest.mark.parametrize("ce", [2048, 896])
def test_chunk_partials_repeat_the_kernel_order_bitwise(ce):
    x = _rng_normal(4, (3, ce)) * np.float32(3)
    x[2, 5] = np.float32(1e19)
    got = health_chunks_ref(torch.from_numpy(x)).numpy()
    want = np.array([_kernel_order_loop(r) for r in x], np.float32)
    assert got.view(np.int32).tolist() == want.view(np.int32).tolist()


def test_scan_checks_its_input_and_counts_no_cpu_launch():
    reset_launches()
    fused_health_scan(torch.ones(10))
    assert LAUNCHES["health_chunks"] == 0
    with pytest.raises(TypeError, match="float32/bfloat16"):
        fused_health_scan(torch.ones(10, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        fused_health_scan(torch.ones(4, 10).t())
    with pytest.raises(ValueError, match=r"\(W, n\)"):
        fused_health_scan(torch.ones(2, 2, 2))


# ------------------------------------------------------------- divisor

def _stacked(W, n=3000, seed=5):
    rng = np.random.default_rng(seed)
    p, m = (torch.from_numpy(rng.standard_normal(n).astype(np.float32))
            for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((W, n)).astype(np.float32))
    g[:, ::9] = 0
    return p, g, m


@pytest.mark.parametrize("W", [2, 3, 4])
def test_divisor_equal_to_w_is_the_w_path_bitwise(W):
    p, g, m = _stacked(W)
    d = torch.tensor([float(W)])
    a = fused_multi_agg_opt(p, g, m, lr=0.05, momentum=0.9)
    b = fused_multi_agg_opt(p, g, m, lr=0.05, momentum=0.9, divisor=d)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(fused_sgd_opt(p, g, lr=0.05),
                       fused_sgd_opt(p, g, lr=0.05, divisor=d))
    slots = [torch.zeros_like(p) for _ in range(4)]
    a = fused_adam_opt(p, g, *[s.clone() for s in slots], lr=1e-3)
    b = fused_adam_opt(p, g, *[s.clone() for s in slots], lr=1e-3,
                       divisor=d)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_divisor_divides_the_worker_sum():
    """Worker 1's row zeroed and the sum divided by 3: the mean of the
    three live rows, as the rules see it."""
    p, g, m = _stacked(4)
    g[1] = 0
    d = torch.tensor([3.0])
    mean3 = (g[0] + g[2] + g[3]) / torch.tensor(3.0)
    assert torch.equal(worker_mean(g, d), mean3)
    got = fused_multi_agg_opt(p, g, m, lr=0.05, momentum=0.9, divisor=d)
    want = multi_agg_opt_ref(p, g, m, lr=0.05, momentum=0.9, divisor=d)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert torch.equal(fused_sgd_opt(p, g, lr=0.05, divisor=d),
                       sgd_opt_ref(p, mean3, lr=0.05))
    slots = [torch.zeros_like(p) for _ in range(4)]
    got = fused_adam_opt(p, g, *[s.clone() for s in slots], lr=1e-3,
                         divisor=d)
    want = adam_opt_ref(p, mean3, *slots, lr=1e-3)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


@pytest.mark.parametrize("opt", [NesterovOptimizer(), SGDOptimizer(),
                                 AdamOptimizer()])
def test_kernel_update_takes_the_divisor_for_stacked_g_only(opt):
    p, g, m = _stacked(4)
    slots = tuple(torch.zeros_like(p) for _ in opt.slots)
    upd = opt.kernel_update(1024, opt.coefs(
        type("TC", (), {"lr": 0.01, "momentum": 0.9})()))
    a = upd(p, g, tuple(s.clone() for s in slots))
    b = upd(p, g, tuple(s.clone() for s in slots),
            divisor=torch.tensor([4.0]))
    assert torch.equal(a[0], b[0])
    with pytest.raises(ValueError, match="divisor"):
        upd(p, g[0], tuple(s.clone() for s in slots),
            divisor=torch.tensor([1.0]))
    with pytest.raises(ValueError, match="one value"):
        fused_sgd_opt(p, g, lr=0.1, divisor=torch.tensor([1.0, 2.0]))
    with pytest.raises(TypeError, match="divisor"):
        fused_sgd_opt(p, g, lr=0.1, divisor=torch.tensor([4]))
