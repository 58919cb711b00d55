"""The port's wire layer (core/wire.py) and its stacked encoded exchange
(core/pipeline.py) against the JAX package's.

1. ``WireFormat``: encode, decode, payload bytes, compression and extra
   slots for all four formats equal ``repro.core.wire.WireFormat`` (its
   jnp codec, ``use_pallas=False``) bitwise.
2. The int8 ring, S = 1 .. 4 workers stacked: the port's
   ``run_wire_exchange`` over the (S, padded) buffer equals, bitwise, an
   eager composition of reference functions in the reference's ring order
   (``repro/core/pipeline.py:409-481``), shard by shard: the partial of
   shard j starts at worker j+1, each hop decodes it, adds its own rows
   and encodes it again; the owner runs ``dequant_agg_opt_ref`` (Nesterov)
   or decodes, adds its rows and divides by N for the rule's jnp oracle
   (SGD, Adam; N = 1 takes the rule directly); the pull encodes the delta
   plus the residual, keeps what the rounding dropped, and adds the
   decoded delta to p.  p, the rule's slots and ``wire_ef`` are compared,
   f32 and bf16 groups.  In-process eager JAX: no forced host devices.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.wire import WireFormat as JaxWire
from repro.configs.base import TrainConfig as JaxTrainConfig
from repro.core.wire import exchange_extra_slots as jax_extra_slots
from repro.core.wire import make_dcn_wire_format as jax_dcn_wire
from repro.kernels.agg_opt.ref import (adam_opt_ref as jax_adam_ref,
                                       agg_opt_ref as jax_agg_opt_ref,
                                       dequant_agg_opt_ref as jax_dequant_ref,
                                       sgd_opt_ref as jax_sgd_ref)
from repro_torch.configs import TrainConfig
from repro_torch.core import StackedComm, build_plan
from repro_torch.core.exchange import check_wire
from repro_torch.core.pipeline import (PIPELINED_STRATEGIES, ring_rows,
                                       run_wire_exchange)
from repro_torch.core.wire import (WIRE_EF_SLOT, WIRE_FORMATS, WireFormat,
                                   exchange_extra_slots, make_dcn_wire_format,
                                   make_wire_format)
from repro_torch.kernels import quant
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
from repro_torch.optim.protocol import (AdamOptimizer, NesterovOptimizer,
                                        SGDOptimizer, SlotSpec)

_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy()).astype(_JNP.get(t.dtype,
                                                          jnp.float32))


def _np(a) -> np.ndarray:
    return np.asarray(a, np.float32)


# ---------------------------------------------------------------- formats

@pytest.mark.parametrize("name", WIRE_FORMATS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wire_format_matches_reference_bitwise(name, dtype):
    ce = 256
    rng = np.random.default_rng(len(name))
    x = torch.from_numpy((rng.standard_normal(4 * ce) * 2)
                         .astype(np.float32)).to(dtype)
    x[ce:2 * ce] = 0                                  # an all-zero chunk
    w, jw = WireFormat(name), JaxWire(name)
    parts = w.encode(x, ce)
    jparts = jw.encode(_jnp(x), ce)
    assert len(parts) == len(jparts)
    for a, b in zip(parts, jparts):
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype) \
            or (name == "f16" and a.dtype == torch.float16)
        np.testing.assert_array_equal(a.float().numpy(), _np(b))
    dec = w.decode(parts, ce)
    np.testing.assert_array_equal(dec.float().numpy(),
                                  _np(jw.decode(jparts, ce)))
    np_dtype = np.float32 if dtype == torch.float32 else jnp.bfloat16
    for n in (0, 1, 4 * ce, 4 * ce + 3):
        assert w.payload_bytes(n, dtype, ce) == jw.payload_bytes(
            n, np_dtype, ce)
    assert w.compression_factor(dtype, ce) == jw.compression_factor(
        np_dtype, ce)
    assert (tuple((s.name, s.dtype) for s in w.extra_slots())
            == tuple((s.name, s.dtype) for s in jw.extra_slots()))
    assert (tuple(s.name for s in exchange_extra_slots(w))
            == tuple(s.name for s in jax_extra_slots(jw, None)))
    assert w.is_identity == jw.is_identity
    assert w.has_scales == jw.has_scales
    assert w.error_feedback == jw.error_feedback


def test_wire_registry_and_what_is_not_ported():
    assert make_wire_format(TrainConfig()).is_identity
    assert make_wire_format(TrainConfig(wire_format="int8")).has_scales
    with pytest.raises(ValueError, match="unknown wire format"):
        WireFormat("int4")
    # the two-tier slot rules are the reference's: one wire_ef at most,
    # owned by an encoded ICI wire, else by an encoded DCN tier
    for ici, dcn in itertools.product(WIRE_FORMATS, (None,) + WIRE_FORMATS):
        tc = TrainConfig(wire_format=ici, wire_format_dcn=dcn)
        jtc = JaxTrainConfig(wire_format=ici, wire_format_dcn=dcn)
        w_dcn = make_dcn_wire_format(tc)
        j_dcn = jax_dcn_wire(jtc)
        assert (w_dcn is None) == (j_dcn is None)
        assert (w_dcn is None) == (dcn in (None, "identity"))
        assert (tuple((s.name, s.dtype) for s in exchange_extra_slots(
                    make_wire_format(tc), w_dcn))
                == tuple((s.name, s.dtype) for s in jax_extra_slots(
                    JaxWire(ici), j_dcn)))
    # a DCN wire needs the hierarchical strategy, as the reference's engine
    check_wire("hierarchical", WireFormat("identity"), WireFormat("int8"))
    with pytest.raises(ValueError, match="hierarchical"):
        check_wire("sharded_ps", WireFormat("identity"), WireFormat("int8"))
    # a non-identity wire needs a chunk strategy with a shard dimension
    check_wire("sharded_ps", WireFormat("int8"))
    check_wire("allreduce", WireFormat("identity"))
    with pytest.raises(ValueError, match="shard dimension"):
        check_wire("allreduce", WireFormat("int8"))
    assert "sharded_ps" in PIPELINED_STRATEGIES


def test_wire_ef_slot_is_f32_in_a_bf16_group_and_last():
    (ef,) = WireFormat("int8").extra_slots()
    assert ef == SlotSpec(WIRE_EF_SLOT, "float32")
    assert ef.resolve_dtype(torch.bfloat16) == torch.float32
    assert WireFormat("identity").extra_slots() == ()


# ------------------------------------------------------ the stacked ring

RULES = {"nesterov": (NesterovOptimizer(), (0.05, 0.9)),
         "sgd": (SGDOptimizer(), (0.05,)),
         "adam": (AdamOptimizer(), (3e-4,))}


def _setup(S, rule, dtype, ce, seed):
    """Stacked gradients, p, the rule's slots and a nonzero residual."""
    rng = np.random.default_rng(seed)
    n = S * 3 * ce
    f = lambda *shape, scale=1.0: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32))
    g = f(S, n, scale=1e-2).to(dtype)
    g[:, ::11] = 0
    p = f(n).to(dtype)
    opt, _ = RULES[rule]
    slots = []
    for spec in opt.slots:
        t = f(n, scale=1e-2)
        if spec.name in ("v", "k1", "k2"):
            t = t.abs()
        if spec.name in ("k1", "k2"):
            t[::7] = 0
        slots.append(t.to(spec.resolve_dtype(dtype)))
    r = f(n, scale=1e-4)
    return g, p, tuple(slots), r


def _reference(S, rule, g, p, slots, r, ce):
    """The reference's per-device ring, written shard by shard, from its
    eager jnp functions.  Returns (p', slots', r') as numpy f32."""
    wire = JaxWire("int8")
    _, coefs = RULES[rule]
    n = p.numel()
    L = n // S
    G = _jnp(g)
    P, R = _jnp(p), _jnp(r)
    SL = [_jnp(t) for t in slots]
    p_out, s_out, r_out = [], [[] for _ in slots], []
    for j in range(S):
        cols = slice(j * L, (j + 1) * L)
        row = lambda w: G[w % S, cols].astype(jnp.float32)
        own = row(j)
        pw, sw = P[cols], tuple(t[cols] for t in SL)
        if S == 1:
            gin, parts = own / S, None
        else:
            parts = wire.encode(row(j + 1), ce)
            for k in range(2, S):
                parts = wire.encode(wire.decode(parts, ce) + row(j + k), ce)
            gin = (wire.decode(parts, ce) + own) / S
        if rule == "nesterov":
            lr, mu = coefs
            if parts is None:
                p2, m2 = jax_agg_opt_ref(pw, gin, sw[0], lr=lr, momentum=mu)
            else:
                p2, m2 = jax_dequant_ref(pw, *parts, own, sw[0], lr=lr,
                                         momentum=mu, inv_n=1.0 / S,
                                         chunk_elems=ce)
            s2 = (m2,)
        elif rule == "sgd":
            p2, s2 = jax_sgd_ref(pw, gin, lr=coefs[0]), ()
        else:
            p2, *s2 = jax_adam_ref(pw, gin, *sw, lr=coefs[0])
        e = (p2.astype(jnp.float32) - pw.astype(jnp.float32)) + R[cols]
        pull = wire.encode(e, ce)
        r_out.append(e - wire.decode(pull, ce))
        p_out.append((pw.astype(jnp.float32) + wire.decode(pull, ce))
                     .astype(pw.dtype))
        for acc, t in zip(s_out, s2):
            acc.append(t)
    cat = lambda xs: _np(jnp.concatenate(xs))
    return cat(p_out), tuple(cat(x) for x in s_out), cat(r_out)


def _port(S, rule, g, p, slots, r, ce):
    opt, coefs = RULES[rule]
    (group,) = build_plan({"w": p}, chunk_bytes=ce * p.element_size(),
                          n_shards=S).groups
    assert group.chunk_elems == ce and group.padded == p.numel()
    fd = opt.kernel_dequant_update(ce, coefs, 1.0 / S)
    assert (fd is None) == (rule != "nesterov")
    return run_wire_exchange("sharded_ps", StackedComm(S), g, p,
                             tuple(t.clone() for t in slots),
                             opt.kernel_update(ce, coefs), group,
                             WireFormat("int8"), r.clone(), fd)


@pytest.mark.parametrize("S", [1, 2, 3, 4])
@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stacked_int8_ring_equals_reference_ring_bitwise(S, rule, dtype):
    ce = 256 if dtype == torch.float32 else 512
    g, p, slots, r = _setup(S, rule, dtype, ce, seed=S * 7 + len(rule))
    reset_launches()
    quant.reset_launches()
    p2, s2, r2 = _port(S, rule, g, p, slots, r, ce)
    # CPU tensors take the plain versions: no launch is counted
    assert all(c == 0 for c in LAUNCHES.values())
    assert all(c == 0 for c in quant.LAUNCHES.values())
    wp, ws, wr = _reference(S, rule, g, p, slots, r, ce)
    assert p2.dtype == dtype and r2.dtype == torch.float32
    np.testing.assert_array_equal(p2.float().numpy(), wp)
    np.testing.assert_array_equal(r2.numpy(), wr)
    assert len(s2) == len(ws)
    for a, b, spec in zip(s2, ws, RULES[rule][0].slots):
        assert a.dtype == spec.resolve_dtype(dtype)
        np.testing.assert_array_equal(a.float().numpy(), b)
    assert float(r2.abs().max()) > 0           # error feedback engaged


def test_ring_rows_start_each_shard_at_the_next_worker():
    S, L = 3, 4
    g = torch.arange(S * S * L, dtype=torch.float32).view(S, S * L)
    first = ring_rows(g, 1)
    for j in range(S):
        assert torch.equal(first[j * L:(j + 1) * L],
                           g[(j + 1) % S, j * L:(j + 1) * L])


def test_run_wire_exchange_rejects_the_identity_wire():
    g, p, slots, r = _setup(2, "sgd", torch.float32, 256, seed=0)
    (group,) = build_plan({"w": p}, chunk_bytes=1024, n_shards=2).groups
    opt, coefs = RULES["sgd"]
    with pytest.raises(ValueError, match="identity"):
        run_wire_exchange("sharded_ps", StackedComm(2), g, p, slots,
                          opt.kernel_update(256, coefs), group,
                          WireFormat("identity"), r)
