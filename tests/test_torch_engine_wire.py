"""The port's PHub train step over an encoded wire against the JAX
package's.

1. W=1, int8: one JAX ``PHubEngine`` step on a (1, 1) mesh with
   ``use_pallas=True, wire_format="int8"`` (the Pallas quant and agg_opt
   kernels in interpret mode), its weights and optimizer state carried
   over with ``convert.py`` (``wire_ef`` included, nonzero by then), then
   three more steps on each side from the same batches.  Losses to rtol
   1e-5.  Parameters and ``wire_ef`` within one quantization grid step of
   the last pull's delta (its chunk's scale, max|e|/127) plus 1e-6: XLA
   compiles the kernel's ``amax / 127`` as ``amax * (1/127)``, an ulp of a
   scale can move an entry of the payload by one step, and the residual
   then holds the step the parameters lack (the sum p + wire_ef is what
   the error feedback keeps).  The reference's own ``check_client.py``
   wire case allows one grid step for the same reason.  Activations are
   float32; 1e-6 is the parity bound of tests/test_torch_engine.py.
2. W=4 stacked: an int8 run tracks the identity-wire run from the same
   weights: its parameters differ (the wire rounds), by less than 5% of
   how far the identity run moved them in three steps (one grid step is
   1/127 of a chunk's largest entry).
3. The identity wire keeps the pre-wire path: no ``wire_ef`` slot and only
   the rule's kernel; the int8 wire calls the codec and the tail kernels
   as often as the main path on the card must launch them.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS, TrainConfig as JaxTrainConfig, reduced
from repro.core import PHubEngine as JaxEngine
from repro.data import SyntheticTokens as JaxTokens
from repro_torch.configs import TrainConfig, get_arch, reduced as port_reduced
from repro_torch.convert import opt_from_numpy, params_from_numpy
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import flatten_groups
from repro_torch.core.wire import WIRE_EF_SLOT
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import quant
from repro_torch.kernels.agg_opt import LAUNCHES, ops, reset_launches
from repro_torch.optim.protocol import SlotSpec

T, LOSS_CHUNK, W4 = 32, 16, 4
LOSS_RTOL, ATOL = 1e-5, 1e-6
KW = {"nesterov": dict(lr=0.05, momentum=0.9),
      "sgd": dict(lr=0.05),
      "adam": dict(lr=1e-4, adam_eps=1e-3)}     # Lipschitz in g (see
#                                                 test_torch_engine_optim)


def _cfgs():
    jcfg = dataclasses.replace(reduced(ARCHS["llama3.2-1b"], d_model=128),
                               dtype="float32")
    pcfg = dataclasses.replace(port_reduced(get_arch("llama3.2-1b"),
                                            d_model=128), dtype="float32")
    return jcfg, pcfg


def _tc(rule, wire="int8"):
    return TrainConfig(optimizer=rule, loss_chunk=LOSS_CHUNK,
                       wire_format=wire, **KW[rule])


def _jax_w1(rule, steps=4):
    """The JAX engine's run: (state after step 0, losses of the later
    steps, final params, final opt)."""
    jcfg, _ = _cfgs()
    jtc = JaxTrainConfig(optimizer=rule, loss_chunk=LOSS_CHUNK,
                         use_pallas=True, wire_format="int8", **KW[rule])
    jeng = JaxEngine(cfg=jcfg, tc=jtc, mesh=jax.make_mesh((1, 1),
                                                          ("data", "model")))
    params, opt = jeng.init_state(jax.random.PRNGKey(0))
    jdata = JaxTokens(jcfg, 4, T, seed=2)
    shapes = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in jdata.batch_at(0).items()}
    jstep = jeng.make_train_step(shapes)
    params, opt, _ = jstep(params, opt, jdata.device_batch(0))
    carried = jax.device_get(params), jax.device_get(opt)
    losses = []
    for i in range(1, steps):
        params, opt, jm = jstep(params, opt, jdata.device_batch(i))
        losses.append(float(jm["loss"]))
    return carried, losses, jax.device_get(params), jax.device_get(opt)


@pytest.fixture(scope="module")
def jax_nesterov_w1():
    return _jax_w1("nesterov")


def test_opt_from_numpy_carries_the_jax_int8_state_bitwise(jax_nesterov_w1):
    (_, jopt), _, _, _ = jax_nesterov_w1
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc("nesterov"), StackedComm(1), device="cpu")
    assert [s.name for s in peng.exchange_slots] == ["m", WIRE_EF_SLOT]
    popt = opt_from_numpy(peng.chunk_plan, jopt,
                          slots=peng.exchange_slots, device="cpu")
    for key, slots in jopt.items():
        assert list(popt[key]) == list(slots)
        for name, a in slots.items():
            t = popt[key][name]
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy().reshape(-1),
                                          np.asarray(a).reshape(-1))
    assert np.abs(jopt["float32"][WIRE_EF_SLOT]).max() > 0
    # a state without the residual is not the int8 engine's
    with pytest.raises(ValueError, match="slots"):
        opt_from_numpy(peng.chunk_plan,
                       {"float32": {"m": jopt["float32"]["m"]}},
                       slots=peng.exchange_slots, device="cpu")


def test_opt_from_numpy_keeps_wire_ef_f32_in_a_bf16_group():
    import jax.numpy as jnp
    from repro_torch.core.chunking import build_plan
    tree = {"a": torch.zeros(3, 5, dtype=torch.bfloat16),
            "b": torch.zeros(7)}
    plan = build_plan(tree, chunk_bytes=64, n_shards=2)
    rng = np.random.default_rng(0)
    ref = {}
    for g in plan.groups:
        jdt = jnp.bfloat16 if g.dtype == torch.bfloat16 else jnp.float32
        draw = lambda dt: np.asarray(jnp.asarray(rng.standard_normal(
            (1, 2, g.shard_len)).astype(np.float32)).astype(dt))
        ref[g.key] = {"m": draw(jdt), WIRE_EF_SLOT: draw(jnp.float32)}
    specs = (SlotSpec("m"), SlotSpec(WIRE_EF_SLOT, "float32"))
    out = opt_from_numpy(plan, ref, slots=specs, device="cpu")
    for g in plan.groups:
        assert out[g.key][WIRE_EF_SLOT].dtype == torch.float32
        assert out[g.key]["m"].dtype == g.dtype
        for n, t in out[g.key].items():
            np.testing.assert_array_equal(
                t.float().numpy(),
                ref[g.key][n].astype(np.float32).reshape(2, -1))


def _flat(engine, tree):
    (flat,) = flatten_groups(engine.chunk_plan, tree).values()
    return flat.detach().clone()


@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
def test_w1_int8_steps_match_jax_engine_within_a_grid_step(rule,
                                                           jax_nesterov_w1):
    carried, jlosses, jparams, jopt = (jax_nesterov_w1 if rule == "nesterov"
                                       else _jax_w1(rule))
    _, pcfg = _cfgs()
    peng = PHubEngine(pcfg, _tc(rule), StackedComm(1), device="cpu")
    model = params_from_numpy(pcfg, carried[0], device="cpu")
    popt = opt_from_numpy(peng.chunk_plan, carried[1],
                          slots=peng.exchange_slots, device="cpu")
    pstep = peng.make_train_step()
    pdata = SyntheticTokens(pcfg, 4, T, seed=2)
    reset_launches()
    losses = []
    for i in range(1, 4):
        p_prev = _flat(peng, model.param_tree())
        model, popt, pm = pstep(model, popt, pdata.torch_batch(i, "cpu"))
        losses.append(float(pm["loss"]))
    assert all(c == 0 for c in LAUNCHES.values())
    np.testing.assert_allclose(losses, jlosses, rtol=LOSS_RTOL)

    (group,) = peng.chunk_plan.groups
    ce = group.chunk_elems
    p_new = _flat(peng, model.param_tree())
    ef = popt["float32"][WIRE_EF_SLOT].reshape(-1)
    # the last pull's e = decode(payload) + wire_ef', and decode(payload)
    # = p_new - p_prev up to one f32 rounding
    e = (p_new - p_prev) + ef
    grid = (e.view(-1, ce).abs().amax(1) / 127).repeat_interleave(ce)
    bound = grid + ATOL
    jflat = _flat(peng, params_from_numpy(pcfg, jparams,
                                          device="cpu").param_tree())
    jef = torch.from_numpy(np.array(jopt["float32"][WIRE_EF_SLOT])
                           .reshape(-1))
    assert bool(((p_new - jflat).abs() <= bound).all())
    assert bool(((ef - jef).abs() <= bound).all())
    assert float(ef.abs().max()) > 0


def test_w4_int8_run_tracks_the_identity_run():
    _, pcfg = _cfgs()
    data = SyntheticTokens(pcfg, 8, T, seed=4)
    init = None
    flats = {}
    for wire in ("identity", "int8"):
        eng = PHubEngine(pcfg, _tc("nesterov", wire), StackedComm(W4),
                         device="cpu")
        model, opt = eng.init_state(seed=1)
        if init is None:
            init = _flat(eng, model.param_tree())
        step = eng.make_train_step()
        for i in range(3):
            model, opt, met = step(model, opt, data.torch_batch(i, "cpu"))
            assert np.isfinite(float(met["loss"]))
        flats[wire] = _flat(eng, model.param_tree())
        assert (WIRE_EF_SLOT in opt["float32"]) == (wire == "int8")
    moved = float((flats["identity"] - init).abs().max())
    err = float((flats["int8"] - flats["identity"]).abs().max())
    assert 0 < err < 0.05 * moved, (err, moved)


def _count_calls(monkeypatch):
    """Count calls of the kernel wrappers (their plain versions run on the
    CPU, so LAUNCHES stays 0 there)."""
    calls = {}

    def counting(module, name):
        fn = getattr(module, name)

        def wrapped(*a, **k):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **k)
        monkeypatch.setattr(module, name, wrapped)

    for name in ("fused_agg_opt", "fused_multi_agg_opt", "fused_sgd_opt",
                 "fused_adam_opt", "fused_dequant_agg_opt"):
        counting(ops, name)
    for name in ("quantize_int8", "dequantize_int8"):
        counting(quant.ops, name)
    return calls


# the calls of one step: what chip_smoke.py's main paths expect of the
# kernels' launch counts on the card
EXPECTED = {
    ("identity", "nesterov", 4): {"fused_multi_agg_opt": 1},
    ("identity", "nesterov", 1): {"fused_agg_opt": 1},
    ("int8", "nesterov", 4): {"quantize_int8": 4, "dequantize_int8": 3,
                              "fused_dequant_agg_opt": 1},
    ("int8", "nesterov", 1): {"quantize_int8": 1, "dequantize_int8": 1,
                              "fused_agg_opt": 1},
    ("int8", "sgd", 4): {"quantize_int8": 4, "dequantize_int8": 4,
                         "fused_sgd_opt": 1},
    ("int8", "adam", 4): {"quantize_int8": 4, "dequantize_int8": 4,
                          "fused_adam_opt": 1},
    ("int8", "adam", 1): {"quantize_int8": 1, "dequantize_int8": 1,
                          "fused_adam_opt": 1},
}


@pytest.mark.parametrize("wire,rule,W", sorted(EXPECTED))
def test_one_step_calls_each_kernel_as_the_card_must(wire, rule, W,
                                                     monkeypatch):
    _, pcfg = _cfgs()
    eng = PHubEngine(pcfg, _tc(rule, wire), StackedComm(W), device="cpu")
    names = [s.name for s in eng.exchange_slots]
    want_slots = list(eng.sopt.slot_names) + (
        [WIRE_EF_SLOT] if wire != "identity" else [])
    assert names == want_slots
    model, opt = eng.init_state()
    assert list(opt["float32"]) == want_slots
    calls = _count_calls(monkeypatch)
    data = SyntheticTokens(pcfg, 8, T, seed=0)
    _, opt, _ = eng.make_train_step()(model, opt, data.torch_batch(0, "cpu"))
    assert calls == EXPECTED[wire, rule, W]
    assert list(opt["float32"]) == want_slots
