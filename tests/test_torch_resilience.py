"""The port's self-healing machinery against the JAX package's, on the CPU.

- ``HealthTracker`` fed the same (ok, norms) sequences gives the
  reference's ``norm_hi`` and offense counts, exactly.
- ``FaultSchedule.seeded`` / ``ChaosSchedule.seeded`` give the reference's
  events for the same seeds, and the same injection vectors and
  memberships step by step; ``Membership`` transitions (demotion
  included) give the reference's masks and keys.
- The watchdog absorbs faults within budget, names the worker on
  exhaustion, backs off as the reference does (seeded, capped) and records
  a deadline overrun without re-dispatching.
- Checkpoints: the two-phase write, truncation and bit flips caught by
  name, ``keep_k`` pruning, ``restore_latest_valid`` skipping corrupt
  snapshots, restoring in place; a snapshot written by the port passes
  the reference's ``verify_checkpoint`` and its ``load_checkpoint`` reads
  it bitwise, and a snapshot the reference wrote loads into the port
  bitwise (f32 and bf16).
- The launcher's flag rules equal the reference's, and ``--chaos-faults``
  implies ``--supervise``.

Every comparison here is exact: the modules are numpy or host code.
"""
import itertools
import math
import os

import numpy as np
import pytest
import torch

import repro.checkpoint as ref_ckpt
import repro.elastic as ref_elastic
from repro.launch.train import resolve_mode_flags as ref_resolve
from repro.resilience import (ExchangeWatchdog as RefWatchdog,
                              HealthTracker as RefTracker,
                              SanityConfig as RefSanity,
                              TransientExchangeError as RefTransient,
                              WatchdogConfig as RefWatchdogConfig)
from repro_torch.checkpoint import (CheckpointCorruptError, CheckpointError,
                                    checkpoint_steps, latest_step,
                                    load_checkpoint, load_manifest,
                                    prune_checkpoints, restore_latest_valid,
                                    restore_train_state, save_checkpoint,
                                    verify_checkpoint)
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.elastic import (FAULT_KINDS, ChaosSchedule, FaultEvent,
                                 FaultSchedule, Membership, NAN_PUSH, STALL,
                                 corrupt_checkpoint)
from repro_torch.launch.train import main, resolve_mode_flags
from repro_torch.resilience import (ExchangeTimeout, ExchangeWatchdog,
                                    HealthTracker, SanityConfig,
                                    TransientExchangeError, WatchdogConfig,
                                    WatchdogExhausted)
from repro_torch.training import TrainState, fit


# ---------------------------------------------------------- health tracker

@pytest.mark.parametrize("seed", range(4))
def test_tracker_matches_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(norm_factor=4.0, warmup=3, window=5, norm_floor=1e-3)
    port, ref = (HealthTracker(SanityConfig(**kw), 4),
                 RefTracker(RefSanity(**kw), 4))
    live = np.ones(4)
    for step in range(30):
        ok = (rng.random(4) > 0.3).astype(np.float64)
        norms = rng.lognormal(size=4)
        norms[rng.random(4) < 0.1] = np.nan
        if step == 12:
            live = np.array([1, 1, 0, 1.0])
        for t in (port, ref):
            t.observe(ok, norms, live_mask=live)
        assert port.norm_hi() == ref.norm_hi()
        assert port.offenses.tolist() == ref.offenses.tolist()
        assert port.repeat_offenders(2) == ref.repeat_offenders(2)
        if step == 20:
            for t in (port, ref):
                t.reset_rank(1)
                t.reset_history()


def test_tracker_offense_streaks_and_resets():
    t = HealthTracker(SanityConfig(), world=4)
    bad1 = np.array([1, 0, 1, 1.0])
    t.observe(bad1, np.ones(4))
    t.observe(bad1, np.ones(4))
    assert t.repeat_offenders(2) == [1]
    t.observe(np.ones(4), np.ones(4))
    assert t.repeat_offenders(1) == []
    t.observe(np.array([1, 0, 1, 0.0]), np.ones(4),
              live_mask=np.array([1, 1, 1, 0.0]))
    assert t.repeat_offenders(1) == [1]
    t.reset_offenses()
    assert t.repeat_offenders(1) == []


# ---------------------------------------------- schedules and membership

@pytest.mark.parametrize("seed,world", [(0, 4), (3, 8), (7, 4), (11, 2)])
def test_fault_schedule_is_the_reference_schedule(seed, world):
    port = FaultSchedule.seeded(seed=seed, world=world, steps=40)
    ref = ref_elastic.FaultSchedule.seeded(seed=seed, world=world, steps=40)
    assert [tuple(vars(e).values()) for e in port.events] == \
        [tuple(vars(e).values()) for e in ref.events]
    assert {e.kind for e in port.events} <= set(FAULT_KINDS)
    for step in range(40):
        a, b = port.inject_vector(step), ref.inject_vector(step)
        np.testing.assert_array_equal(a, b)
        assert len(port.io_faults_at(step)) == len(ref.io_faults_at(step))
        assert len(port.stalls_at(step)) == len(ref.stalls_at(step))


@pytest.mark.parametrize("seed,world", [(0, 4), (7, 8), (2, 3)])
def test_chaos_schedule_is_the_reference_schedule(seed, world):
    port = ChaosSchedule.seeded(seed=seed, world=world, steps=60,
                                event_every=3)
    ref = ref_elastic.ChaosSchedule.seeded(seed=seed, world=world, steps=60,
                                           event_every=3)
    assert [tuple(vars(e).values()) for e in port.events] == \
        [tuple(vars(e).values()) for e in ref.events]
    m, r = Membership.full(world), ref_elastic.Membership.full(world)
    for step in range(60):
        m, r = port.apply(m, step), ref.apply(r, step)
        assert m.signature() == r.signature()
        assert m.program_key() == r.program_key()
        np.testing.assert_array_equal(m.mask(), r.mask())
        np.testing.assert_array_equal(port.latency_factors(step),
                                      ref.latency_factors(step))


def test_fault_schedule_one_shot_consumption_and_reset():
    fs = FaultSchedule([FaultEvent(step=2, kind=NAN_PUSH, worker=1,
                                   duration=2)], world=4)
    v = fs.inject_vector(2)
    assert math.isnan(v[1]) and v[[0, 2, 3]].tolist() == [1, 1, 1]
    assert math.isnan(fs.inject_vector(3)[1])
    assert np.all(fs.inject_vector(2) == 1.0)
    fs.reset()
    assert math.isnan(fs.inject_vector(2)[1])
    stalls = FaultSchedule([FaultEvent(1, STALL, 2, magnitude=3)], world=4)
    assert len(stalls.stalls_at(1)) == 1 and len(stalls.stalls_at(1)) == 0


def test_membership_demote_escalates_as_the_reference():
    port, ref = Membership.full(4, min_live=2), \
        ref_elastic.Membership.full(4, min_live=2)
    for op, args in (("demote", (2,)), ("demote", (2,)), ("demote", (0,)),
                     ("mark_recovered", (0,)), ("join", (2,)),
                     ("leave", (3,))):
        port, ref = getattr(port, op)(*args), getattr(ref, op)(*args)
        assert port.signature() == ref.signature()
        assert port.n_live == ref.n_live
        assert [w.status for w in port.workers] == \
            [w.status for w in ref.workers]
    with pytest.raises(ValueError, match="nothing to demote"):
        port.demote(3)
    with pytest.raises(RuntimeError, match="quorum"):
        port.leave(0).leave(1)
    with pytest.raises(RuntimeError, match="quorum"):
        Membership.full(2, min_live=2).leave(0)
    port.validate_world(4)
    with pytest.raises(ValueError, match="worker positions"):
        port.validate_world(3)


# --------------------------------------------------------------- watchdog

def test_watchdog_absorbs_faults_within_budget():
    wd = ExchangeWatchdog(WatchdogConfig(retries=3, backoff_base_s=0.0))
    wd.inject_fault(TransientExchangeError(), attempts=2)
    assert wd.run(lambda: 42) == 42
    assert wd.total_retries == 2 and wd.pending_faults() == 0


def test_watchdog_exhaustion_names_the_worker():
    wd = ExchangeWatchdog(WatchdogConfig(retries=1, backoff_base_s=0.0))
    wd.inject_fault(ExchangeTimeout(worker=5), attempts=3)
    with pytest.raises(WatchdogExhausted) as ei:
        wd.run(lambda: 42)
    assert ei.value.worker == 5
    assert wd.pending_faults() == 1
    assert wd.drop_faults(5) == 1
    assert wd.run(lambda: 42) == 42


def test_watchdog_backoff_is_seeded_capped_and_the_reference_one():
    cfg = dict(retries=3, backoff_base_s=1e-9, backoff_cap_s=5e-9,
               jitter=0.5, seed=7)
    port = ExchangeWatchdog(WatchdogConfig(**cfg))
    ref = RefWatchdog(RefWatchdogConfig(**cfg))
    port.inject_fault(TransientExchangeError(), attempts=3)
    ref.inject_fault(RefTransient(), attempts=3)
    port.run(lambda: None)
    ref.run(lambda: None)
    assert port.last_delays == ref.last_delays
    assert len(port.last_delays) == 3
    assert all(d <= 5e-9 * 1.5 for d in port.last_delays)


def test_watchdog_overrun_recorded_not_retried():
    wd = ExchangeWatchdog(WatchdogConfig(deadline_s=0.0, retries=3))
    calls = []
    out = wd.run(lambda: calls.append(1) or (torch.ones(3), {"x": 1}))
    assert len(calls) == 1 and len(wd.overruns) == 1
    assert out[0].tolist() == [1, 1, 1]


# ---------------------------------------------------- durable checkpoints

def _tree(seed=0, n=37):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.normal(size=(n, 5)).astype(np.float32),
                       "b": rng.normal(size=(n,)).astype(np.float32)},
            "opt": {"w": {"m": rng.normal(size=(n, 5)).astype(np.float32)},
                    "b": {"m": rng.normal(size=(n,)).astype(np.float32)}}}


def _torch_tree(seed=0):
    t = _tree(seed)
    return {"params": {k: torch.from_numpy(v) for k, v in
                       t["params"].items()},
            "opt": {"bf": torch.from_numpy(t["opt"]["w"]["m"]).bfloat16(),
                    "i": torch.arange(6, dtype=torch.int32)}}


def test_checkpoint_two_phase_and_verify_roundtrip(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 3, _torch_tree())
    assert verify_checkpoint(d, 3)["step"] == 3
    assert latest_step(d) == 3
    assert not [f for f in os.listdir(d) if f.startswith(".tmp")]
    s, tree = load_checkpoint(d)
    assert s == 3
    ref = _torch_tree()
    for (pa, a), (pb, b) in zip(leaf_paths(tree), leaf_paths(ref)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b)
    assert load_manifest(d)["dtypes"]["opt/bf"] == "bfloat16"


def test_checkpoint_truncation_bitflips_and_half_writes(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree())
    corrupt_checkpoint(d, 1, mode="truncate")
    with pytest.raises(CheckpointCorruptError):
        verify_checkpoint(d, 1)
    with pytest.raises(CheckpointCorruptError):
        load_checkpoint(d, 1)
    for seed in range(6):
        save_checkpoint(d, 2, _tree(seed))
        corrupt_checkpoint(d, 2, mode="bitflip", seed=seed)
        try:
            verify_checkpoint(d, 2)
        except CheckpointCorruptError:
            continue
        # a flip in dead bytes must leave the content bitwise the same
        _, tree = load_checkpoint(d, 2)
        np.testing.assert_array_equal(tree["params"]["w"].numpy(),
                                      _tree(seed)["params"]["w"])
    save_checkpoint(d, 4, _tree())
    os.remove(os.path.join(d, "step_00000004", "manifest.json"))
    with pytest.raises(CheckpointCorruptError, match="half-written"):
        verify_checkpoint(d, 4)


def test_checkpoint_keep_k_pruning_and_corrupt_skip(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        save_checkpoint(d, s, _tree(s))
    save_checkpoint(d, 4, _tree(4), keep_k=2)
    assert checkpoint_steps(d) == [3, 4]
    with pytest.raises(ValueError):
        prune_checkpoints(d, 0)
    corrupt_checkpoint(d, 4, mode="truncate")
    step, params, opt, skipped = restore_latest_valid(d, None)
    assert step == 3 and skipped == [4]
    np.testing.assert_array_equal(params["w"].numpy(),
                                  _tree(3)["params"]["w"])
    corrupt_checkpoint(d, 3, mode="truncate")
    with pytest.raises(CheckpointError):
        restore_latest_valid(d, None)


def test_port_snapshot_is_a_reference_snapshot(tmp_path):
    d = str(tmp_path)
    tree = _torch_tree(5)
    save_checkpoint(d, 7, tree, membership=Membership.full(4))
    manifest = ref_ckpt.verify_checkpoint(d, 7)
    assert manifest["membership"] == {"epoch": 0, "world": 4}
    step, got = ref_ckpt.load_checkpoint(d, 7)
    assert step == 7
    np.testing.assert_array_equal(got["params"]["w"],
                                  tree["params"]["w"].numpy())
    assert np.asarray(got["opt"]["bf"]).tobytes() == \
        tree["opt"]["bf"].view(torch.int16).numpy().tobytes()
    corrupt_checkpoint(d, 7, mode="truncate")
    with pytest.raises(ref_ckpt.CheckpointCorruptError):
        ref_ckpt.verify_checkpoint(d, 7)


def test_reference_snapshot_loads_into_the_port(tmp_path):
    import ml_dtypes
    d = str(tmp_path)
    tree = _tree(6)
    tree["opt"]["bf"] = tree["params"]["w"].astype(ml_dtypes.bfloat16)
    ref_ckpt.save_checkpoint(d, 2, tree, keep_k=1)
    assert verify_checkpoint(d, 2)["step"] == 2
    _, got = load_checkpoint(d, 2)
    np.testing.assert_array_equal(got["opt"]["w"]["m"].numpy(),
                                  tree["opt"]["w"]["m"])
    assert got["opt"]["bf"].dtype == torch.bfloat16
    assert got["opt"]["bf"].view(torch.int16).numpy().tobytes() == \
        tree["opt"]["bf"].tobytes()


def _engine(rule="adam", W=2, wire="identity"):
    cfg = reduced(get_arch("llama3.2-1b"), d_model=64)
    return PHubEngine(cfg, TrainConfig(optimizer=rule, loss_chunk=16,
                                       wire_format=wire),
                      StackedComm(W), device="cpu")


def test_restore_train_state_in_place_bitwise(tmp_path):
    d = str(tmp_path)
    eng = _engine()
    model, opt = eng.init_state(seed=1)
    for g in opt.values():
        for t in g.values():
            t.uniform_()
    save_checkpoint(d, 5, {"params": model.param_tree(), "opt": opt},
                    membership=Membership.full(2))
    saved = {p: t.detach().clone() for p, t in leaf_paths(model.param_tree())}
    other, _ = eng.init_state(seed=2)
    step, back, opt2 = restore_train_state(d, eng, model=other)
    assert step == 5 and back is other
    for p, t in leaf_paths(other.param_tree()):
        assert torch.equal(t.detach(), saved[p])
    for k, slots in opt.items():
        assert list(opt2[k]) == list(slots)
        for n, t in slots.items():
            assert torch.equal(opt2[k][n], t) and opt2[k][n] is not t
    _, fresh, _ = restore_train_state(d, eng)
    for p, t in leaf_paths(fresh.param_tree()):
        assert torch.equal(t.detach(), saved[p])
    # membership drift at the same world is refused; an override is not
    with pytest.raises(ValueError, match="epoch"):
        restore_train_state(d, eng, membership=Membership.full(2).leave(1))
    # another optimizer's slots are refused by name
    with pytest.raises(ValueError, match="opt slot"):
        restore_train_state(d, _engine(rule="nesterov"))
    # the encoded wire's residual: added as zeros, dropped on the way back
    _, _, o8 = restore_train_state(d, _engine(wire="int8"))
    assert not o8["float32"]["wire_ef"].any()
    save_checkpoint(d, 6, {"params": model.param_tree(), "opt": o8})
    _, _, o1 = restore_train_state(d, eng, step=6)
    assert list(o1["float32"]) == ["m", "v", "k1", "k2"]
    with pytest.raises(ValueError, match="world size"):
        restore_train_state(d, _engine(W=4), step=5)


# ----------------------------------------------------- loop and launcher

def test_fit_supervisor_owns_membership_and_checkpoints():
    with pytest.raises(ValueError, match="owns membership"):
        fit(None, TrainState(params=None, opt=None), None, steps=1,
            checkpoint_dir="/nonexistent", supervisor=object())


def test_fit_checkpoints_and_follows_the_membership(tmp_path):
    eng = _engine(rule="nesterov", W=4)
    model, opt = eng.init_state()
    from repro_torch.data import SyntheticTokens
    data = SyntheticTokens(eng.cfg, 4, 16, seed=0)
    full = Membership.full(4)
    ms = {0: full, 1: full.leave(2), 2: full.leave(2).join(2).leave(2)}
    seen = []
    fit(eng, TrainState(params=model, opt=opt), data, steps=3, log_every=0,
        membership_fn=lambda i: seen.append(i) or ms[i],
        checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert seen == [0, 1, 2]
    assert checkpoint_steps(str(tmp_path)) == [2]
    assert load_manifest(str(tmp_path))["membership"]["epoch"] == 1


@pytest.mark.parametrize(
    "flags", list(itertools.product([False, True], repeat=4)))
def test_mode_flags_are_the_reference_rules(flags):
    try:
        want = ref_resolve(*flags)
    except SystemExit as e:
        with pytest.raises(SystemExit) as ei:
            resolve_mode_flags(*flags)
        assert str(ei.value) == str(e)
        return
    assert resolve_mode_flags(*flags) == want


def test_launcher_chaos_faults_imply_supervise(tmp_path, capsys):
    losses = main(["--reduced", "--device", "cpu", "--steps", "7",
                   "--batch", "4", "--seq", "16", "--workers", "4",
                   "--chaos-faults", "--chaos-every", "2",
                   "--checkpoint-dir", str(tmp_path / "ck"),
                   "--checkpoint-every", "1", "--keep-k", "2"])
    out = capsys.readouterr().out
    assert "[train] supervised: world=4 keep_k=2" in out
    assert "push_masked" in out and "demote" in out
    assert len(losses) == 7 and np.isfinite(losses).all()
    assert len(checkpoint_steps(str(tmp_path / "ck"))) == 2
    losses = main(["--reduced", "--device", "cpu", "--steps", "4",
                   "--batch", "4", "--seq", "16", "--workers", "4",
                   "--chaos", "--chaos-every", "1"])
    assert "membership epoch" in capsys.readouterr().out
    assert len(losses) == 4 and np.isfinite(losses).all()
    with pytest.raises(SystemExit, match="--chaos-faults"):
        main(["--reduced", "--device", "cpu", "--chaos-faults", "--chaos"])
