"""The port's topology calibration (``repro_torch/tuning/calibrate.py``)
against the JAX package's.

The solver is host arithmetic over the cost model, so on the same probe
record and the same explicit base topology both packages give the same
constants, tolerance and residuals exactly.  The probe records are
planted: each flavor's time is the model's own prediction under a target
topology (the solver must then recover the target), or bent (a
latency-dominated probe, a spread of reps).  The probes themselves run on
the CPU at a tiny size and must return the reference's record schema and
chunk geometry.  The topologies here are illustrative values, no
calibration of any device.
"""
import dataclasses
import importlib
import json

import jax
import pytest
import torch

from repro.core import cost_model as ref_cost
from repro_torch import telemetry
from repro_torch.core import StackedComm
from repro_torch.core.cost_model import RackTopology

# the modules (each package's ``tuning`` exports a function of this name)
ref = importlib.import_module("repro.tuning.calibrate")
port = importlib.import_module("repro_torch.tuning.calibrate")

BASE = dict(n_workers_per_rack=4, n_racks=1, bw_worker=20e9, bw_pbox=20e9,
            bw_core=20e9, lat_ici=2e-5, lat_dcn=4e-5)
GROUPS = [{"padded": 1 << 21, "shard_len": 1 << 19, "chunk_elems": 8192,
           "n_shards": 4, "dtype": "float32"}]


@pytest.fixture(autouse=True)
def _null_telemetry():
    yield
    telemetry.disable()


def _bases(**kw):
    return (RackTopology(**{**BASE, **kw}),
            ref_cost.RackTopology(**{**BASE, **kw}))


def synth_probe(target_kw, n=4):
    """A probe record whose timings are the reference model's predictions
    under ``BASE`` with ``target_kw``."""
    topo = ref_cost.RackTopology(**{**BASE, **target_kw})
    flavors = {}
    for fl in ref.PROBE_FLAVORS:
        t = ref._predict(fl, {"groups": GROUPS}, n, topo)["seconds"]
        flavors[fl] = {"us": t * 1e6, "us_reps": [t * 1e6] * 3,
                       "groups": GROUPS}
    return {"devices": n, "elems": GROUPS[0]["padded"], "chunk_kb": 32,
            "flavors": flavors}


def _same(a: dict, b: dict) -> None:
    assert a["constants"] == b["constants"]
    assert a["tolerance"] == b["tolerance"]
    assert a["residuals"] == b["residuals"]
    assert dataclasses.asdict(a["topology"]) == \
        dataclasses.asdict(b["topology"])


TARGETS = [dict(bw_ici=2e9, allreduce_factor=1.5, bw_codec=3e9),
           dict(bw_ici=7e11, allreduce_factor=2.0, bw_codec=9e11),
           dict(bw_ici=5e10, allreduce_factor=1.0, bw_codec=None)]


@pytest.mark.parametrize("target", TARGETS, ids=["slow", "fast", "free"])
def test_predictions_equal_the_reference(target):
    topo_p, topo_r = _bases(**target)
    for fl in port.PROBE_FLAVORS:
        assert port._predict(fl, {"groups": GROUPS}, 4, topo_p) == \
            ref._predict(fl, {"groups": GROUPS}, 4, topo_r)


@pytest.mark.parametrize("target", TARGETS[:2], ids=["slow", "fast"])
def test_solver_recovers_the_planted_constants_as_the_reference(target):
    probe = synth_probe(target)
    base_p, base_r = _bases()
    out = port.solve_topology(probe, base_p)
    _same(out, ref.solve_topology(probe, base_r))
    c = out["constants"]
    assert c["bw_ici"] == pytest.approx(target["bw_ici"], rel=1e-3)
    assert c["allreduce_factor"] == pytest.approx(
        target["allreduce_factor"], rel=1e-3)
    assert c["bw_codec"] == pytest.approx(target["bw_codec"], rel=1e-2)
    for r in out["residuals"].values():
        assert r["rel_err"] < 1e-6
    assert out["tolerance"] == port.MIN_TOLERANCE
    assert out["base"] == base_p and out["probe"] is probe


def test_solver_clamps_absurd_fits_as_the_reference():
    probe = synth_probe(TARGETS[0])
    for fl in port.PROBE_FLAVORS:
        probe["flavors"][fl]["us"] = 1.0
        probe["flavors"][fl]["us_reps"] = [1.0] * 3
    base_p, base_r = _bases()
    out = port.solve_topology(probe, base_p)
    _same(out, ref.solve_topology(probe, base_r))
    assert out["constants"]["bw_ici"] <= 1e13
    assert 1.0 <= out["constants"]["allreduce_factor"] <= 4.0
    assert out["tolerance"] > port.MIN_TOLERANCE


def test_tolerance_widens_with_rep_spread_as_the_reference():
    probe = synth_probe(TARGETS[0])
    us = probe["flavors"]["ring"]["us"]
    probe["flavors"]["ring"]["us_reps"] = [us * 0.7, us, us * 1.3]
    base_p, base_r = _bases(lat_ici=0.0, lat_dcn=0.0)
    out = port.solve_topology(probe, base_p)
    _same(out, ref.solve_topology(probe, base_r))
    assert out["tolerance"] >= 2.0 * 0.6 - 1e-9


def test_solver_needs_a_base():
    with pytest.raises(ValueError, match="no default topology"):
        port.solve_topology(synth_probe(TARGETS[0]), None)
    with pytest.raises(TypeError):
        port.solve_topology(synth_probe(TARGETS[0]))


def test_calibrate_takes_an_injected_runner():
    probe = synth_probe(TARGETS[0])
    base_p, _ = _bases()
    out = port.calibrate(StackedComm(4), base=base_p, runner=lambda: probe)
    _same(out, port.solve_topology(probe, base_p))


def test_calibration_save_load_round_trip(tmp_path):
    base_p, base_r = _bases()
    out = port.solve_topology(synth_probe(TARGETS[0]), base_p)
    out["anchor_scale"] = 1.25
    out["card"] = "card A"
    path = port.save_calibration(out, str(tmp_path / "cal.json"))
    rec = json.load(open(path))
    ref_out = ref.solve_topology(synth_probe(TARGETS[0]), base_r)
    ref_out["anchor_scale"] = 1.25
    want = ref.calibration_record(ref_out)
    assert {k: rec[k] for k in want} == json.loads(json.dumps(want))
    assert rec["card"] == "card A" and rec["base"] == dataclasses.asdict(
        base_p)
    topo, tol = port.load_calibration(path)
    assert tol == out["tolerance"] and topo == out["topology"]
    assert port.load_calibration(path, card="card A") == (topo, tol)
    assert port.load_calibration(path, card="card B") == (None, None)
    assert port.load_calibration(str(tmp_path / "no.json")) == (None, None)
    # the reference reads the port's record too
    assert ref.load_calibration(path)[1] == tol


@pytest.mark.parametrize("W,pods", [(4, 1), (4, 2), (1, 1)])
def test_card_base_topology_comes_from_the_comm(W, pods):
    base = port.card_base_topology(StackedComm(W, pods))
    assert (base.n_workers_per_rack, base.n_racks) == (W // pods, pods)
    assert base.lat_ici == base.lat_dcn == 0.0
    assert base.bw_pbox == base.bw_core == base.bw_worker == \
        port.H100_HBM_BYTES_PER_S == 3.35e12
    assert base.bw_ici is None and base.bw_codec is None


def test_probe_on_the_cpu_returns_the_reference_schema():
    elems = 3 * 8192 + 100                # a ragged last chunk
    got = port.run_probe_programs(StackedComm(1), elems=elems, reps=3,
                                  warmup=1, device="cpu")
    want = ref.run_probe_programs(1, elems=elems, reps=3, warmup=1)
    assert got.keys() == want.keys()
    assert {k: got[k] for k in ("devices", "elems", "chunk_kb")} == \
        {k: want[k] for k in ("devices", "elems", "chunk_kb")}
    for fl in port.PROBE_FLAVORS:
        g, w = got["flavors"][fl], want["flavors"][fl]
        assert g.keys() == w.keys()
        assert g["groups"] == w["groups"]
        assert len(g["us_reps"]) == 3 and g["us_reps"] == sorted(
            g["us_reps"]) and g["us"] == g["us_reps"][1] > 0
    four = port.run_probe_programs(StackedComm(4), elems=elems, reps=1,
                                   warmup=0, device="cpu")
    assert four["devices"] == 4
    assert four["flavors"]["ring"]["groups"][0]["n_shards"] == 4
    assert four["flavors"]["allreduce"]["groups"][0]["n_shards"] == 1
    # the solver takes the record as it comes
    out = port.solve_topology(four, port.card_base_topology(StackedComm(4)))
    assert out["tolerance"] >= port.MIN_TOLERANCE
    assert all(torch.isfinite(torch.tensor(v)) for v in
               out["constants"].values())
    assert jax.device_count() == 1
