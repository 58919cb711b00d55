"""The port's exchange autotuner (``repro_torch/tuning/``) against the
reference's (``repro/tuning/``), on the CPU.

1. Space: ``enumerate_space(n)`` for n = 2..8 is the reference's, in its
   order; ``valid``, ``mesh_shapes``, ``Candidate`` round trips and
   ``tc_kwargs`` match.
2. Cost: on reduced llama3.2-1b (d_model 256) and on ``tests/
   test_tuning.py``'s ``LIKE``, at n = 4 and 8, with the reference's
   ``DEFAULT_TOPOLOGY`` constants built here as a port ``RackTopology``
   (the port keeps none), every prediction equals the reference's to rel
   1e-12, and the ranked order and the dropped candidates are the same;
   the reference's committed 8-device sweep (``results/tuning/
   8252aff8fe53f225.json``, read only) comes back to 1e-9; ranking
   without a topology raises.
3. Cache: round trip, lint distrust, a corrupt file, and "the key tracks
   the request, not the winner"; the port's key for the reference's own
   request is not the reference's, and differs between "cpu" and a card.
4. Flow: ``autotune`` with ``tests/test_tuning.py``'s fake timer and
   linter gives the reference's winner, leaderboard, ``rejected``,
   ``timed_candidates`` and appended incumbent; a cache hit times
   nothing; ``force``; every candidate rejected fails closed with the
   cache left empty; timing failures are skipped; the report is JSON.
5. One real ``time_candidate`` at W=2 on a tiny model (nothing asserts a
   time).

Every cache lives in ``tmp_path``; the reference's tuner runs only with
injected fakes (no subprocess), and no reference module that sets
``XLA_FLAGS`` is imported.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import TrainConfig as RefTC
from repro.launch.tune import model_grads_like as ref_grads_like
from repro.tuning import autotune as ref_autotune
from repro.tuning import cache_key as ref_cache_key
from repro.tuning import enumerate_space as ref_space
from repro.tuning import mesh_shapes as ref_mesh_shapes
from repro.tuning import rank_candidates as ref_rank
from repro.tuning import valid as ref_valid
from repro.tuning.cost import DEFAULT_TOPOLOGY as REF_TOPO
from repro.tuning.cost import predict as ref_predict
from repro.tuning.space import Candidate as RefCandidate

from repro_torch import telemetry
from repro_torch.configs import TrainConfig
from repro_torch.core.cost_model import RackTopology
from repro_torch.launch.tune import model_grads_like
from repro_torch.tuning import (DEFAULT_CACHE_DIR, Candidate, autotune,
                                cache_key, cache_path, enumerate_space,
                                load_cached, mesh_shapes, predict,
                                rank_candidates, store_winner,
                                time_candidate, valid)
from repro_torch.tuning.tuner import _incumbent

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SWEEP = os.path.join(ROOT, "results", "tuning", "8252aff8fe53f225.json")
QUIET = dict(log=lambda *a, **k: None)
CARD = "NVIDIA H100 80GB HBM3"

# tests/test_tuning.py's LIKE and CANDS, in both packages
REF_LIKE = {"w": jax.ShapeDtypeStruct((4096, 16), jnp.float32),
            "b": jax.ShapeDtypeStruct((300,), jnp.float32)}
LIKE = {"w": torch.empty((4096, 16), device="meta"),
        "b": torch.empty((300,), device="meta")}
CAND_ARGS = [("sharded_ps", 1, "identity", None, 32 * 1024, 1, 8),
             ("sharded_ps", 2, "bf16", None, 8 * 1024, 1, 8),
             ("sharded_ps", 2, "int8", None, 8 * 1024, 1, 8),
             ("hierarchical", 2, "identity", "int8", 8 * 1024, 2, 4)]
CANDS = [Candidate(*a) for a in CAND_ARGS]
REF_CANDS = [RefCandidate(*a) for a in CAND_ARGS]


def topo() -> RackTopology:
    """The reference's DEFAULT_TOPOLOGY constants as a port topology."""
    return RackTopology(**dataclasses.asdict(REF_TOPO))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _null_telemetry():
    yield
    telemetry.disable()


def ok_linter(c):
    return {"ok": True, "errors": []}


def bf16_fast(c):
    return 50.0 if c.wire_format == "bf16" else 100.0


def entry_for(c, us=100.0, ok=True):
    return {"candidate": c.to_dict(), "predicted": {"seconds": 1e-4},
            "measured_us": us, "lint": {"ok": ok, "errors": []},
            "devices": 8, "steps": 5, "leaderboard": [], "rejected": []}


# ------------------------------------------------------------------ space

@pytest.mark.parametrize("n", range(2, 9))
def test_space_is_the_references_in_its_order(n):
    assert [c.to_dict() for c in enumerate_space(n)] == \
        [c.to_dict() for c in ref_space(n)]
    assert mesh_shapes(n) == ref_mesh_shapes(n)
    assert len(enumerate_space(4)) == 111


@pytest.mark.parametrize("n", [2, 4, 6, 8])
def test_valid_and_round_trips_match_the_reference(n):
    """``valid`` over the whole unfiltered product (every strategy, the
    baselines included, and wrong layouts), and each candidate's dict,
    ``from_dict`` and ``tc_kwargs``."""
    import itertools
    for st, w, wire, dcn, kb, (p, d) in itertools.product(
            ("allreduce", "sharded_ps", "hierarchical", "centralized_ps"),
            (1, 2, 4), ("identity", "bf16", "int8"), (None, "identity",
                                                      "int8"),
            (8, 32), ((1, n), (2, n // 2), (n, 1), (1, n + 1))):
        args = (st, w, wire, dcn, kb * 1024, p, d)
        assert valid(Candidate(*args), n) == \
            ref_valid(RefCandidate(*args), n), args
    for c, r in zip(enumerate_space(n), ref_space(n)):
        d = c.to_dict()
        assert Candidate.from_dict(d) == c and c.n_workers == r.n_workers
        assert Candidate.from_dict({**d, "wire_format": None}).wire_format \
            == RefCandidate.from_dict({**d, "wire_format": None}).wire_format
        assert c.tc_kwargs() == r.tc_kwargs()
        TrainConfig(**c.tc_kwargs())


# ------------------------------------------------------------------- cost

def _likes(which: str):
    if which == "llama3.2-1b@256":
        return model_grads_like("llama3.2-1b", 256)[1], \
            ref_grads_like("llama3.2-1b", 256)[1]
    return LIKE, REF_LIKE


@pytest.mark.parametrize("which", ["llama3.2-1b@256", "LIKE"])
@pytest.mark.parametrize("n", [4, 8])
def test_predictions_and_ranking_equal_the_references(which, n):
    like, ref_like = _likes(which)
    # a centralized_ps candidate: the cost model refuses it in both
    extra = ("centralized_ps", 1, "identity", None, 32 * 1024, 1, n)
    cands = enumerate_space(n) + [Candidate(*extra)]
    refs = ref_space(n) + [RefCandidate(*extra)]
    for c, r in zip(cands[:-1], refs):
        got = predict(like, c, topo())
        want = ref_predict(ref_like, r, REF_TOPO)
        for k in ("seconds", "comm_s", "ici_s", "dcn_s", "codec_s",
                  "codec_bytes"):
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), (c, k)
    ranked = rank_candidates(like, cands, topo())
    want = ref_rank(ref_like, refs, REF_TOPO)
    assert [c.to_dict() for c, _ in ranked] == \
        [c.to_dict() for c, _ in want]
    assert len(ranked) == len(cands) - 1          # centralized_ps dropped


def test_ranking_needs_a_topology():
    with pytest.raises(ValueError, match="no default topology"):
        rank_candidates(LIKE, CANDS)
    with pytest.raises(ValueError, match="no default topology"):
        predict(LIKE, CANDS[0], None)


@pytest.mark.skipif(not os.path.exists(SWEEP),
                    reason="the reference's committed sweep is not here")
def test_committed_sweep_predictions_come_back():
    """The reference's 8-device sweep, read only: the port's predictions
    on its own reduced llama3.2-1b at the reference's topology constants
    reproduce every ``predicted_s``."""
    with open(SWEEP) as f:
        rec = json.load(f)
    like = model_grads_like("llama3.2-1b", 256)[1]
    for e in rec["leaderboard"]:
        c = Candidate.from_dict(e["candidate"])
        assert predict(like, c, topo())["seconds"] == pytest.approx(
            e["predicted_s"], rel=1e-9), c


# ------------------------------------------------------------------ cache

def test_cache_roundtrip_and_lint_distrust(tmp_path):
    c = CANDS[0]
    key = cache_key(TrainConfig(), 8, LIKE, "cpu")
    store_winner(key, entry_for(c), str(tmp_path))
    assert load_cached(key, str(tmp_path))["candidate"] == c.to_dict()
    assert not os.path.exists(cache_path(key, str(tmp_path)) + ".tmp")
    # a red lint verdict is never trusted: a re-tune
    store_winner(key, entry_for(c, ok=False), str(tmp_path))
    assert load_cached(key, str(tmp_path)) is None
    # corruption is a miss, not a crash
    with open(cache_path(key, str(tmp_path)), "w") as f:
        f.write("{not json")
    assert load_cached(key, str(tmp_path)) is None
    assert load_cached("0" * 16, str(tmp_path)) is None


def test_cache_key_tracks_request_not_winner():
    base = cache_key(TrainConfig(), 8, LIKE, "cpu")
    assert base == cache_key(TrainConfig(), 8, LIKE, "cpu")
    assert base == cache_key(TrainConfig(lr=0.5), 8, LIKE, "cpu")
    assert base != cache_key(TrainConfig(), 4, LIKE, "cpu")
    assert base != cache_key(TrainConfig(wire_format_dcn="int8"), 8, LIKE,
                             "cpu")
    other = {"w": torch.empty((4096, 17), device="meta"), "b": LIKE["b"]}
    assert base != cache_key(TrainConfig(), 8, other, "cpu")
    # a winner timed on the CPU is never the card's
    assert base != cache_key(TrainConfig(), 8, LIKE, CARD)


def test_port_key_is_never_the_references():
    """The reference's own request (its default config, 8 devices, reduced
    llama3.2-1b at d_model 256) keys to the committed sweep's file; the
    port's key for the same request, on the CPU or the card, does not, so
    nothing of the port can write over it."""
    ref_like = ref_grads_like("llama3.2-1b", 256)[1]
    assert ref_cache_key(RefTC(), 8, ref_like) == "8252aff8fe53f225"
    like = model_grads_like("llama3.2-1b", 256)[1]
    for dev in ("cpu", CARD):
        assert cache_key(TrainConfig(), 8, like, dev) != "8252aff8fe53f225"
    assert os.path.dirname(cache_path("k")) == DEFAULT_CACHE_DIR
    assert os.path.abspath(DEFAULT_CACHE_DIR) == os.path.join(
        ROOT, "results", "torch", "tuning")


# -------------------------------------------------------------- autotune

def _pair(tmp_path, **kw):
    """The port's and the reference's autotune on the same request and
    fakes, each in its own cache directory."""
    port = autotune(LIKE, TrainConfig(), 8, topo=topo(),
                    cache_dir=str(tmp_path / "port"), candidates=CANDS,
                    device="cpu", **kw, **QUIET)
    ref = ref_autotune(REF_LIKE, RefTC(), 8,
                       cache_dir=str(tmp_path / "ref"),
                       candidates=REF_CANDS, **kw, **QUIET)
    return port, ref


def _same_report(port, ref):
    for k in ("candidate", "measured_us", "cache_hit", "timed_candidates",
              "devices", "steps"):
        assert port[k] == ref[k], k
    assert [e["candidate"] for e in port["leaderboard"]] == \
        [e["candidate"] for e in ref["leaderboard"]]
    assert [e["us"] for e in port["leaderboard"]] == \
        [e["us"] for e in ref["leaderboard"]]
    for a, b in zip(port["leaderboard"], ref["leaderboard"]):
        assert a["predicted_s"] == pytest.approx(b["predicted_s"],
                                                 rel=1e-12)
    assert [r["candidate"] for r in port["rejected"]] == \
        [r["candidate"] for r in ref["rejected"]]


@pytest.mark.parametrize("top_k", [1, 2, 4])
def test_flow_equals_the_references(tmp_path, top_k):
    """The fakes decide the measured order; the incumbent (sharded_ps,
    1 window, identity, 32 KB, 1x8) is appended when the top-k misses
    it."""
    port, ref = _pair(tmp_path, top_k=top_k, timer=bf16_fast,
                      linter=ok_linter)
    _same_report(port, ref)
    assert port["candidate"]["wire_format"] == "bf16" or top_k < 4
    assert _incumbent(TrainConfig(), 8).to_dict() in \
        [e["candidate"] for e in port["leaderboard"]]
    json.dumps(port)


def test_lint_gate_falls_through_as_the_references(tmp_path):
    def linter(c):
        if c.wire_format == "bf16":
            return {"ok": False, "errors": [{"message": "R1"}]}
        return {"ok": True, "errors": []}
    port, ref = _pair(tmp_path, top_k=4, timer=bf16_fast, linter=linter)
    _same_report(port, ref)
    assert port["candidate"]["wire_format"] != "bf16"
    assert [r["candidate"]["wire_format"] for r in port["rejected"]] == \
        ["bf16"]


def test_cache_hit_times_nothing_and_force_retunes(tmp_path):
    timed = []

    def timer(c):
        timed.append(c)
        return bf16_fast(c)
    kw = dict(topo=topo(), cache_dir=str(tmp_path), candidates=CANDS,
              top_k=4, timer=timer, linter=ok_linter, device="cpu", **QUIET)
    first = autotune(LIKE, TrainConfig(), 8, **kw)
    assert not first["cache_hit"] and first["timed_candidates"] == 4
    n = len(timed)
    again = autotune(LIKE, TrainConfig(), 8, **{**kw, "topo": None})
    assert again["cache_hit"] and again["timed_candidates"] == 0
    assert len(timed) == n and again["candidate"] == first["candidate"]
    assert again["device"] == "cpu"
    forced = autotune(LIKE, TrainConfig(), 8, force=True, **kw)
    assert not forced["cache_hit"] and len(timed) == 2 * n


def test_every_candidate_rejected_fails_closed(tmp_path):
    with pytest.raises(RuntimeError, match="lint-rejected"):
        autotune(LIKE, TrainConfig(), 8, topo=topo(),
                 cache_dir=str(tmp_path), candidates=CANDS, top_k=4,
                 timer=bf16_fast, linter=lambda c: {"ok": False},
                 device="cpu", **QUIET)
    assert os.listdir(tmp_path) == []
    with pytest.raises(RuntimeError, match="failed to time"):
        def broken(c):
            raise RuntimeError("out of memory")
        autotune(LIKE, TrainConfig(), 8, topo=topo(),
                 cache_dir=str(tmp_path), candidates=CANDS, top_k=4,
                 timer=broken, linter=ok_linter, device="cpu", **QUIET)
    assert os.listdir(tmp_path) == []


def test_timing_failures_are_skipped(tmp_path):
    def timer(c):
        if c.wire_format == "bf16":
            raise RuntimeError("out of memory")
        return 100.0 if c.wire_format == "identity" else 70.0
    rep = autotune(LIKE, TrainConfig(), 8, topo=topo(),
                   cache_dir=str(tmp_path), candidates=CANDS, top_k=4,
                   timer=timer, linter=ok_linter, device="cpu", **QUIET)
    assert rep["timed_candidates"] == 3
    assert "bf16" not in [e["candidate"]["wire_format"]
                          for e in rep["leaderboard"]]
    assert rep["candidate"]["wire_format"] == "int8"


def test_topology_is_asked_for_on_a_miss_only(tmp_path):
    asked = []

    def lazy():
        asked.append(1)
        return topo()
    kw = dict(cache_dir=str(tmp_path), candidates=CANDS, top_k=1,
              timer=bf16_fast, linter=ok_linter, device="cpu", **QUIET)
    autotune(LIKE, TrainConfig(), 8, topo=lazy, **kw)
    autotune(LIKE, TrainConfig(), 8, topo=lazy, **kw)
    assert asked == [1]
    with pytest.raises(ValueError, match="no default topology"):
        autotune(LIKE, TrainConfig(), 8, force=True, **kw)


def test_unlinted_winner_is_not_trusted(tmp_path):
    kw = dict(topo=topo(), cache_dir=str(tmp_path), candidates=CANDS,
              top_k=2, timer=bf16_fast, device="cpu", **QUIET)
    rep = autotune(LIKE, TrainConfig(), 8, lint=False, **kw)
    assert rep["lint"] == {"ok": False, "skipped": True, "errors": []}
    assert load_cached(rep["key"], str(tmp_path)) is None


def test_tuner_counters_on_the_registry(tmp_path):
    telemetry.enable(seed=0)
    kw = dict(topo=topo(), cache_dir=str(tmp_path), candidates=CANDS,
              top_k=1, timer=bf16_fast, linter=ok_linter, device="cpu",
              **QUIET)
    rep = autotune(LIKE, TrainConfig(), 8, **kw)
    autotune(LIKE, TrainConfig(), 8, **kw)
    snap = telemetry.get_registry().snapshot()
    label = json.dumps({"key": rep["key"]})
    assert snap["tuner.cache_miss"]["values"] == {label: 1.0}
    assert snap["tuner.cache_hit"]["values"] == {label: 1.0}


# -------------------------------------------------------- a real CPU run

def test_time_candidate_runs_on_the_cpu():
    """One real ``push_pull`` program at W=2 on a tiny tree; the CPU's
    time says nothing about the card and nothing asserts it."""
    like = {"a": {"w": torch.empty((64, 48), device="meta")},
            "b": torch.empty((100,), device="meta")}
    c = Candidate("sharded_ps", 1, "int8", None, 8 * 1024, 1, 2)
    us = time_candidate(like, c, steps=2, warmup=1, device="cpu")
    assert us > 0
