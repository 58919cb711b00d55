"""The rack lint's gate on tuned configs (``repro_torch/analysis/``), on
the CPU: rules R1 (traffic), R3 (in place) and R5 (hygiene) over one
recorded zero-compute step (reduced llama3.2-1b at d_model 64).

1. The stacked Comm's recorded traffic of one zero-compute step equals
   ``cost_model.predicted_exchange_traffic``'s runtime bytes exactly, for
   every candidate of the W=2 and W=4 spaces (each kind, each tier).
2. The gate is green on sharded_ps over the identity wire, int8 in 2
   windows (24 KB chunks: 2 effective) and hierarchical 2x2 with an int8
   DCN tier: the step keeps
   every parameter and slot in place (the identity step's m and the int8
   pull's residual included) and its payloads in the wire's dtypes.
3. The seeded fixtures (at d_model 256): bytes off by 5% (R1), one slot
   re-allocated (R3), one f64 payload (R5) flagged; their clean twins
   pass.  R1 also flags faults planted in a real step, where the clean
   step passes: an encoded ring that runs one hop too many, and a
   windowed identity exchange that skips its last window.
4. Recording leaves a step bitwise unchanged: steps with ``record`` a
   no-op equal steps that record, parameters and every slot.
5. The encoded pull writes the residual into the ``wire_ef`` slot it was
   given, in place.
"""
import pytest
import torch

from repro_torch import telemetry
from repro_torch.analysis import (RULES, artifact_from_engine,
                                  check_hygiene, check_in_place,
                                  check_traffic, lint_artifact,
                                  lint_tuned_config, seeded_fixtures)
from repro_torch.analysis.rules import _link
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm, cost_model
from repro_torch.core.chunking import build_plan, leaf_paths
from repro_torch.core import pipeline
from repro_torch.core.pipeline import add_ring_rows_, run_wire_exchange
from repro_torch.core.wire import WireFormat
from repro_torch.optim.protocol import NesterovOptimizer
from repro_torch.tuning import Candidate, enumerate_space

D_MODEL = 64
GREEN = {"sharded_ps identity": Candidate("sharded_ps", 1, "identity", None,
                                          32 * 1024, 1, 4),
         "int8 in 2 windows": Candidate("sharded_ps", 2, "int8", None,
                                        24 * 1024, 1, 4),
         "hierarchical 2x2, int8 DCN": Candidate("hierarchical", 1,
                                                 "identity", "int8",
                                                 8 * 1024, 2, 2)}
BITWISE = dict(GREEN, **{
    "identity in 3 windows": Candidate("sharded_ps", 4, "identity", None,
                                       16 * 1024, 1, 4),
    "hierarchical int8 pods, int8 DCN": Candidate(
        "hierarchical", 2, "int8", "int8", 8 * 1024, 2, 2),
    "allreduce": Candidate("allreduce", 1, "identity", None, 32 * 1024, 1,
                           4)})


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


def _cfg(d_model: int = D_MODEL):
    return reduced(get_arch("llama3.2-1b"), d_model=d_model)


def _engine(c: Candidate, d_model: int = D_MODEL) -> PHubEngine:
    return PHubEngine(_cfg(d_model), TrainConfig(**c.tc_kwargs()),
                      StackedComm(c.n_workers, c.pods), device="cpu")


SPACE = [c for n in (2, 4) for c in enumerate_space(n)]


@pytest.mark.parametrize("c", SPACE, ids=lambda c: (
    f"{c.strategy}-w{c.pipeline_windows}-{c.wire_format}-"
    f"{c.wire_format_dcn}-{c.chunk_size_bytes // 1024}k-{c.pods}x{c.data}"))
def test_recorded_traffic_is_the_cost_models(c):
    art = artifact_from_engine(_engine(c), "space")
    pred = cost_model.predicted_exchange_traffic(
        art.groups, strategy=art.strategy, wire=art.wire,
        windows=art.windows, n_workers=art.n_workers,
        pod_size=art.pod_size, wire_dcn=art.wire_dcn)["runtime_by_kind"]
    for kind in set(pred) | set(art.traffic):
        for tier in ("ici", "dcn"):
            want = pred.get(kind, {}).get(tier, 0.0)
            assert _link(art.traffic, kind, tier) == pytest.approx(
                want, rel=1e-12, abs=1e-9), (kind, tier)
    assert check_traffic(art) == [] and check_in_place(art) == []
    assert check_hygiene(art) == []


def test_windowed_cases_run_their_windows():
    """The windowed cases split their shard into the windows they name
    (at d_model 64 and 256): 24 KB in 2, 16 KB in 3 of the 4 asked."""
    from repro_torch.core.pipeline import effective_windows
    for d_model in (D_MODEL, 256):
        for name, want in (("int8 in 2 windows", 2),
                           ("identity in 3 windows", 3)):
            c = BITWISE[name]
            (g,) = _engine(c, d_model).chunk_plan.groups
            assert effective_windows(g, c.pipeline_windows) == want, name


@pytest.mark.parametrize("name", list(GREEN))
def test_gate_is_green(name):
    c = GREEN[name]
    cand = {**c.to_dict(), "arch": "llama3.2-1b", "d_model": D_MODEL}
    verdict, diags = lint_tuned_config(cand, device="cpu", tag=name)
    assert verdict["ok"] and verdict["errors"] == []
    assert verdict["rules"] == list(RULES) == ["R1", "R3", "R5"]
    assert set(verdict) == {"tag", "candidate", "ok", "rules", "errors",
                            "warnings", "config"}
    assert verdict["candidate"] == cand and verdict["tag"] == name
    # on the CPU no allocation is read: the pointers alone are checked
    assert verdict["config"]["extra_bytes"] is None
    assert diags == []


@pytest.mark.parametrize("name", list(GREEN))
def test_seeded_fixtures_are_flagged_and_clean_twins_pass(name):
    # d_model 256: every (kind, tier) carries enough bytes that 5% clears
    # R1's slack (rel 2% + 4096 B, the reference's)
    art = artifact_from_engine(_engine(GREEN[name], 256), name)
    fixtures = seeded_fixtures(art)
    assert [f.name for f in fixtures] == ["bytes_off_5pct",
                                          "slot_reallocated", "f64_payload"]
    assert [f.rule for f in fixtures] == ["R1", "R3", "R5"]
    for f in fixtures:
        assert f.flagged and not f.false_positive and f.ok, f.name
    assert lint_artifact(art) == []


def test_in_place_and_hygiene_rules_read_what_they_should():
    """R3 on the card's allocation (a warning, as the reference's alias
    bytes), a dropped state tensor (an error); R5 on a wide dtype in an
    encoded tier and on f64 state."""
    art = artifact_from_engine(_engine(GREEN["int8 in 2 windows"]), "r")
    reg = art.registered_bytes
    art.extra_bytes = int(1.2 * reg)
    assert check_in_place(art) == []
    art.extra_bytes = 3 * reg
    (d,) = check_in_place(art)
    assert (d.rule, d.severity) == ("R3", "warning")
    art.extra_bytes = None
    art.after = art.after[:-1]
    assert [d.severity for d in check_in_place(art)] == ["error"]
    art = artifact_from_engine(_engine(GREEN["int8 in 2 windows"]), "r")
    art.traffic["collective-permute"]["ici"]["bfloat16"] = 1e6
    assert [d.rule for d in check_hygiene(art)] == ["R5"]
    art = artifact_from_engine(_engine(GREEN["int8 in 2 windows"]), "r")
    name, ptr, shape, _ = art.after[0]
    art.after[0] = (name, ptr, shape, "float64")
    assert {d.rule for d in lint_artifact(art)} == {"R3", "R5"}
    # a strategy the traffic model does not cover: an info, not an error
    c = Candidate("centralized_ps", 1, "identity", None, 32 * 1024, 1, 4)
    (d,) = check_traffic(artifact_from_engine(_engine(c), "cps"))
    assert (d.rule, d.severity) == ("R1", "info")


def _one_hop_too_many(real):
    """The encoded ring with its loop one hop long: after the S-1 hops the
    partial goes round once more and picks up each owner's own strip."""
    def ring(g, wire, chunk_elems, windows=1, w=0, pods=1, on_hop=None):
        parts = real(g, wire, chunk_elems, windows, w, pods, on_hop)
        S = g.shape[0] // pods
        acc = wire.decode(parts, chunk_elems)
        parts = wire.encode(add_ring_rows_(acc, g, S, windows, w, pods),
                            chunk_elems)
        on_hop(tuple(t.view(g.shape[0], -1)[0] for t in parts))
        return parts
    return ring


def _last_window_skipped(real):
    """The window loop one short: the last window never exchanged."""
    def window(self, w):
        if w < self.windows - 1:
            real(self, w)
    return window


FAULTS = {
    "one ring hop too many": (
        GREEN["int8 in 2 windows"], pipeline, "ring_reduce_scatter",
        _one_hop_too_many, 4 / 3),
    "last window skipped": (
        BITWISE["identity in 3 windows"], pipeline.WindowedExchange,
        "window", _last_window_skipped, 2 / 3)}


@pytest.mark.parametrize("name", list(FAULTS))
def test_traffic_rule_flags_a_fault_planted_in_a_real_step(name,
                                                          monkeypatch):
    c, owner, attr, fault, ratio = FAULTS[name]
    clean = artifact_from_engine(_engine(c), name)
    assert check_traffic(clean) == []
    monkeypatch.setattr(owner, attr, fault(getattr(owner, attr)))
    bad = artifact_from_engine(_engine(c), name)
    monkeypatch.undo()
    (d,) = check_traffic(bad)
    assert (d.rule, d.severity) == ("R1", "error")
    assert (d.evidence["kind"], d.evidence["tier"]) == (
        "collective-permute", "ici")
    assert d.evidence["recorded_bytes"] == pytest.approx(
        ratio * _link(clean.traffic, "collective-permute", "ici"), rel=1e-12)


def _run(c: Candidate, quiet: bool, monkeypatch, steps: int = 2):
    """``steps`` zero-compute steps from seed 0; the parameters and every
    slot after each."""
    if quiet:
        monkeypatch.setattr(StackedComm, "record",
                            lambda self, *a, **k: None)
    eng = _engine(c)
    model, opt = eng.init_state()
    step = eng.make_zero_compute_step()
    out = []
    for _ in range(steps):
        model, opt = step(model, opt)
        out.append([t.clone() for _, t in leaf_paths(model.param_tree())]
                   + [t.clone() for _, t in leaf_paths(opt)])
    monkeypatch.undo()
    return out, eng.comm


@pytest.mark.parametrize("name", list(BITWISE))
def test_recording_changes_no_bit(name, monkeypatch):
    c = BITWISE[name]
    quiet, comm_q = _run(c, True, monkeypatch)
    loud, comm_l = _run(c, False, monkeypatch)
    assert comm_q.traffic == {} and comm_l.traffic
    for a, b in zip(quiet, loud):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # the stats: ProcessGroupComm's schema by operation, a view of the
    # same hops as the traffic
    assert all(set(s) == {"calls", "bytes", "seconds"}
               for s in comm_l.stats.values())
    assert sum(s["bytes"] for s in comm_l.stats.values()) == sum(
        b for tiers in comm_l.traffic.values() for d in tiers.values()
        for b in d.values())


@pytest.mark.parametrize("windows", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoded_pull_writes_the_residual_in_place(windows, dtype):
    """residual' lands in the ``residual`` given (the ``wire_ef`` slot),
    as the rule's slots do, and the windowed schedule still equals one
    window bitwise."""
    S, ce = 4, 512
    gen = torch.Generator().manual_seed(7)
    n = S * 4 * ce
    g = (torch.randn(S, n, generator=gen) * 1e-2).to(dtype)
    p = torch.randn(n, generator=gen).to(dtype)
    m = (torch.randn(n, generator=gen) * 1e-2).to(dtype)
    r = torch.randn(n, generator=gen) * 1e-4
    (group,) = build_plan({"w": p}, chunk_bytes=ce * p.element_size(),
                          n_shards=S).groups
    opt = NesterovOptimizer()
    outs = []
    for w in (1, windows):
        res = r.clone()
        out = run_wire_exchange(
            "sharded_ps", StackedComm(S), g.clone(), p, (m.clone(),),
            opt.kernel_update(ce, (0.05, 0.9)), group, WireFormat("int8"),
            res, opt.kernel_dequant_update(ce, (0.05, 0.9), 1.0 / S), w)
        assert out[2].data_ptr() == res.data_ptr()
        assert not torch.equal(res, r)
        outs.append(out)
    (p0, (m0,), r0), (p1, (m1,), r1) = outs
    assert torch.equal(p0, p1) and torch.equal(m0, m1)
    assert torch.equal(r0, r1)
