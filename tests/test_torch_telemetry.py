"""The port's telemetry (``repro_torch/telemetry/``, ``launch/trace.py``
and the hooks of the training stack) against the JAX package's.

Every function here is host arithmetic, so the comparisons are exact:
trace ids, step phases, registry snapshots and JSONL lines (apart from
their time fields), the attribution rows and table, the predicted phases.
The hooks are held to the reference's names, nesting and payloads: a
reduced ``fit`` and a supervised run with a rollback at W=1 against the
reference's own in this process; a supervised W=4 run with a poisoned
worker, the watchdog's retries and a connection manager's push_pull,
co_step and resize on the port alone, against the figures the port keeps
itself.  No test reads a span's duration: names, nesting, counts,
payloads and bitwise state only.  Telemetry is process-global, so every
test ends with ``telemetry.disable()``.
"""
import dataclasses
import importlib
import json
import os
import random
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro import telemetry as ref_tel
from repro.configs import ARCHS, TrainConfig as JaxTrainConfig
from repro.configs import reduced as jax_reduced
from repro.core import PHubEngine as JaxEngine
from repro.core import chunking as jax_chunking
from repro.core import cost_model as ref_cost
from repro.core.wire import make_dcn_wire_format, make_wire_format
from repro.data import SyntheticTokens as JaxTokens
from repro.launch import trace as ref_trace
from repro_torch import telemetry
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import (PHubConnectionManager, PHubEngine,
                              StackedComm, cost_model)
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.kernels.agg_opt import LAUNCHES, reset_launches
from repro_torch.launch import trace as port_trace
from repro_torch.models import param_specs
from repro_torch.telemetry.tracer import SpanRecord

T = 16


@pytest.fixture(autouse=True)
def _null_telemetry():
    yield
    telemetry.disable()
    ref_tel.disable()


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(d_model=64):
    jcfg = dataclasses.replace(jax_reduced(ARCHS["llama3.2-1b"],
                                           d_model=d_model), dtype="float32")
    pcfg = dataclasses.replace(reduced(get_arch("llama3.2-1b"),
                                       d_model=d_model), dtype="float32")
    return jcfg, pcfg


def _shape(records) -> list:
    """Everything of a span but its times."""
    return [(r.name, r.parent, r.depth, r.step, sorted(r.args.items()))
            for r in records]


def _no_time(line: dict) -> dict:
    return {k: v for k, v in line.items() if k != "t"}


# ------------------------------------------------------------------ tracer

def test_disabled_is_the_shared_null_pair():
    tr, reg = telemetry.get_tracer(), telemetry.get_registry()
    assert not telemetry.enabled() and not tr.enabled and not reg.enabled
    with tr.step(0):
        with tr.span("data"):
            pass
    assert tr.records == () and reg.events() == [] and reg.snapshot() == {}
    assert reg.counter("x").inc(5.0) == 0.0
    assert reg.histogram("h").summary() == {"count": 0, "sum": 0.0}
    tr2, reg2 = telemetry.enable(seed=1)
    assert telemetry.enabled() and telemetry.get_tracer() is tr2
    assert telemetry.disable() == (tr2, reg2)
    assert not telemetry.enabled()


@pytest.mark.parametrize("seed", [0, 1, 5, 7, 2**40 + 3])
def test_trace_id_is_the_reference_one(seed):
    assert telemetry.Tracer(seed=seed).trace_id == \
        ref_tel.Tracer(seed=seed).trace_id


def _random_records(rng, mod):
    """A hand-built span list: steps with direct children, nested detail,
    probes outside any step."""
    recs, t = [], 0.0
    for i in range(rng.randrange(1, 5)):
        t0 = t
        for name in rng.sample(["data", "dispatch", "sync", "checkpoint",
                                "exchange/push_pull"], 3):
            d = rng.random()
            recs.append(mod.SpanRecord(name=name, t0=t, dur=d, depth=1,
                                       step=i, parent="step"))
            recs.append(mod.SpanRecord(name="engine/dispatch", t0=t,
                                       dur=d / 2, depth=2, step=i,
                                       parent=name))
            t += d
        recs.append(mod.SpanRecord(name="step", t0=t0, dur=t - t0, depth=0,
                                   step=i, parent="", args={"step": i}))
    for r in range(rng.randrange(0, 3)):
        recs.append(mod.SpanRecord(name="probe/exchange", t0=t,
                                   dur=rng.random(), depth=0, step=-1,
                                   parent="", args={"rep": r}))
    return recs


@pytest.mark.parametrize("seed", range(6))
def test_step_phases_and_totals_equal_the_reference(seed):
    from repro.telemetry import tracer as ref_tracer
    from repro_torch.telemetry import tracer as port_tracer
    port_recs = _random_records(random.Random(seed), port_tracer)
    ref_recs = _random_records(random.Random(seed), ref_tracer)
    assert port_tracer.step_phases(port_recs) == \
        ref_tracer.step_phases(ref_recs)
    assert port_tracer.phase_totals(port_recs) == \
        ref_tracer.phase_totals(ref_recs)


def _record_spans(mod, seed):
    tr, _ = mod.enable(seed=seed, meta={"devices": 2, "strategy": "x"})
    for i in range(2):
        with tr.step(i):
            with tr.span("data"):
                pass
            with tr.span("exchange/push_pull", ns="job"):
                with tr.span("engine/dispatch"):
                    pass
            tr.mark("membership", kind="leave")
    for r in range(3):
        with tr.span("probe/exchange", rep=r):
            pass
    return tr


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_either_reader_reads_either_trace(tmp_path, writer):
    mod = telemetry if writer == "port" else ref_tel
    tr = _record_spans(mod, seed=7)
    comm = sorted(r.dur for r in tr.records if r.name == "probe/exchange")[1]
    tr.meta["attribution"] = {"predicted": {"comm_s": comm},
                              "rel_tol": 0.5,
                              "rows": [{"phase": "compute", "seconds": 0.1,
                                        "fraction": 1.0,
                                        "predicted_s": None,
                                        "measured": True}],
                              "step_s": 0.1}
    path = tr.write(str(tmp_path / "trace.json"))
    mod.disable()
    p_recs, p_meta = port_trace.load_trace(path)
    r_recs, r_meta = ref_trace.load_trace(path)
    assert p_meta == r_meta and p_meta["trace_id"] == tr.trace_id
    assert _shape(p_recs) == _shape(r_recs)
    assert [(r.t0, r.dur) for r in p_recs] == [(r.t0, r.dur) for r in r_recs]
    assert port_trace.validate(p_recs) == ref_trace.validate(r_recs) == []
    assert port_trace.render_breakdown(p_recs, p_meta) == \
        ref_trace.render_breakdown(r_recs, r_meta)
    ag = port_trace.check_model(p_recs, p_meta)
    assert ag == ref_trace.check_model(r_recs, r_meta)
    assert ag["checked"] and ag["ok"]
    assert not port_trace.check_model(p_recs, {})["ok"]
    assert port_trace.main([path, "--check-model"]) == \
        ref_trace.main([path, "--check-model"]) == 0


def test_validate_flags_malformed_records_as_the_reference():
    def bad(mod):
        return [mod.SpanRecord(name="step", t0=0.0, dur=1.0, depth=0,
                               step=0, parent="", args={"step": 0}),
                mod.SpanRecord(name="data", t0=5.0, dur=0.1, depth=1,
                               step=0, parent="step"),
                mod.SpanRecord(name="sync", t0=0.2, dur=0.1, depth=2,
                               step=0, parent=""),
                mod.SpanRecord(name="dispatch", t0=0.3, dur=0.1, depth=1,
                               step=3, parent="step")]
    from repro.telemetry import tracer as ref_tracer
    issues = port_trace.validate(bad(telemetry.tracer))
    assert issues == ref_trace.validate(bad(ref_tracer))
    assert len(issues) == 3


# ---------------------------------------------------------------- registry

def _drive_registry(reg):
    reg.counter("exchange.bytes").inc(100.0, tenant="a", basis="raw")
    reg.counter("exchange.bytes").inc(50.0, tenant="a", basis="raw")
    reg.counter("exchange.bytes").inc(30.0, tenant="b", basis="wire")
    reg.gauge("membership.epoch").set(3)
    reg.gauge("membership.epoch").set(4.0)
    h = reg.histogram("serve.latency")
    for v in (5e-5, 0.005, 0.05, 20.0, 0.005):
        h.observe(v, phase="decode")
    reg.histogram("custom", buckets=(0.5, 1.5)).observe(1.0, phase="x")
    reg.current_step = 4
    reg.event("supervisor.demote", rank=2, detail="repeat offender")
    reg.event("rebalance", step=9, moved_bytes=np.float32(2.5),
              world=np.int64(3))
    with pytest.raises(TypeError):
        reg.gauge("exchange.bytes")
    return reg


def test_registry_equals_the_reference(tmp_path):
    port = _drive_registry(telemetry.MetricsRegistry())
    ref = _drive_registry(ref_tel.MetricsRegistry())
    assert port.snapshot() == ref.snapshot()
    assert port.events() == ref.events()
    assert port.histogram("serve.latency").summary(phase="decode") == \
        ref.histogram("serve.latency").summary(phase="decode")
    a = port.dump_jsonl(str(tmp_path / "port.jsonl"))
    b = ref.dump_jsonl(str(tmp_path / "ref.jsonl"))
    la = [_no_time(json.loads(x)) for x in open(a)]
    lb = [_no_time(json.loads(x)) for x in open(b)]
    assert la == lb and len(la) == 13
    # a sink gets the same lines as they happen
    sink = open(tmp_path / "sink.jsonl", "w")
    _drive_registry(telemetry.MetricsRegistry(sink=sink))
    sink.close()
    assert [_no_time(json.loads(x))
            for x in open(tmp_path / "sink.jsonl")] == la


# ------------------------------------------------------------- attribution

PRED = {"comm_s": 0.10, "ici_s": 0.08, "dcn_s": 0.0, "codec_s": 0.02}


def _attribution_cases():
    rng = random.Random(3)
    cases = [(0.3, 0.2, PRED, None), (0.3, 0.2, None, {"data": 0.01}),
             (0.3, None, PRED, {"checkpoint": 0.05}), (0.05, 0.2, PRED, None),
             (0.3, 0.0, {"comm_s": 0.0, "ici_s": 0.0, "dcn_s": 0.0,
                         "codec_s": 0.0}, None)]
    for _ in range(8):
        pred = {"ici_s": rng.random() * 0.1, "dcn_s": rng.choice(
            [0.0, rng.random() * 0.05]), "codec_s": rng.choice(
            [0.0, rng.random() * 0.02])}
        pred["comm_s"] = pred["ici_s"] + pred["dcn_s"] + pred["codec_s"]
        cases.append((rng.random(), rng.choice([None, rng.random() * 0.2]),
                      pred, rng.choice([None, {"data": rng.random() * 0.01,
                                               "sync": rng.random() * 1e-3}])))
    return cases


@pytest.mark.parametrize("case", range(len(_attribution_cases())))
def test_attribution_equals_the_reference(case):
    step_s, exch_s, pred, host = _attribution_cases()[case]
    rows = telemetry.attribute_step(step_s, exch_s, pred, host)
    assert rows == ref_tel.attribute_step(step_s, exch_s, pred, host)
    assert telemetry.phase_fractions(rows) == ref_tel.phase_fractions(rows)
    for tol in (0.2, 0.35, 1.0):
        assert telemetry.model_agreement(exch_s, pred, tol) == \
            ref_tel.model_agreement(exch_s, pred, tol)
    for kw in ({}, {"step_s": step_s}, {"step_s": step_s, "title": "t"}):
        assert telemetry.format_table(rows, **kw) == \
            ref_tel.format_table(rows, **kw)


def test_attribution_scales_the_model_ratios():
    rows = telemetry.attribute_step(0.3, 0.2, PRED)
    by = {r["phase"]: r for r in rows}
    assert by["exchange/ici"]["seconds"] == pytest.approx(0.16)
    assert by["exchange/codec"]["seconds"] == pytest.approx(0.04)
    assert by["compute"]["seconds"] == pytest.approx(0.1)
    bad = telemetry.model_agreement(0.2, PRED, rel_tol=0.2)
    assert bad["checked"] and not bad["ok"]


# ------------------------------------------------------ predicted phases

# an explicit topology, the same for both packages (illustrative values,
# no calibration of any device)
TOPO_FIELDS = dict(n_workers_per_rack=2, n_racks=2, bw_worker=40e9,
                   bw_pbox=30e9, bw_core=5e9, bw_ici=25e9, bw_dcn=4e9,
                   lat_ici=3e-5, lat_dcn=8e-5, bw_codec=60e9,
                   allreduce_factor=1.7)

PHASE_CASES = [
    ("sharded_ps", 4, 1, "identity", None, 1),
    ("sharded_ps", 4, 1, "int8", None, 5),
    ("sharded_ps", 2, 1, "bf16", None, 3),
    ("sharded_ps", 1, 1, "identity", None, 1),
    ("allreduce", 4, 1, "identity", None, 1),
    ("hierarchical", 4, 2, "identity", None, 1),
    ("hierarchical", 4, 2, "identity", "int8", 3),
    ("hierarchical", 4, 2, "int8", None, 1),
]


def _ref_engine(jtc, W, P):
    """The attributes of the reference's engine its ``predicted_phases``
    reads, without a mesh: its chunk plan over the same model at the
    strategy's shard count."""
    jcfg, _ = _cfgs()
    like = jax.eval_shape(
        lambda k: __import__("repro.models", fromlist=["init"]).init(jcfg, k),
        jax.ShapeDtypeStruct((2,), jax.numpy.uint32))
    n_shards = {"allreduce": 1, "centralized_ps": 1,
                "hierarchical": W // P}.get(jtc.strategy, W)
    plan = jax_chunking.build_plan(like, chunk_bytes=jtc.chunk_size_bytes,
                                   n_shards=n_shards)
    return SimpleNamespace(chunk_plan=plan, tc=jtc,
                           wire=make_wire_format(jtc),
                           wire_dcn=make_dcn_wire_format(jtc),
                           ctx=SimpleNamespace(n_workers=W), pod_size=P)


@pytest.mark.parametrize("case", PHASE_CASES,
                         ids=["-".join(map(str, c)) for c in PHASE_CASES])
def test_predicted_phases_equal_the_reference(case):
    strategy, W, P, wire, dcn, windows = case
    _, pcfg = _cfgs()
    fields = dict(strategy=strategy, wire_format=wire, wire_format_dcn=dcn,
                  pipeline_windows=windows, chunk_size_bytes=28 * 1024)
    eng = PHubEngine(pcfg, TrainConfig(**fields), StackedComm(W, P),
                     device="cpu")
    ref_eng = _ref_engine(JaxTrainConfig(**fields), W, P)
    assert [g.padded for g in eng.chunk_plan.groups] == \
        [g.padded for g in ref_eng.chunk_plan.groups]
    got = telemetry.predicted_phases(eng, cost_model.RackTopology(
        **TOPO_FIELDS), compute_s=0.25)
    want = ref_tel.predicted_phases(ref_eng, ref_cost.RackTopology(
        **TOPO_FIELDS), compute_s=0.25)
    assert got == want
    assert (got["comm_s"] > 0) == (W > 1)


def test_predicted_phases_need_a_topology_and_a_traffic_model():
    """No topology raises; centralized_ps has no traffic model in either
    package's cost model, so both refuse it."""
    _, pcfg = _cfgs()
    topo = cost_model.RackTopology(**TOPO_FIELDS)
    tc = TrainConfig(strategy="centralized_ps")
    eng = PHubEngine(pcfg, tc, StackedComm(4), device="cpu")
    with pytest.raises(ValueError, match="no traffic model"):
        telemetry.predicted_phases(eng, topo)
    with pytest.raises(ValueError, match="no HLO traffic model"):
        ref_tel.predicted_phases(_ref_engine(JaxTrainConfig(
            strategy="centralized_ps"), 4, 1), ref_cost.RackTopology(
                **TOPO_FIELDS))
    eng = PHubEngine(pcfg, TrainConfig(), StackedComm(2), device="cpu")
    with pytest.raises(ValueError, match="no default topology"):
        telemetry.predicted_phases(eng, None)
    with pytest.raises(TypeError):
        telemetry.predicted_phases(eng)


# ------------------------------------------------------------------- hooks

def test_fit_spans_equal_the_reference_fit(tmp_path):
    """A reduced W=1 ``fit`` with a checkpoint every second step, in both
    packages: the same spans in the same order, nesting and payloads."""
    from repro.training.loop import TrainState as JaxState, fit as jax_fit
    from repro_torch.training import TrainState, fit
    jcfg, pcfg = _cfgs()
    jeng = JaxEngine(cfg=jcfg, tc=JaxTrainConfig(loss_chunk=T),
                     mesh=jax.make_mesh((1, 1), ("data", "model")))
    jp, jo = jeng.init_state(jax.random.PRNGKey(0))
    tr_ref, _ = ref_tel.enable(seed=0)
    jax_fit(jeng, JaxState(jp, jo), JaxTokens(jcfg, 4, T, seed=1), steps=4,
            log_every=1, log_fn=lambda s: None,
            checkpoint_dir=str(tmp_path / "ref"), checkpoint_every=2)
    ref_tel.disable()

    eng = PHubEngine(pcfg, TrainConfig(loss_chunk=T), StackedComm(1),
                     device="cpu")
    model, opt = eng.init_state()
    tr, reg = telemetry.enable(seed=0)
    fit(eng, TrainState(model, opt), SyntheticTokens(pcfg, 4, T, seed=1),
        steps=4, log_every=1, log_fn=lambda s: None,
        checkpoint_dir=str(tmp_path / "port"), checkpoint_every=2)
    assert _shape(tr.records) == _shape(tr_ref.records)
    names = {(r.name, r.parent) for r in tr.records}
    assert names == {("step", ""), ("data", "step"), ("dispatch", "step"),
                     ("engine/dispatch", "dispatch"), ("sync", "step"),
                     ("checkpoint", "step")}
    assert port_trace.validate(tr.records) == []
    assert reg.current_step == 3


def _supervised(pkg, tmp_path, steps):
    """A supervised W=1 run in either package: the worker NaN-pushes at
    steps 1-3 (divergence_patience 3), so the supervisor rolls back."""
    ckpt = str(tmp_path / pkg)
    if pkg == "port":
        from repro_torch.elastic import FaultEvent, FaultSchedule, NAN_PUSH
        from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                            TrainSupervisor)
        from repro_torch.training import TrainState, fit
        _, cfg = _cfgs()
        eng = PHubEngine(cfg, TrainConfig(loss_chunk=T), StackedComm(1),
                         device="cpu")
        state = TrainState(*eng.init_state())
        data = SyntheticTokens(cfg, 4, T, seed=1)
    else:
        from repro.elastic import FaultEvent, FaultSchedule, NAN_PUSH
        from repro.resilience import (SanityConfig, SupervisorConfig,
                                      TrainSupervisor)
        from repro.training.loop import TrainState, fit
        cfg, _ = _cfgs()
        eng = JaxEngine(cfg=cfg, tc=JaxTrainConfig(loss_chunk=T),
                        mesh=jax.make_mesh((1, 1), ("data", "model")))
        state = TrainState(*eng.init_state(jax.random.PRNGKey(0)))
        data = JaxTokens(cfg, 4, T, seed=1)
    sup = TrainSupervisor(eng, SupervisorConfig(
        sanity=SanityConfig(allow_injection=True), checkpoint_dir=ckpt,
        checkpoint_every=1, keep_k=2, divergence_patience=3),
        faults=FaultSchedule((FaultEvent(1, NAN_PUSH, 0, duration=3),),
                             world=1), log_fn=None)
    state = fit(eng, state, data, steps=steps, log_every=0, supervisor=sup)
    return sup, state


def test_supervised_spans_and_metrics_equal_the_reference(tmp_path):
    tr_ref, reg_ref = ref_tel.enable(seed=0)
    sup_ref, _ = _supervised("reference", tmp_path, 5)
    ref_tel.disable()
    tr, reg = telemetry.enable(seed=0)
    sup, state = _supervised("port", tmp_path, 5)
    assert sup.event_kinds() == sup_ref.event_kinds()
    assert sup.rollbacks == sup_ref.rollbacks == 1
    assert _shape(tr.records) == _shape(tr_ref.records)
    assert {(r.name, r.parent) for r in tr.records} >= {
        ("step", ""), ("data", "step"), ("dispatch", "step"),
        ("engine/dispatch", "dispatch"), ("sync", "step"),
        ("digest", "step"), ("checkpoint", "digest"),
        ("rollback", "digest")}
    assert all(r.args.get("supervised") for r in tr.records
               if r.name in ("step", "dispatch"))
    assert reg.snapshot() == reg_ref.snapshot()
    assert reg.counter("supervisor.rollbacks").value() == 1
    assert [e["name"] for e in reg.events()] == \
        [e["name"] for e in reg_ref.events()]
    for a, b in zip(reg.events(), reg_ref.events()):
        assert a["step"] == b["step"]
        skip = {"detail", "seconds"}
        assert {k: v for k, v in a["payload"].items() if k not in skip} == \
            {k: v for k, v in b["payload"].items() if k not in skip}
    assert len(state.losses) == 5


def test_supervised_demotion_counts_by_rank(tmp_path):
    """W=4, worker 1 NaN-pushes at steps 1 and 2: masked twice, demoted
    once; the counters, events and spans say so."""
    from repro_torch.elastic import FaultEvent, FaultSchedule, NAN_PUSH
    from repro_torch.resilience import (SanityConfig, SupervisorConfig,
                                        TrainSupervisor)
    from repro_torch.training import TrainState, fit
    _, cfg = _cfgs()
    eng = PHubEngine(cfg, TrainConfig(loss_chunk=T), StackedComm(4),
                     device="cpu")
    sup = TrainSupervisor(eng, SupervisorConfig(
        sanity=SanityConfig(allow_injection=True), demote_after=2),
        faults=FaultSchedule((FaultEvent(1, NAN_PUSH, 1, duration=2),),
                             world=4), log_fn=None)
    tr, reg = telemetry.enable(seed=0)
    fit(eng, TrainState(*eng.init_state()), SyntheticTokens(cfg, 8, T),
        steps=4, log_every=0, supervisor=sup)
    assert reg.counter("supervisor.demotions").value(rank=1) == 1
    assert reg.counter("supervisor.incidents").value(kind="push_masked") == 2
    (dem,) = reg.events("supervisor.demote")
    assert dem["step"] == 2 and dem["payload"]["worker"] == 1
    assert dem["payload"]["status"] == "slow"
    assert [r.step for r in tr.records if r.name == "digest"] == [0, 1, 2, 3]
    assert reg.counter("supervisor.rollbacks").value() == 0


def test_watchdog_emits_the_reference_metrics():
    """The reference's ``tests/test_telemetry.py::test_watchdog_emits_
    metrics`` scenario in both packages, and an exhausted budget."""
    from repro.resilience import (ExchangeWatchdog as RefWatchdog,
                                  TransientExchangeError as RefErr,
                                  WatchdogConfig as RefCfg)
    from repro_torch.resilience import (ExchangeWatchdog,
                                        TransientExchangeError,
                                        WatchdogConfig, WatchdogExhausted)

    def drive(mod, wd_cls, err, cfg_cls):
        _, reg = mod.enable(seed=0)
        wd = wd_cls(cfg_cls(retries=2, backoff_base_s=0.0))
        wd.inject_fault(err(worker=1), attempts=2)
        assert wd.run(lambda: "ok") == "ok"
        wd.inject_fault(err(worker=3), attempts=3)
        with pytest.raises(Exception, match="3 attempts"):
            wd.run(lambda: "never")
        mod.disable()
        return reg

    reg = drive(telemetry, ExchangeWatchdog, TransientExchangeError,
                WatchdogConfig)
    ref = drive(ref_tel, RefWatchdog, RefErr, RefCfg)
    assert reg.counter("watchdog.retries").value() == 4
    (r1, r2) = reg.events("watchdog.retry")[:2]
    assert r1["payload"]["worker"] == 1 and r2["payload"]["attempt"] == 2
    assert reg.snapshot() == ref.snapshot()
    assert [(e["name"], e["payload"]["worker"]) for e in reg.events()] == \
        [(e["name"], e["payload"]["worker"]) for e in ref.events()]
    assert issubclass(WatchdogExhausted, Exception)


def test_connection_manager_counters_and_events():
    """push_pull, co_step, membership transitions and resize: the spans
    and the registry carry the bytes and epochs the manager keeps."""
    _, cfg = _cfgs()
    cm = PHubConnectionManager()
    tc = TrainConfig(loss_chunk=T, wire_format="int8")
    ha = cm.create_service("a", cfg, tc, StackedComm(4), device="cpu")
    hb = cm.create_service("b", cfg, dataclasses.replace(tc, seed=1),
                           StackedComm(4), device="cpu")
    ma, oa = cm.init_service(ha)
    mb, _ = cm.init_service(hb)
    data = SyntheticTokens(cfg, 8, T, seed=2)
    tr, reg = telemetry.enable(seed=0)
    ma, oa, _ = cm.push_pull(ha, ma, oa, data.torch_batch(0, "cpu"))
    eng = cm.connect_service(ha)
    padded = sum(g.padded * g.dtype.itemsize for g in eng.chunk_plan.groups)
    wire_b = cost_model.wire_bytes_for_groups(
        [(g.padded, g.dtype, g.chunk_elems) for g in eng.chunk_plan.groups],
        eng.wire)
    t = cost_model.tenant_step_traffic("sharded_ps", padded, 4, wire_b)
    assert reg.counter("exchange.bytes").value(tenant="a", basis="raw") == \
        t["push_bytes"] + t["pull_bytes"]
    assert reg.counter("exchange.bytes").value(tenant="a", basis="wire") == \
        t["wire_push_bytes"] + t["wire_pull_bytes"] < padded * 1.5

    cm.attach_services([ha, hb])
    cm.leave(3)
    for i in range(2):
        cm.co_step([ha, hb], {"a": ma, "b": mb},
                   {ns: data.torch_batch(i, "cpu") for ns in "ab"})
    cm.join(3)
    cm.demote(2)
    acct = cm.accounting()
    for ns in "ab":
        cum = acct[ns]["cumulative"]
        extra = (t["push_bytes"] + t["pull_bytes"]) if ns == "a" else 0.0
        assert reg.counter("exchange.bytes").value(tenant=ns, basis="raw") \
            == cum["push_bytes"] + cum["pull_bytes"] + extra
    spans = [(r.name, sorted(r.args.items())) for r in tr.records
             if r.name.startswith("exchange/")]
    assert spans == [("exchange/push_pull", [("ns", "a")])] + \
        [("exchange/co_step", [("tenants", 2)])] * 2
    assert [(e["payload"]["kind"], e["payload"]["rank"])
            for e in reg.events("membership")] == \
        [("leave", 3), ("join", 3), ("demote", 2)]
    assert reg.gauge("membership.epoch").value() == cm.membership.epoch
    assert reg.counter("membership.demotions").value(rank=2) == 1

    cm.detach_service(hb)
    cm.resize(StackedComm(3), {})
    moved = cm.last_rebalance["co"]["moved_bytes"]
    assert reg.counter("rebalance.moved_bytes").value() == moved > 0
    (ev,) = reg.events("rebalance")
    assert ev["payload"] == {"world": 3, "epoch": cm.membership.epoch,
                             "moved_bytes": moved}
    assert reg.events("membership")[-1]["payload"]["kind"] == "resize"
    assert reg.gauge("membership.epoch").value() == cm.membership.epoch


# ---------------------------------------------------------- on against off

def _fit_run(fields, on: bool):
    from repro_torch.training import TrainState, fit
    _, cfg = _cfgs()
    eng = PHubEngine(cfg, TrainConfig(loss_chunk=T, **fields),
                     StackedComm(4), device="cpu")
    state = TrainState(*eng.init_state())
    if on:
        telemetry.enable(seed=0)
    reset_launches()
    state = fit(eng, state, SyntheticTokens(cfg, 8, T, seed=5), steps=2,
                log_every=1, log_fn=lambda s: None)
    launches = dict(LAUNCHES)
    tr = telemetry.disable()[0]
    return state, launches, tr


@pytest.mark.parametrize("fields", [{}, dict(wire_format="int8",
                                             pipeline_windows=5,
                                             chunk_size_bytes=28 * 1024)],
                         ids=["identity", "int8-5-windows"])
def test_telemetry_on_equals_off_bitwise(fields):
    torch.use_deterministic_algorithms(True)
    try:
        off, l_off, tr_off = _fit_run(fields, False)
        on, l_on, tr_on = _fit_run(fields, True)
    finally:
        torch.use_deterministic_algorithms(False)
    assert tr_off.records == () and len(tr_on.records) > 0
    assert on.losses == off.losses and l_on == l_off
    for (pa, a), (pb, b) in zip(leaf_paths(on.params.param_tree()),
                                leaf_paths(off.params.param_tree())):
        assert pa == pb and torch.equal(a, b), pa
    for k in off.opt:
        for n in off.opt[k]:
            assert torch.equal(on.opt[k][n], off.opt[k][n]), (k, n)


# --------------------------------------------------------------- launchers

TRAIN = ["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
         "--seq", "16", "--workers", "2"]


def test_train_launcher_telemetry_artifacts_and_check_model(
        tmp_path, capsys, monkeypatch):
    from repro_torch.launch.train import main
    # the probes' size on the card is 2^26 a row; a CPU run takes 2048
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.tuning.calibrate"), "CARD_PROBE_ELEMS", 2048)
    out = str(tmp_path / "tel")
    off = main(TRAIN)
    assert not telemetry.enabled()
    on = main(TRAIN + ["--telemetry", "--calibrate", "--telemetry-out",
                       out])
    assert not telemetry.enabled() and on == off
    assert sorted(os.listdir(out)) == ["calibration_2w.json",
                                       "metrics.jsonl", "report.txt",
                                       "trace.json"]
    text = capsys.readouterr().out
    assert "where did the step go" in text and "calibrated on cpu" in text
    path = os.path.join(out, "trace.json")
    recs, meta = port_trace.load_trace(path)
    assert port_trace.validate(recs) == []
    assert meta["attribution"]["calibrated"]
    assert [r.name for r in recs if r.name.startswith("probe/")] == \
        ["probe/exchange"] * 3 + ["probe/step"] * 3
    assert port_trace.main([path, "--check-model"]) == 0
    assert ref_trace.main([path, "--check-model"]) == 0
    rec = json.load(open(os.path.join(out, "calibration_2w.json")))
    assert rec["card"] == "cpu" and rec["base"]["lat_ici"] == 0.0
    # a second run reads this card's saved calibration instead
    again = main(TRAIN + ["--telemetry", "--telemetry-out", out])
    assert again == off and not telemetry.enabled()
    _, meta2 = port_trace.load_trace(path)
    assert meta2["attribution"]["topology"] == rec["topology"]
    assert not meta2["attribution"]["calibrated"]


def test_train_launcher_without_a_calibration_keeps_one_exchange_row(
        tmp_path, capsys):
    from repro_torch.launch.train import main
    out = str(tmp_path / "tel")
    main(TRAIN + ["--telemetry", "--telemetry-out", out, "--supervise"])
    assert not telemetry.enabled()
    text = capsys.readouterr().out
    assert "keeps the measured exchange as one row" in text
    recs, meta = port_trace.load_trace(os.path.join(out, "trace.json"))
    att = meta["attribution"]
    assert att["predicted"] is None and att["topology"] is None
    assert [r["phase"] for r in att["rows"]] == ["compute", "exchange"]
    assert {r.name for r in recs} >= {"digest", "sync", "dispatch"}
    # no model to check against: impossible, not silently ok
    assert port_trace.main([os.path.join(out, "trace.json"),
                            "--check-model"]) == 1


def test_train_launcher_disables_telemetry_when_it_fails(tmp_path):
    from repro_torch.launch.train import main
    with pytest.raises(ValueError, match="workers"):
        main(["--reduced", "--device", "cpu", "--steps", "1", "--batch",
              "3", "--seq", "16", "--workers", "2", "--telemetry",
              "--telemetry-out", str(tmp_path)])
    assert not telemetry.enabled()
    with pytest.raises(SystemExit, match="--nproc"):
        main(TRAIN[:-2] + ["--nproc", "2", "--telemetry"])


def test_train_launcher_tenants_trace(tmp_path):
    from repro_torch.launch.train import main
    out = str(tmp_path / "tel")
    main(["--reduced", "--device", "cpu", "--steps", "2", "--batch", "4",
          "--seq", "16", "--workers", "2", "--tenants", "2", "--telemetry",
          "--telemetry-out", out])
    assert not telemetry.enabled()
    recs, _ = port_trace.load_trace(os.path.join(out, "trace.json"))
    assert port_trace.validate(recs) == []
    # load_trace orders the spans by their start
    assert [(r.name, r.parent) for r in recs if r.step == 0] == [
        ("step", ""), ("data", "step"), ("exchange/co_step", "step"),
        ("engine/dispatch", "exchange/co_step"), ("sync", "step")]
    lines = [json.loads(x) for x in open(os.path.join(out,
                                                      "metrics.jsonl"))]
    assert {(x["name"], x["labels"]["tenant"]) for x in lines} == {
        ("exchange.bytes", "job0"), ("exchange.bytes", "job1")}


def test_serve_launcher_telemetry(tmp_path):
    from repro_torch.launch.serve import main
    args = ["--reduced", "--device", "cpu", "--batch", "2", "--prompt-len",
            "16", "--decode-steps", "5"]
    off = main(args)
    out = str(tmp_path / "tel")
    on = main(args + ["--telemetry", "--telemetry-out", out])
    assert not telemetry.enabled()
    assert np.array_equal(on, off)
    assert sorted(os.listdir(out)) == ["serve_metrics.jsonl",
                                       "serve_trace.json"]
    recs, meta = port_trace.load_trace(os.path.join(out,
                                                    "serve_trace.json"))
    assert meta["mode"] == "serve" and port_trace.validate(recs) == []
    assert [(r.name, r.parent) for r in recs if r.depth == 0] == \
        [("prefill", "")] + [("decode/step", "")] * 4
    assert [r.args["i"] for r in recs if r.name == "decode/step"] == \
        [0, 1, 2, 3]
    assert {(r.name, r.parent) for r in recs if r.depth == 1} == {
        ("engine/dispatch", "prefill"), ("engine/dispatch", "decode/step")}
    hist = [json.loads(x) for x in open(os.path.join(
        out, "serve_metrics.jsonl"))]
    assert [x["labels"]["phase"] for x in hist] == \
        ["prefill"] + ["decode_dispatch"] * 4 + ["decode_total"]
