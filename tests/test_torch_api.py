"""The port's connection manager (``core/api.py::PHubConnectionManager``)
behaves as the reference's ``tests/test_api.py`` and ``tests/test_tenancy.py``
hold the JAX package's to: nonces, duplicate names, destroy, connection
counting, the step cache keyed by batch shapes and membership, the
attach/detach lifecycle, a solo ``push_pull`` refused for an attached
tenant, ``co_step`` needing every attached handle, batch attach checked
before anything changes, incompatible tenants refused (wire, DCN wire,
exchange signature, flat residency, chunk-ready, another Comm), the
membership calls and the watchdog, and the accounting (shares summing to
1, cumulative bytes).  CPU, reduced llama3.2-1b at d_model 64 and 128.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import (PHubConnectionManager, ServiceHandle,
                              StackedComm)
from repro_torch.core.cost_model import (tenant_accounting,
                                         tenant_step_traffic,
                                         wire_bytes_for_groups)
from repro_torch.core.wire import WireFormat
from repro_torch.data import SyntheticTokens
from repro_torch.resilience import (ExchangeWatchdog, TransientExchangeError,
                                    WatchdogConfig)

CFG = reduced(get_arch("llama3.2-1b"), d_model=64)
CFG_B = reduced(get_arch("llama3.2-1b"), d_model=128)
TC = TrainConfig(loss_chunk=16)
ONE = StackedComm(1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0, batch=4, seq=16):
    return SyntheticTokens(cfg, batch, seq, seed=seed).torch_batch(0, "cpu")


def _create(cm, ns, cfg=CFG, tc=TC, comm=ONE):
    return cm.create_service(ns, cfg, tc, comm, device="cpu")


def _two_tenants(cm, comm=ONE):
    tcB = dataclasses.replace(TC, lr=5e-3, momentum=0.8)
    return (_create(cm, "A", comm=comm), CFG), \
        (_create(cm, "B", CFG_B, tcB, comm), CFG_B)


# -------------------------------------------------------------- lifecycle

def test_bad_nonce_raises_permission_error():
    cm = PHubConnectionManager()
    h = _create(cm, "job")
    forged = ServiceHandle(namespace="job", nonce="0" * 16)
    with pytest.raises(PermissionError):
        cm.connect_service(forged)
    with pytest.raises(PermissionError):
        cm.push_pull(forged, None, None, _batch(CFG))
    with pytest.raises(PermissionError):
        cm.destroy_service(forged)
    with pytest.raises(PermissionError):
        cm.connect_service(ServiceHandle(namespace="ghost", nonce=h.nonce))


def test_duplicate_create_raises_value_error():
    cm = PHubConnectionManager()
    _create(cm, "job")
    with pytest.raises(ValueError, match="already exists"):
        _create(cm, "job")


def test_destroy_reclaims_namespace():
    cm = PHubConnectionManager()
    h1 = _create(cm, "job")
    cm.destroy_service(h1)
    assert cm.membership is None            # an empty rack has no workers
    h2 = _create(cm, "job")
    assert h2.nonce != h1.nonce
    with pytest.raises(PermissionError):
        cm.connect_service(h1)
    cm.connect_service(h2)


def test_connect_service_counting():
    cm = PHubConnectionManager()
    h = _create(cm, "job")
    assert cm.service_info(h)["connected"] == 0
    e1 = cm.connect_service(h)
    e2 = cm.connect_service(h)
    assert e1 is e2
    info = cm.service_info(h)
    assert info["connected"] == 2 and info["attached"] is False


def test_cached_step_reuse_keyed_by_batch_shapes_and_membership():
    cm = PHubConnectionManager()
    h = _create(cm, "job", comm=StackedComm(2))
    m, o = cm.init_service(h, seed=0)
    m, o, _ = cm.push_pull(h, m, o, _batch(CFG, seq=16))
    assert cm.service_info(h)["cached_steps"] == 1
    m, o, _ = cm.push_pull(h, m, o, _batch(CFG, seed=1, seq=16))
    assert cm.service_info(h)["cached_steps"] == 1   # same shapes: reuse
    m, o, _ = cm.push_pull(h, m, o, _batch(CFG, seq=8))
    assert cm.service_info(h)["cached_steps"] == 2   # new shapes: new step
    cm.leave(1)
    m, o, met = cm.push_pull(h, m, o, _batch(CFG, seq=8))
    assert cm.service_info(h)["cached_steps"] == 3   # new live set
    cm.join(1)
    m, o, _ = cm.push_pull(h, m, o, _batch(CFG, seq=8))
    assert cm.service_info(h)["cached_steps"] == 3   # full rack again
    assert torch.isfinite(met["loss"])


def test_init_service_draws_from_the_seed():
    cm = PHubConnectionManager()
    h = _create(cm, "job")
    a, _ = cm.init_service(h, seed=3)
    b, _ = cm.init_service(h, seed=3)
    c, _ = cm.init_service(h, seed=4)
    pa, pb, pc = (dict(x.named_parameters()) for x in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not all(torch.equal(pa[k], pc[k]) for k in pa)


# ---------------------------------------------------------- co-scheduling

def test_attach_detach_lifecycle():
    cm = PHubConnectionManager()
    (hA, _), (hB, _) = _two_tenants(cm)
    assert cm.packed_domain is None and cm.accounting() == {}
    cm.attach_service(hA)
    cm.attach_service(hB)
    assert cm.attached == ("A", "B")
    assert set(cm.packed_domain.tenants) == {"A", "B"}
    assert cm.service_info(hA)["attached"] is True
    with pytest.raises(ValueError, match="already attached"):
        cm.attach_service(hA)
    opt_b = cm.detach_service(hB)
    assert cm.attached == ("A",)
    assert set(cm.packed_domain.tenants) == {"A"}   # ranges reclaimed
    assert set(opt_b) == {"float32"} and set(opt_b["float32"]) == {"m"}
    assert opt_b["float32"]["m"].shape == cm.connect_service(
        hB).init_opt()["float32"]["m"].shape
    with pytest.raises(ValueError, match="not attached"):
        cm.detach_service(hB)
    cm.destroy_service(hA)                          # destroy detaches too
    assert cm.attached == ()
    assert cm.packed_domain is None


def test_attached_tenant_cannot_solo_push_pull():
    cm = PHubConnectionManager()
    (hA, _), _ = _two_tenants(cm)
    m, o = cm.init_service(hA)
    m, o, _ = cm.push_pull(hA, m, o, _batch(CFG))
    assert cm.service_info(hA)["cached_steps"] == 1
    cm.attach_service(hA, opt=o)
    # its solo steps held its solo gradient buffers: dropped at attach
    assert cm.service_info(hA)["cached_steps"] == 0
    with pytest.raises(RuntimeError, match="attached"):
        cm.push_pull(hA, m, o, _batch(CFG))


def test_co_step_requires_all_attached_handles():
    cm = PHubConnectionManager()
    (hA, _), (hB, _) = _two_tenants(cm)
    mA, _ = cm.init_service(hA)
    cm.attach_service(hA)
    cm.attach_service(hB)
    with pytest.raises(ValueError, match="exactly the attached"):
        cm.co_step([hA], {"A": mA}, {"A": _batch(CFG)})
    forged = ServiceHandle(namespace="B", nonce="0" * 16)
    with pytest.raises(PermissionError):
        cm.co_step([hA, forged], {"A": mA}, {"A": _batch(CFG)})


def test_co_step_without_attached_tenants():
    cm = PHubConnectionManager()
    with pytest.raises(ValueError, match="no tenants attached"):
        cm.co_step([], {}, {})


def test_attach_services_batch():
    """One re-pack for the whole batch; refusals before any change."""
    cm = PHubConnectionManager()
    (hA, _), (hB, _) = _two_tenants(cm)
    with pytest.raises(ValueError, match="already attached"):
        cm.attach_services([hA, hA])
    assert cm.attached == ()
    hX = _create(cm, "X", tc=dataclasses.replace(TC, strategy="allreduce"))
    with pytest.raises(ValueError, match="exchange_signature"):
        cm.attach_services([hA, hX])
    assert cm.attached == () and cm.packed_domain is None
    cm.attach_services([hA, hB])
    assert cm.attached == ("A", "B")
    assert set(cm.packed_domain.tenants) == {"A", "B"}


@pytest.mark.parametrize("field,value,exc,match", [
    ("strategy", "allreduce", ValueError, "exchange_signature"),
    ("pipeline_windows", 2, ValueError, "exchange_signature"),
    ("wire_format", "int8", ValueError, "wire_format"),
    ("flat_residency", True, NotImplementedError, "flat_residency"),
    ("overlap_backward", True, ValueError, "overlap_backward"),
], ids=["signature", "windows", "wire", "flat", "chunk-ready"])
def test_attach_rejects_incompatible_tenants(field, value, exc, match):
    cm = PHubConnectionManager()
    hA = _create(cm, "A")
    hB = _create(cm, "B", tc=dataclasses.replace(TC, **{field: value}))
    cm.attach_service(hA)
    with pytest.raises(exc, match=match):
        cm.attach_service(hB)
    assert cm.attached == ("A",)


def test_attach_rejects_another_dcn_wire_and_another_comm():
    cm = PHubConnectionManager()
    hier = dataclasses.replace(TC, strategy="hierarchical")
    hA = _create(cm, "A", tc=hier, comm=StackedComm(4, 2))
    hB = _create(cm, "B", tc=dataclasses.replace(hier,
                                                 wire_format_dcn="int8"),
                 comm=StackedComm(4, 2))
    hC = _create(cm, "C", tc=hier, comm=StackedComm(4, 4))
    cm.attach_service(hA)
    with pytest.raises(ValueError, match="wire_format_dcn"):
        cm.attach_service(hB)
    with pytest.raises(ValueError, match="different Comm"):
        cm.attach_service(hC)
    # an fsdp_stream service is created; it has no chunk domain to pack,
    # so attaching it raises, as the reference's does
    hD = _create(cm, "D", tc=dataclasses.replace(TC, strategy="fsdp_stream"))
    with pytest.raises(ValueError, match="chunk domain"):
        cm.attach_service(hD)
    assert cm.attached == ("A",)


def test_co_step_caches_and_accounts():
    cm = PHubConnectionManager()
    (hA, cfgA), (hB, cfgB) = _two_tenants(cm, StackedComm(2))
    models = {"A": cm.init_service(hA)[0], "B": cm.init_service(hB, 1)[0]}
    cm.attach_services([hA, hB])
    batches = {"A": _batch(cfgA), "B": _batch(cfgB, seed=2)}
    for _ in range(2):
        models, metrics = cm.co_step([hA, hB], models, batches)
    assert all(torch.isfinite(metrics[ns]["loss"]) for ns in ("A", "B"))
    acct = cm.accounting()
    assert acct["A"]["cumulative"]["steps"] == 2
    assert (acct["A"]["cumulative"]["push_bytes"]
            == 2 * acct["A"]["per_step"]["push_bytes"] > 0)
    assert acct["B"]["model_bytes"] > acct["A"]["model_bytes"]
    assert abs(acct["A"]["domain_share"] + acct["B"]["domain_share"]
               - 1.0) < 1e-9
    assert len(cm._co.steps) == 1
    cm.leave(1)
    models, _ = cm.co_step([hA, hB], models, batches)
    assert len(cm._co.steps) == 2                   # the live set re-keys
    cm.join(1)
    # attach/detach starts the layout's own cache; coming back to a layout
    # gets its steps back
    cm.detach_service(hB)
    assert len(cm._co.steps) == 0
    cm.attach_service(hB)
    assert len(cm._co.steps) == 2


def test_membership_calls_and_watchdog():
    cm = PHubConnectionManager()
    with pytest.raises(ValueError, match="no rack membership"):
        cm.leave(0)
    (hA, _), (hB, _) = _two_tenants(cm, StackedComm(4))
    assert cm.membership.n_live == 4
    cm.leave(3)
    cm.mark_slow(2, 4.0)
    assert cm.membership.n_live == 2
    cm.mark_recovered(2)
    cm.join(3)
    cm.demote(1)
    assert cm.membership.n_live == 3
    cm.join(1)
    assert cm.membership.all_live
    wd = ExchangeWatchdog(WatchdogConfig(retries=2, backoff_base_s=0.0,
                                         jitter=0.0))
    assert cm.set_watchdog(wd) is cm and cm.watchdog is wd
    models = {"A": cm.init_service(hA)[0], "B": cm.init_service(hB, 1)[0]}
    cm.attach_services([hA, hB])
    wd.inject_fault(TransientExchangeError("flaky link"), attempts=1)
    models, met = cm.co_step([hA, hB], models,
                             {"A": _batch(CFG), "B": _batch(CFG_B)})
    assert wd.pending_faults() == 0
    assert torch.isfinite(met["B"]["loss"])


def test_tenant_accounting_and_traffic():
    cm = PHubConnectionManager()
    handles = [_create(cm, f"job{i}",
                       reduced(get_arch("llama3.2-1b"), d_model=64 * (i + 1)),
                       dataclasses.replace(TC, lr=1e-2 * (i + 1)))
               for i in range(3)]
    cm.attach_services(handles)
    dom = cm.packed_domain
    assert dom.tenants == ("job0", "job1", "job2")
    (g,) = dom.groups.values()
    assert sum(s.total for s in g.slots) == sum(
        cm.connect_service(h).chunk_plan.groups[0].total for h in handles)
    acct = tenant_accounting(dom, "sharded_ps", 4)
    assert abs(sum(a["domain_share"] for a in acct.values()) - 1.0) < 1e-9
    t = tenant_step_traffic("sharded_ps", 100.0, 4)
    assert t["push_bytes"] == t["pull_bytes"] == 75.0
    assert tenant_step_traffic("centralized_ps", 100.0, 4)["push_bytes"] \
        == 100.0
    with pytest.raises(ValueError, match="unknown strategy"):
        tenant_step_traffic("ring", 1.0, 2)
    wire = WireFormat("int8")
    int8 = tenant_accounting(dom, "sharded_ps", 4, wire=wire)
    for ns, a in int8.items():
        assert a["wire_bytes"] == wire_bytes_for_groups(
            [(s.padded, g.dtype, g.chunk_elems) for s in g.slots
             if s.tenant == ns], wire)
        assert a["compression"] == a["model_bytes"] / a["wire_bytes"]
        assert a["padded_bytes"] / 4 < a["wire_bytes"] < \
            a["padded_bytes"] / 3.9            # int8 plus a scale a chunk
    cm.detach_service(handles[1])
    assert cm.packed_domain.tenants == ("job0", "job2")


# ------------------------------------------------------------- launcher

def test_launcher_co_schedules_tenants(capsys):
    from repro_torch.launch import train
    losses = train.main(["--reduced", "--device", "cpu", "--tenants", "2",
                         "--workers", "2", "--steps", "2", "--batch", "4",
                         "--seq", "16"])
    out = capsys.readouterr().out
    assert set(losses) == {"job0", "job1"}
    assert all(len(v) == 2 and all(x == x for x in v)
               for v in losses.values())
    assert losses["job0"] != losses["job1"]      # own seeds and lr
    assert "packed domain" in out and "aggregate tok/s" in out
    assert "job1: steps=2" in out


@pytest.mark.parametrize("flags,match", [
    (["--tenants", "2", "--supervise"], "--supervise drives a solo engine"),
    (["--tenants", "2", "--chaos"], "--elastic/--chaos"),
    (["--tenants", "2", "--checkpoint-dir", "ck"], "--checkpoint-dir"),
    (["--tenants", "0"], "--tenants must be >= 1")])
def test_launcher_refuses_what_tenants_cannot_honour(flags, match):
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match=match):
        train.main(["--reduced", "--device", "cpu"] + flags)
