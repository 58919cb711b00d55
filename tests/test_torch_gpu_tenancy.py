"""The co-scheduled rack on the card: ``PHubConnectionManager.co_step`` of
two reduced llama3.2-1b tenants (f32 activations, different lr and
momentum, their own batches) against each tenant trained alone by the
same manager, and the kernel form of the combined update against the
plain versions.  They skip without a card.  This file imports no JAX, so
it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_tenancy.py

1. Stacked W = 4, 2 steps: sharded_ps in 1 and 2 windows, hierarchical
   2 x 2, a 3-of-4 membership, Nesterov + SGD; W = 2: Nesterov + Adam.
   Every tenant equals its solo run bitwise (losses and parameters), and
   each rule's kernel launched exactly once on each (strip, tenant run)
   intersection, as ``launches`` predicts from the packed layout.
2. The int8 wire: the co-step in 2 windows equals 1 window bitwise; the
   tail kernel launched once on each (window row, Nesterov run).
3. ``RunUpdate`` on a window strip equals the plain versions on the CPU
   bitwise (Nesterov stacked and pre-aggregated, SGD, Adam, the int8
   tail), pad runs copied through; the table form refuses the card.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubConnectionManager, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.core.pipeline import effective_windows
from repro_torch.core.wire import WireFormat
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import agg_opt, quant
from repro_torch.optim import protocol

pytestmark = pytest.mark.gpu

T, BATCH, STEPS = 64, 8, 2
CHUNK = 2048                    # 2 windows take effect at S = 4
KERNEL = {("nesterov", True): "multi_agg_opt_chunks",
          ("nesterov", False): "agg_opt_chunks",
          ("sgd", True): "sgd_opt_chunks", ("sgd", False): "sgd_opt_chunks",
          ("adam", True): "adam_opt_chunks",
          ("adam", False): "adam_opt_chunks"}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cfg(d_model):
    return dataclasses.replace(reduced(get_arch("llama3.2-1b"),
                                       d_model=d_model), dtype="float32")


CFGS = {"A": _cfg(128), "B": _cfg(256)}


def _tcs(rule_b="nesterov", **kw):
    a = TrainConfig(**dict(dict(lr=3e-2, momentum=0.9, loss_chunk=T,
                                chunk_size_bytes=CHUNK), **kw))
    return {"A": a, "B": dataclasses.replace(a, lr=1e-2, momentum=0.8,
                                             optimizer=rule_b, seed=1)}


def _batch(ns):
    return SyntheticTokens(CFGS[ns], BATCH, T, seed=ord(ns)).torch_batch(
        0, "cuda")


def launches(domain, windows: int, rules: dict, stacked: bool,
             tail: bool = False) -> dict:
    """Each kernel's launches a step: one per (window strip of a shard,
    tenant run) that meet (the tail kernel for the Nesterov runs of an
    int8 step)."""
    out: dict = {}
    for g in domain.groups.values():
        L = g.shard_len
        Lw = L // windows
        for s in g.slots:
            name = ("dequant_agg_opt_chunks" if tail else
                    KERNEL[rules[s.tenant], stacked])
            for _, off, n in s.runs:
                for j in range(g.n_shards):
                    for w in range(windows):
                        lo = j * L + w * Lw
                        if off < lo + Lw and lo < off + n:
                            out[name] = out.get(name, 0) + 1
    return out


def _solo(ns, tc, comm, dead):
    cm = PHubConnectionManager()
    h = cm.create_service(ns, CFGS[ns], tc, comm)
    if dead is not None:
        cm.leave(dead)
    m, o = cm.init_service(h)
    losses = []
    for _ in range(STEPS):
        m, o, met = cm.push_pull(h, m, o, _batch(ns))
        losses.append(float(met["loss"]))
    return m, losses


def _co(tcs, comm, dead):
    cm = PHubConnectionManager()
    hs, models = [], {}
    for ns, tc in tcs.items():
        h = cm.create_service(ns, CFGS[ns], tc, comm)
        models[ns] = cm.init_service(h)[0]
        hs.append(h)
    if dead is not None:
        cm.leave(dead)
    cm.attach_services(hs)
    losses = {ns: [] for ns in tcs}
    agg_opt.ops.reset_launches()
    quant.ops.reset_launches()
    for _ in range(STEPS):
        models, met = cm.co_step(hs, models, {ns: _batch(ns) for ns in tcs})
        for ns in tcs:
            losses[ns].append(float(met[ns]["loss"]))
    counts = {k: v for k, v in {**agg_opt.ops.LAUNCHES,
                                **quant.ops.LAUNCHES}.items() if v}
    return models, losses, cm, counts


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for (_, x), (_, y) in zip(
        leaf_paths(a.param_tree()), leaf_paths(b.param_tree())))


CASES = {"sharded_ps": (4, 1, {}, "nesterov", None),
         "sharded_ps in 2 windows": (4, 1, dict(pipeline_windows=2),
                                     "nesterov", None),
         "hierarchical 2x2": (4, 2, dict(strategy="hierarchical"),
                              "nesterov", None),
         "3-of-4": (4, 1, {}, "nesterov", 3),
         "nesterov+sgd": (4, 1, {}, "sgd", None),
         "nesterov+adam W=2": (2, 1, dict(adam_eps=1e-3), "adam", None)}


@pytest.mark.parametrize("name", list(CASES))
def test_cuda_co_step_equals_each_tenant_alone(name):
    _need_card()
    W, pods, kw, rule_b, dead = CASES[name]
    comm = StackedComm(W, pods)
    tcs = _tcs(rule_b, **kw)
    models, losses, cm, counts = _co(tcs, comm, dead)
    for ns, tc in tcs.items():
        m, solo_losses = _solo(ns, tc, comm, dead)
        assert losses[ns] == solo_losses, ns
        assert _same(models[ns], m), ns
    windows = kw.get("pipeline_windows", 1)
    assert effective_windows(cm.packed_domain.groups["float32"],
                             windows) == windows
    want = launches(cm.packed_domain, windows,
                    {ns: tc.optimizer for ns, tc in tcs.items()}, W > 1)
    assert counts == {k: v * STEPS for k, v in want.items()}


def test_cuda_int8_co_step_in_two_windows_equals_one():
    _need_card()
    out = []
    for windows in (1, 2):
        tcs = _tcs(wire_format="int8", pipeline_windows=windows)
        models, losses, cm, counts = _co(tcs, StackedComm(4), None)
        assert effective_windows(cm.packed_domain.groups["float32"],
                                 windows) == windows
        want = launches(cm.packed_domain, windows,
                        {ns: "nesterov" for ns in tcs}, True, tail=True)
        assert counts["dequant_agg_opt_chunks"] == \
            want["dequant_agg_opt_chunks"] * STEPS
        out.append((models, losses))
    assert out[0][1] == out[1][1]
    for ns in CFGS:
        assert _same(out[0][0][ns], out[1][0][ns]), ns


def _strip_case(rule, stacked, seed=0):
    """A packed group of 3 shards of 4 chunks: A 0-2, B 3 | B 4-5, A 6-7 |
    A 8-9, pad 10-11 (chunks of 128), inputs drawn on the CPU."""
    from repro_torch.core.chunking import (PackedGroup, TenantSlot)
    ce = 128
    layout = (("A", 0, 3 * ce), ("B", 0, ce), ("B", ce, 2 * ce),
              ("A", 3 * ce, 2 * ce), ("A", 5 * ce, 2 * ce), (None, 0, 2 * ce))
    runs, off = {"A": [], "B": []}, 0
    for t, toff, n in layout:
        if t:
            runs[t].append((toff, off, n))
        off += n
    g = PackedGroup(dtype=torch.float32, chunk_elems=ce, n_shards=3,
                    shard_len=4 * ce, padded=12 * ce,
                    slots=tuple(TenantSlot(t, 5 * ce if t == "A" else 3 * ce,
                                           7 * ce if t == "A" else 3 * ce,
                                           tuple(r))
                                for t, r in runs.items()), layout=layout)
    opt = {"nesterov": protocol.NesterovOptimizer(),
           "sgd": protocol.SGDOptimizer(),
           "adam": protocol.AdamOptimizer(eps=1e-3)}[rule]
    union = protocol.union_slots([opt])
    bindings = [protocol.RuleBinding(
        opt=opt, slot_idx=tuple(range(len(union))),
        coefs=(0.05, 0.9)[:len(opt.coef_names)] if ns == "A" else
        (0.02, 0.5)[:len(opt.coef_names)],
        runs=tuple((poff, n) for _, poff, n in g.slot(ns).runs))
        for ns in ("A", "B")]
    gen = torch.Generator().manual_seed(seed)
    n = g.padded
    p = torch.randn(n, generator=gen)
    gr = torch.randn((4, n) if stacked else (n,), generator=gen)
    slots = [torch.randn(n, generator=gen).abs() if s.name != "m" else
             torch.randn(n, generator=gen) for s in union]
    return g, bindings, p, gr, slots


@pytest.mark.parametrize("rule,stacked", [("nesterov", True),
                                          ("nesterov", False),
                                          ("sgd", True), ("adam", True)])
def test_cuda_run_update_equals_the_plain_versions(rule, stacked):
    _need_card()
    g, bindings, p, gr, slots = _strip_case(rule, stacked)
    sl = slice(5 * 128, 7 * 128)       # shard 1's strip: B's tail, A's head
    out = {}
    for dev in ("cpu", "cuda"):
        upd = protocol.make_run_update(bindings, g)
        # copies: the CPU run updates its slots in place
        pd, gd = p.to(dev, copy=True), gr.to(dev, copy=True)
        sd = tuple(s.to(dev, copy=True) for s in slots)
        p_out = torch.full_like(pd, 7.0)
        agg_opt.ops.reset_launches()
        upd(pd[sl], gd[..., sl], tuple(s[sl] for s in sd),
            p_out=p_out[sl], at=sl.start)
        out[dev] = (p_out.cpu(), tuple(s.cpu() for s in sd),
                    sum(agg_opt.ops.LAUNCHES.values()))
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    for a, b in zip(out["cpu"][1], out["cuda"][1]):
        assert torch.equal(a, b)
    assert out["cuda"][2] == 2 and out["cpu"][2] == 0


def test_cuda_run_update_int8_tail_and_pad():
    _need_card()
    g, bindings, p, gr, slots = _strip_case("nesterov", True, seed=1)
    wire, ce = WireFormat("int8"), g.chunk_elems
    sl = slice(8 * 128, 12 * 128)       # shard 2: A's last run, then pad
    out = {}
    for dev in ("cpu", "cuda"):
        tail = protocol.make_run_update(bindings, g).dequant(0.25)
        parts = wire.encode(gr[1, sl].to(dev), ce)
        pd = p.to(dev, copy=True)
        m = slots[0].to(dev, copy=True)
        p_out = torch.full_like(pd, 7.0)
        agg_opt.ops.reset_launches()
        tail(pd[sl], parts, gr[0, sl].to(dev), (m[sl],), p_out=p_out[sl],
             at=sl.start)
        out[dev] = (p_out.cpu(), m.cpu(),
                    agg_opt.ops.LAUNCHES["dequant_agg_opt_chunks"])
    assert torch.equal(out["cpu"][0], out["cuda"][0])
    assert torch.equal(out["cpu"][1], out["cuda"][1])
    assert out["cuda"][2] == 1
    pad = slice(10 * 128, 12 * 128)
    assert torch.equal(out["cuda"][0][pad], p[pad])       # copied through
    assert torch.equal(out["cuda"][1][pad], slots[0][pad])


def test_cuda_table_form_is_refused():
    _need_card()
    upd = protocol.make_combined_update([protocol.RuleBinding(
        opt=protocol.SGDOptimizer(), slot_idx=(), coefs=(0.1,))])
    x = torch.zeros(8, device="cuda")
    with pytest.raises(ValueError, match="CPU tensors"):
        upd(x, x, ())
