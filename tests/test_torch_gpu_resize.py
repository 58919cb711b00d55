"""The elastic rack resize on the card: ``PHubConnectionManager.resize`` of
reduced llama3.2-1b services (Adam over the int8 wire in 2 windows, 1 KB
chunks), the state moving on the card.  They skip without a card.  This
file imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_resize.py

1. Solo, caller-held state, 8 -> 6 -> 8 after 2 steps: every slot (m, v,
   k1, k2, wire_ef) bitwise equal to its pre-resize value on the live
   region, on the card; the epoch is 2; the steps after launch the rule's
   and the codec's kernels and give a finite loss.
2. Padtail: a round trip between steps 2 and 3 of a 4-step run equals the
   run that never resized, on the full buffers (pad included); Adam's k1
   and k2 hold exactly 0 on the dead tail.
3. Two co-scheduled tenants, 8 -> 6 -> 8: after detach each tenant's slots
   equal their pre-resize values on the live region, ``moved_bytes`` > 0,
   and a co-step afterwards is finite.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubConnectionManager, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import agg_opt, quant

pytestmark = pytest.mark.gpu

B, T, CHUNK = 24, 32, 1024
SLOTS = ("m", "v", "k1", "k2", "wire_ef")
D_MODELS = {"A": 64, "B": 128}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cfg(d_model=64):
    return dataclasses.replace(reduced(get_arch("llama3.2-1b"),
                                       d_model=d_model), dtype="float32")


def _tc(**kw):
    return TrainConfig(**dict(dict(optimizer="adam", lr=1e-3, loss_chunk=32,
                                   pipeline_windows=2, wire_format="int8",
                                   chunk_size_bytes=CHUNK), **kw))


def _batch(cfg, seed=0):
    return SyntheticTokens(cfg, B, T, seed=seed).torch_batch(0, "cuda")


def _live(eng, opt) -> dict:
    (g,) = eng.chunk_plan.groups
    return {n: v.reshape(-1, g.padded)[:, :g.live_elems].clone()
            for n, v in opt[g.key].items()}


def test_solo_resize_on_the_card():
    _need_card()
    cfg = _cfg()
    cm = PHubConnectionManager()
    h = cm.create_service("job", cfg, _tc(), StackedComm(8), device="cuda")
    m, o = cm.init_service(h)
    for _ in range(2):
        m, o, _ = cm.push_pull(h, m, o, _batch(cfg))
    pre = _live(cm.connect_service(h), o)
    assert float(pre["wire_ef"].abs().max()) > 0
    for world in (6, 8):
        m, o = cm.resize(StackedComm(world), states={"job": (m, o)})["job"]
        assert all(v.is_cuda for v in o["float32"].values())
    post = _live(cm.connect_service(h), o)
    for n in SLOTS:
        assert torch.equal(post[n], pre[n]), n
    assert cm.membership.epoch == 2
    agg_opt.reset_launches()
    quant.reset_launches()
    m, o, met = cm.push_pull(h, m, o, _batch(cfg))
    assert torch.isfinite(met["loss"]).item()
    assert agg_opt.LAUNCHES["adam_opt_chunks"] > 0
    assert quant.LAUNCHES["quantize_chunks"] > 0


def test_padtail_round_trip_on_the_card():
    _need_card()
    cfg = _cfg()

    def run(resize):
        cm = PHubConnectionManager()
        h = cm.create_service("pad", cfg, _tc(), StackedComm(8),
                              device="cuda")
        m, o = cm.init_service(h)
        for i in range(4):
            if resize and i == 2:
                s = cm.resize(StackedComm(6), states={"pad": (m, o)})
                m, o = cm.resize(StackedComm(8), states=s)["pad"]
            m, o, _ = cm.push_pull(h, m, o, _batch(cfg))
        return cm.connect_service(h), m, o

    eng, m0, o0 = run(False)
    (g,) = eng.chunk_plan.groups
    for n in ("k1", "k2"):
        assert not o0["float32"][n].reshape(-1, g.padded)[
            :, g.live_elems:].any(), n
    _, m1, o1 = run(True)
    for n in SLOTS:
        assert torch.equal(o1["float32"][n], o0["float32"][n]), n
    for (_, a), (_, b) in zip(leaf_paths(m0.param_tree()),
                              leaf_paths(m1.param_tree())):
        assert torch.equal(a, b)


def test_co_resize_on_the_card():
    _need_card()
    cm = PHubConnectionManager()
    hs, models, opts = [], {}, {}
    for ns, dm in D_MODELS.items():
        h = cm.create_service(ns, _cfg(dm), _tc(lr=1e-3 * (1 + len(hs))),
                              StackedComm(8), device="cuda")
        models[ns], o = cm.init_service(h)
        for _ in range(2):
            models[ns], o, _ = cm.push_pull(h, models[ns], o,
                                            _batch(_cfg(dm)))
        opts[ns] = o
        hs.append(h)
    pre = {h.namespace: _live(cm.connect_service(h), opts[h.namespace])
           for h in hs}
    cm.attach_services(hs, opts)
    opts = {}
    cm.resize(StackedComm(6))
    assert cm.last_rebalance["co"]["moved_bytes"] > 0
    cm.resize(StackedComm(8))
    for h in hs:
        opts[h.namespace] = cm.detach_service(h)
        post = _live(cm.connect_service(h), opts[h.namespace])
        for n in SLOTS:
            assert torch.equal(post[n], pre[h.namespace][n]), \
                (h.namespace, n)
    cm.attach_services(hs, opts)
    models, met = cm.co_step(hs, models, {ns: _batch(_cfg(dm))
                                          for ns, dm in D_MODELS.items()})
    assert all(torch.isfinite(v["loss"]).item() for v in met.values())
