"""``PHubClient`` on the card, reduced llama3.2-1b at f32 activations,
driven by an external PyTorch loop that treats ``DecoderLM`` as an
ordinary ``nn.Module``: its own forward and ``chunked_cross_entropy`` on
each worker's slice, ``torch.autograd.grad``, the stacked push, and only
the client.  They skip without a card.  This file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_client.py

1. Stacked, W = 4, 2 steps: tree mode, flat mode (the caller's own
   (W, padded) rows and a flat store the module's parameters are views
   of), the int8 wire in 2 windows, hierarchical 2 x 2 and a static
   3-of-4 membership each equal ``PHubEngine``'s step from the same seed
   and batches bitwise (losses and every parameter), with the engine's
   launches.
2. One worker: ``push_pull`` under Nesterov and SGD equals the tree-level
   ``make_optimizer`` update on the same gradients bitwise, Adam (eps
   1e-3) within ``ADAM_ATOL`` (the kernel's textbook EMAs against the
   protocol's residual form); one launch of the rule's kernel.
"""
import dataclasses
import hashlib

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import (PHubClient, PHubEngine, StackedComm,
                              module_tree, nest)
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import SyntheticTokens
from repro_torch.elastic import Membership
from repro_torch.kernels import agg_opt, quant
from repro_torch.models import DecoderLM, chunked_cross_entropy
from repro_torch.optim import make_optimizer
from repro_torch.training import TrainState, fit

pytestmark = pytest.mark.gpu

T, BATCH, STEPS, CHUNK_BYTES, DEAD = 64, 8, 2, 12 * 1024, 1
ADAM_ATOL = 1e-6
# (TrainConfig fields, pods, flat mode, dead worker)
PATHS = {"tree": ({}, 1, False, None),
         "flat": ({}, 1, True, None),
         "int8 in 2 windows": (dict(wire_format="int8", pipeline_windows=2),
                               1, False, None),
         "hierarchical 2x2": (dict(strategy="hierarchical"), 2, False, None),
         "3-of-4": ({}, 1, False, DEAD)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cfg():
    return dataclasses.replace(reduced(get_arch("llama3.2-1b")),
                               dtype="float32")


def _tc(**kw) -> TrainConfig:
    return TrainConfig(loss_chunk=T, chunk_size_bytes=CHUNK_BYTES, **kw)


def _digests(model) -> list:
    return [hashlib.sha1(t.detach().contiguous().view(-1).view(torch.uint8)
                         .cpu().numpy().tobytes()).hexdigest()
            for _, t in leaf_paths(model.param_tree())]


def _launches() -> dict:
    return {k: v for k, v in {**agg_opt.LAUNCHES, **quant.LAUNCHES}.items()
            if v}


def _reset():
    agg_opt.reset_launches()
    quant.reset_launches()


def engine_run(device, fields, pods, dead, steps=STEPS) -> dict:
    cfg, tc = _cfg(), _tc(**fields)
    engine = PHubEngine(cfg, tc, StackedComm(4, pods), device=device)
    model, opt = engine.init_state()
    members = None if dead is None else Membership.full(4).leave(dead)
    _reset()
    state = fit(engine, TrainState(params=model, opt=opt),
                SyntheticTokens(cfg, BATCH, T, seed=tc.seed), steps=steps,
                log_every=0, hooks=[lambda s, m: None],
                membership_fn=None if dead is None else lambda i: members)
    return {"losses": state.losses, "digests": _digests(model),
            "launches": _launches()}


def client_run(device, fields, pods, flat, dead, steps=STEPS) -> dict:
    """The external loop: the model, its loss and its backward are the
    caller's; the exchange is ``PHubClient``'s."""
    cfg, tc = _cfg(), _tc(**fields)
    W = 4
    gen = torch.Generator(device=device)
    gen.manual_seed(tc.seed)
    model = DecoderLM(cfg, device=device, generator=gen)
    client = PHubClient(tc, StackedComm(W, pods), device=device).register(
        module_tree(model))
    if dead is not None:
        client.set_membership(Membership.full(W).leave(dead))
    opt = client.init_state()
    names, params = zip(*model.named_parameters())
    data = SyntheticTokens(cfg, BATCH, T, seed=tc.seed)
    if flat:
        pstore = client.flatten(module_tree(model))
        gstore = {k: torch.zeros((W,) + v.shape, device=device)
                  for k, v in pstore.items()}
    else:
        push = {n: torch.empty((W,) + p.shape, device=device)
                for n, p in zip(names, params)}
    _reset()
    losses = []
    for i in range(steps):
        if flat:                       # the parameters: views of the store
            views = dict(leaf_paths(client.unflatten(pstore)))
            with torch.no_grad():
                for path, p in leaf_paths(module_tree(model)):
                    p.data = views[path]
        batch = data.torch_batch(i, device)
        bw = BATCH // W
        step_losses = []
        for w in range(W):
            sl = slice(w * bw, (w + 1) * bw)
            x = model(batch["tokens"][sl], remat=tc.remat)
            loss = chunked_cross_entropy(x, model.lm_head_weight(),
                                         batch["labels"][sl],
                                         chunk=tc.loss_chunk)
            grads = torch.autograd.grad(loss, params)
            if flat:
                client.flatten(_tree(names, grads),
                               out={k: v[w] for k, v in gstore.items()})
            else:
                for n, g in zip(names, grads):
                    push[n][w].copy_(g)
            del grads
            step_losses.append(loss.detach())
        losses.append(float(torch.stack(step_losses).mean()))
        if flat:
            pstore, opt = client.push_pull_flat(gstore, pstore, opt)
        else:
            _, opt = client.push_pull(_tree(names, [push[n] for n in names]),
                                      module_tree(model), opt)
    if flat:
        views = dict(leaf_paths(client.unflatten(pstore)))
        with torch.no_grad():
            for path, p in leaf_paths(module_tree(model)):
                p.data = views[path]
    return {"losses": losses, "digests": _digests(model),
            "launches": _launches()}


def _tree(names, tensors) -> dict:
    return nest(zip(names, tensors))


@pytest.mark.parametrize("path", list(PATHS))
def test_stacked_client_equals_the_engine(path):
    _need_card()
    fields, pods, flat, dead = PATHS[path]
    want = engine_run("cuda", fields, pods, dead)
    got = client_run("cuda", fields, pods, flat, dead)
    assert got["losses"] == want["losses"]
    assert got["digests"] == want["digests"]
    assert got["launches"] == want["launches"] and got["launches"]


def one_worker(device, rule) -> tuple:
    """(the client's parameters, make_optimizer's, the launches) after one
    step of one worker from the same gradients."""
    cfg = _cfg()
    tc = _tc(optimizer=rule, adam_eps=1e-3,
             **({"lr": 3e-4} if rule == "adam" else {}))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    model = DecoderLM(cfg, device=device, generator=gen)
    batch = SyntheticTokens(cfg, 2, T, seed=0).torch_batch(0, device)
    names, params = zip(*model.named_parameters())
    x = model(batch["tokens"], remat=tc.remat)
    loss = chunked_cross_entropy(x, model.lm_head_weight(), batch["labels"],
                                 chunk=tc.loss_chunk)
    grads = torch.autograd.grad(loss, params)
    init, update = make_optimizer(tc)
    ref = _tree(names, [p.detach().clone() for p in params])
    ref, _ = update(ref, _tree(names, grads), init(ref))
    client = PHubClient(tc, StackedComm(1), device=device).register(
        module_tree(model))
    _reset()
    client.push_pull(_tree(names, [g[None] for g in grads]),
                     module_tree(model), client.init_state())
    return (dict(leaf_paths(module_tree(model))), dict(leaf_paths(ref)),
            _launches())


@pytest.mark.parametrize("rule", ["nesterov", "sgd", "adam"])
def test_one_worker_equals_make_optimizer(rule):
    _need_card()
    got, want, launches = one_worker("cuda", rule)
    kernel = {"nesterov": "agg_opt_chunks", "sgd": "sgd_opt_chunks",
              "adam": "adam_opt_chunks"}[rule]
    assert launches == {kernel: 1}
    for path, a in got.items():
        b = want[path]
        if rule == "adam":
            assert float((a - b).abs().max()) <= ADAM_ATOL, path
        else:
            assert torch.equal(a, b), path
