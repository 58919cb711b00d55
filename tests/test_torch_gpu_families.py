"""The other model families on the card against the same computation on
the CPU (plain versions), at reduced size: grok-1-314b and arctic-480b
(experts at capacity factor 0.5, so every layer drops assignments),
hymba-1.5b (4 layers, windows [0, 64, 64, 0]; and with hymba's 5 query
heads a KV head, 10/2 at d_model 320), internvl2-2b and musicgen-medium
(a prefix of frontend embeddings drawn on the CPU and copied).  The tests
skip without a card.  This file imports no JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_families.py

Activations are f32, so the two devices differ by summation order only
and a router's choice cannot flip on a bf16 rounding.  Bounds, those of
``chip_smoke.py``'s reduced phases: one 2-worker Nesterov step's loss
within 1e-3, parameters within 1e-4, momentum within 1e-2; serving logits
(prefill and 4 teacher-forced decode steps) within 5e-3 of the largest
logit, the cache's positions equal.  Two card runs give the same bits
(the experts' scatter and gather are deterministic).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm
from repro_torch.core.chunking import leaf_paths
from repro_torch.data import PrefixedTokens, SyntheticTokens
from repro_torch.kernels import agg_opt, decode_attn, swa_attn
from repro_torch.models import DecoderLM

pytestmark = pytest.mark.gpu

CASES = ["grok-1-314b", "arctic-480b", "hymba-1.5b", "hymba-1.5b 10/2",
         "internvl2-2b", "musicgen-medium"]
W, B, T, PROMPT, STEPS = 2, 8, 64, 40, 4
SERVE_TOL = 5e-3


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cfg(case: str):
    arch, *heads = case.split()
    cfg = get_arch(arch)
    if cfg.family == "hybrid":
        d = 320 if heads else 256
        cfg = dataclasses.replace(reduced(cfg, layers=4, d_model=d),
                                  global_layer_every=3)
        if heads:
            nh, kv = (int(x) for x in heads[0].split("/"))
            cfg = dataclasses.replace(cfg, n_heads=nh, n_kv_heads=kv,
                                      head_dim=d // nh)
    else:
        cfg = reduced(cfg)
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    return dataclasses.replace(cfg, dtype="float32")


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict)
            else v.detach().clone().to(device) for k, v in tree.items()}


def _setup(case):
    cfg = _cfg(case)
    tc = TrainConfig(loss_chunk=64)
    eng_c = PHubEngine(cfg, tc, StackedComm(W), device="cpu")
    model_c = eng_c.init_model()
    return cfg, tc, eng_c, model_c, _tree_to(model_c.param_tree(), "cpu")


@pytest.mark.parametrize("case", CASES)
def test_step_card_vs_cpu_and_twice_bitwise(case):
    _need_card()
    cfg, tc, eng_c, model_c, init = _setup(case)
    eng_g = PHubEngine(cfg, tc, StackedComm(W), device="cuda")
    data = (PrefixedTokens if cfg.frontend else SyntheticTokens)(cfg, B, T)
    batch_c = data.torch_batch(0, "cpu")
    batch_g = {k: v.to("cuda") for k, v in batch_c.items()}
    agg_opt.reset_launches()
    runs = []
    for _ in range(2):
        model_g = DecoderLM(cfg, device="cuda", params=_tree_to(init, "cuda"))
        _, opt_g, met_g = eng_g.make_train_step()(model_g, eng_g.init_opt(),
                                                  batch_g)
        runs.append((model_g, opt_g, met_g))
    assert agg_opt.LAUNCHES["multi_agg_opt_chunks"] == 2
    _, opt_c, met_c = eng_c.make_train_step()(model_c, eng_c.init_opt(),
                                              batch_c)
    (ma, oa, mea), (mb, ob, meb) = runs
    assert torch.equal(mea["loss"], meb["loss"])
    for (_, a), (_, b) in zip(leaf_paths(ma.param_tree()),
                              leaf_paths(mb.param_tree())):
        assert torch.equal(a, b)
    for k in oa:
        assert torch.equal(oa[k]["m"], ob[k]["m"])
    assert abs(float(met_c["loss"]) - float(mea["loss"])) <= 1e-3
    for (p, a), (_, b) in zip(leaf_paths(ma.param_tree()),
                              leaf_paths(model_c.param_tree())):
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= 1e-4, p
    for k in oa:
        assert float((oa[k]["m"].cpu() - opt_c[k]["m"]).abs().max()) <= 1e-2


@pytest.mark.parametrize("case", CASES)
def test_serving_card_vs_cpu_and_twice_bitwise(case):
    _need_card()
    cfg, tc, _, _, init = _setup(case)
    tok = torch.from_numpy(SyntheticTokens(cfg, 2, PROMPT + STEPS, seed=7)
                           .batch_at(0)["tokens"]).long()
    extra = (PrefixedTokens(cfg, 2, PROMPT, seed=7).torch_batch(
        0, "cpu")["extra_embeds"] if cfg.frontend else None)

    def serve(device):
        engine = PHubEngine(cfg, tc, StackedComm(1), device=device)
        model = DecoderLM(cfg, device=device, params=_tree_to(init, device))
        logits, cache = engine.make_prefill_step(PROMPT, STEPS)(
            model, tok[:, :PROMPT].to(device),
            None if extra is None else extra.to(device))
        out = [logits.cpu()]
        step = engine.make_serve_step()
        for i in range(STEPS):
            logits, cache = step(
                model, cache, tok[:, PROMPT + i:PROMPT + i + 1].to(device))
            out.append(logits.cpu())
        return out, cache

    want, cache_c = serve("cpu")
    swa_attn.reset_launches()
    decode_attn.reset_launches()
    got, cache_g = serve("cuda")
    again, _ = serve("cuda")
    L = cfg.n_layers
    assert swa_attn.LAUNCHES["swa_attention_kernel"] == 2 * L
    assert decode_attn.LAUNCHES["decode_attention_kernel"] == 2 * L * STEPS
    for g, w, a in zip(got, want, again):
        assert float((g - w).abs().max() / w.abs().max()) <= SERVE_TOL
        assert torch.equal(g, a)
    assert torch.equal(cache_g["pos"].cpu(), cache_c["pos"])
    if "ssm_S" in cache_g:
        assert cache_g["ssm_S"].dtype == torch.float32
        assert float((cache_g["ssm_S"].cpu() - cache_c["ssm_S"]).abs().max()
                     / cache_c["ssm_S"].abs().max()) <= SERVE_TOL
