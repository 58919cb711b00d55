"""The exchange autotuner on the card, at reduced size (llama3.2-1b at
d_model 256, 4 stacked workers).  They skip without a card.  This file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_tune.py

1. Two candidates (sharded_ps identity in 2 windows; hierarchical 2x2 with
   an int8 DCN tier) timed on the card (``time_candidate``) and
   lint-gated green (R1, R3, R5), the rule's kernels launched.
2. The stacked Comm's recorded traffic of one zero-compute step equals
   ``cost_model.predicted_exchange_traffic`` within 2% for every kind and
   tier, over the identity, int8 and DCN paths.
"""
import pytest
import torch

from repro_torch import telemetry
from repro_torch.analysis import artifact_from_engine, lint_tuned_config
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.core import PHubEngine, StackedComm, cost_model
from repro_torch.kernels import agg_opt, quant
from repro_torch.models import param_specs
from repro_torch.tuning import Candidate, time_candidate

pytestmark = pytest.mark.gpu

D_MODEL = 256
# at d_model 256: 24 KB chunks split the shard in 2 windows, 16 KB in 3
CANDS = (Candidate("sharded_ps", 2, "identity", None, 24 * 1024, 1, 4),
         Candidate("hierarchical", 1, "identity", "int8", 8 * 1024, 2, 2),
         Candidate("sharded_ps", 4, "int8", None, 16 * 1024, 1, 4))


@pytest.fixture(autouse=True)
def _null_telemetry():
    yield
    telemetry.disable()


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _cfg():
    return reduced(get_arch("llama3.2-1b"), d_model=D_MODEL)


@pytest.mark.parametrize("c", CANDS[:2], ids=lambda c: c.strategy)
def test_candidate_times_and_lints_green_on_the_card(c):
    _need_card()
    agg_opt.reset_launches()
    quant.reset_launches()
    us = time_candidate(param_specs(_cfg()), c, steps=3, warmup=1,
                        device="cuda")
    assert us > 0
    # 4 push_pulls, at least one launch of the rule's kernel each; the
    # DCN tier's codec on every one
    assert agg_opt.LAUNCHES["multi_agg_opt_chunks"] >= 4
    if c.wire_format_dcn:
        assert quant.LAUNCHES["quantize_chunks"] >= 4
    cand = {**c.to_dict(), "arch": "llama3.2-1b", "d_model": D_MODEL}
    verdict, diags = lint_tuned_config(cand, device="cuda")
    assert verdict["ok"], verdict["errors"]
    assert verdict["rules"] == ["R1", "R3", "R5"]
    assert verdict["config"]["extra_bytes"] is not None


@pytest.mark.parametrize("c", CANDS, ids=lambda c: f"{c.strategy}-"
                         f"{c.wire_format}-{c.wire_format_dcn}")
def test_recorded_traffic_matches_the_cost_model(c):
    _need_card()
    eng = PHubEngine(_cfg(), TrainConfig(**c.tc_kwargs()),
                     StackedComm(c.n_workers, c.pods), device="cuda")
    art = artifact_from_engine(eng, "gpu")
    pred = cost_model.predicted_exchange_traffic(
        art.groups, strategy=art.strategy, wire=art.wire,
        windows=art.windows, n_workers=art.n_workers,
        pod_size=art.pod_size, wire_dcn=art.wire_dcn)["runtime_by_kind"]
    got = eng.comm.link_bytes()
    assert set(got) == set(pred)
    for kind, tiers in pred.items():
        for tier, want in tiers.items():
            assert abs(got[kind][tier] - want) <= 0.02 * want, (kind, tier)
