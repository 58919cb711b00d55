"""The autotuner's launchers on the CPU (``repro_torch/launch/tune.py``,
``launch/train.py --auto-tune``), the port's default artifact paths, and
the small copies A9b names (``launch/mesh.py``, ``configs/shapes.py``,
``configs/phub_paper.py``).

1. ``launch/tune.py --device cpu --cache-dir <tmp>`` on a tiny model:
   ``--calibrate`` measures and saves this device's topology beside the
   cache and tunes; a second call hits the cache; without a calibration a
   miss exits naming ``--calibrate``.
2. ``launch/train.py --auto-tune`` on a seeded ``<tmp>`` cache trains with
   the winner's config and layout (hierarchical 2x2 over an int8 DCN
   tier) and equals, losses and parameters bitwise, the same run with
   those flags given directly; a miss tunes on the saved calibration; a
   winner that is not lint-green is refused; ``--nproc`` is refused
   (ROADMAP.md queue A item 4b).
3. The port's defaults (the tuning cache, the launchers'
   ``--telemetry-out``) resolve under ``results/torch/``, gitignored, and
   never under the ``results/`` directories of the reference's tracked
   files.

Every output directory is ``tmp_path``; the reference's launchers are not
run.
"""
import importlib
import json
import os

import pytest
import torch

from repro_torch import telemetry
from repro_torch.configs import TrainConfig, get_arch, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch import tune as tune_cli
from repro_torch.models import param_specs
from repro_torch.paths import ARTIFACT_DIR, ROOT
from repro_torch.tuning import (DEFAULT_CACHE_DIR, Candidate, cache_key,
                                store_winner)

TUNE = ["--device", "cpu", "--devices", "2", "--d-model", "64",
        "--steps", "1", "--top-k", "2"]
TRAIN = ["--reduced", "--device", "cpu", "--workers", "4", "--steps", "2",
         "--batch", "4", "--seq", "16", "--log-every", "1"]
WINNER = Candidate("hierarchical", 2, "identity", "int8", 8 * 1024, 2, 2)
REFERENCE_DIRS = ("tuning", "telemetry", "lint", "dryrun")


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


@pytest.fixture
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


# ------------------------------------------------------------ launch/tune

@pytest.fixture
def small_probes(monkeypatch):
    """The calibration probes at 4096 elements a row (2^26 on the card)."""
    monkeypatch.setattr(importlib.import_module(
        "repro_torch.tuning.calibrate"), "CARD_PROBE_ELEMS", 4096)


def test_tune_cli_calibrates_tunes_and_hits_the_cache(tmp_path, capsys,
                                                      small_probes):
    d = str(tmp_path)
    with pytest.raises(SystemExit, match="--calibrate"):
        tune_cli.main(TUNE + ["--cache-dir", d])
    out = str(tmp_path / "report.json")
    rep = tune_cli.main(TUNE + ["--cache-dir", d, "--calibrate", "--out",
                                out])
    assert not rep["cache_hit"] and rep["timed_candidates"] >= 2
    assert rep["lint"]["ok"] and rep["device"] == "cpu"
    assert rep["candidate"]["pods"] * rep["candidate"]["data"] == 2
    with open(out) as f:
        assert json.load(f)["key"] == rep["key"]
    with open(os.path.join(d, "calibration_2w.json")) as f:
        rec = json.load(f)
    assert rec["card"] == "cpu" and rec["devices"] == 2
    assert rec["topology"]["bw_dcn"] == rec["topology"]["bw_ici"]
    again = tune_cli.main(TUNE + ["--cache-dir", d])
    assert again["cache_hit"] and again["timed_candidates"] == 0
    assert again["candidate"] == rep["candidate"]
    # a forced re-tune ranks on the saved calibration
    forced = tune_cli.main(TUNE + ["--cache-dir", d, "--force"])
    assert not forced["cache_hit"]
    text = capsys.readouterr().out
    assert "[tune] winner (cache)" in text and "lint=OK" in text


# ----------------------------------------------------- train --auto-tune

def _seed(d: str, cand: Candidate, ok: bool = True) -> str:
    cfg = reduced(get_arch("llama3.2-1b"))
    tc = TrainConfig(loss_chunk=16)
    key = cache_key(tc, cand.n_workers, param_specs(cfg), "cpu")
    store_winner(key, {"candidate": cand.to_dict(),
                       "predicted": {"seconds": 1e-3}, "measured_us": 1e3,
                       "lint": {"ok": ok, "errors": []}, "devices": 4,
                       "device": "cpu", "steps": 1, "leaderboard": [],
                       "rejected": []}, d)
    return key


def _train(args, monkeypatch):
    """(losses, the parameters after the last step) of one launcher run,
    ``fit``'s final state caught on its way out."""
    import repro_torch.training as training
    real, states = training.fit, []

    def fit(*a, **k):
        state = real(*a, **k)
        states.append({p: t.detach().clone() for p, t in
                       state.params.named_parameters()})
        return state
    monkeypatch.setattr(training, "fit", fit)
    losses = train_cli.main(args)
    monkeypatch.undo()
    return losses, states[-1]


def test_auto_tune_equals_the_winners_flags(tmp_path, monkeypatch,
                                            deterministic, capsys):
    d = str(tmp_path)
    key = _seed(d, WINNER)
    tuned = _train(TRAIN + ["--auto-tune", "--tune-cache-dir", d],
                   monkeypatch)
    text = capsys.readouterr().out
    assert f"auto-tune (cache hit): hierarchical" in text and key in text
    assert "pods=2 strategy=hierarchical" in text and "dcn=int8" in text
    direct = _train(TRAIN + ["--strategy", "hierarchical", "--windows", "2",
                             "--wire-format", "identity",
                             "--wire-format-dcn", "int8", "--chunk-kb", "8",
                             "--pods", "2"], monkeypatch)
    assert tuned[0] == direct[0] and len(tuned[0]) == 2
    assert tuned[1].keys() == direct[1].keys()
    for k in tuned[1]:
        assert torch.equal(tuned[1][k], direct[1][k]), k


def test_auto_tune_tunes_a_miss_on_the_saved_calibration(tmp_path,
                                                         small_probes):
    d = str(tmp_path)
    with pytest.raises(SystemExit, match="--calibrate"):
        train_cli.main(TRAIN + ["--auto-tune", "--tune-cache-dir", d])
    tune_cli.calibrate_topology(4, "cpu", d, say=lambda *a: None)
    losses = train_cli.main(TRAIN + ["--auto-tune", "--tune-cache-dir", d,
                                     "--tune-top-k", "1", "--tune-steps",
                                     "1"])
    assert len(losses) == 2
    entries = [f for f in os.listdir(d) if not f.startswith("calibration")]
    assert len(entries) == 1


def test_auto_tune_refuses_what_it_cannot_honour(tmp_path, monkeypatch):
    d = str(tmp_path)
    _seed(d, WINNER, ok=False)          # untrusted: a miss, no calibration
    with pytest.raises(SystemExit, match="--calibrate"):
        train_cli.main(TRAIN + ["--auto-tune", "--tune-cache-dir", d])

    def red(*a, **k):
        return {"lint": {"ok": False, "errors": ["R1"]}}
    monkeypatch.setattr("repro_torch.tuning.autotune", red)
    with pytest.raises(SystemExit, match="not lint-green"):
        train_cli.main(TRAIN + ["--auto-tune", "--tune-cache-dir", d])
    with pytest.raises(NotImplementedError, match="4b"):
        train_cli.main(["--reduced", "--device", "cpu", "--nproc", "2",
                        "--auto-tune"])


# --------------------------------------------------------- default paths

def _under(path: str, *parts) -> bool:
    base = os.path.join(ROOT, *parts)
    return os.path.commonpath([os.path.abspath(path), base]) == base


def test_default_artifacts_are_the_ports_own(monkeypatch):
    monkeypatch.setattr(train_cli, "_train", lambda comm, dev, args: args)
    monkeypatch.setattr(serve_cli, "_serve", lambda args: args)
    defaults = {"tuning cache": DEFAULT_CACHE_DIR,
                "train --telemetry-out": train_cli.main(
                    ["--device", "cpu"]).telemetry_out,
                "serve --telemetry-out": serve_cli.main(
                    ["--device", "cpu"]).telemetry_out}
    assert ARTIFACT_DIR == os.path.join(ROOT, "results", "torch")
    for name, path in defaults.items():
        assert _under(path, "results", "torch"), name
        for ref in REFERENCE_DIRS:
            assert not _under(path, "results", ref), (name, ref)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "results/torch/" in f.read().split()


# ------------------------------------------------------- the small copies

def test_mesh_shapes_and_paper_zoo_are_the_references():
    from repro.configs import ARCHS
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import applicable as ref_applicable
    from repro.configs.phub_paper import PAPER_MODELS as REF_PAPER

    from repro_torch.configs.phub_paper import PAPER_MODELS
    from repro_torch.configs.shapes import SHAPES, applicable
    from repro_torch.core import StackedComm
    from repro_torch.launch.mesh import make_comm

    assert make_comm(2, 4) == StackedComm(8, 2)
    assert make_comm(1, 4).pod_size == 4
    assert {k: vars(v) for k, v in PAPER_MODELS.items()} == \
        {k: vars(v) for k, v in REF_PAPER.items()}
    assert {k: vars(v) for k, v in SHAPES.items()} == \
        {k: vars(v) for k, v in REF_SHAPES.items()}
    for arch in ARCHS:
        for name in SHAPES:
            assert applicable(get_arch(arch), SHAPES[name]) == \
                ref_applicable(ARCHS[arch], REF_SHAPES[name]), (arch, name)
