"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
JAX nor the JAX package, and its entry points default to the card."""
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
spec = importlib.util.spec_from_file_location(
    "torch_external_loop", sys.argv[3])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""

EXAMPLE = os.path.join(ROOT, "examples", "torch_external_loop.py")


def test_port_imports_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE, os.path.join(ROOT, "src"), ROOT,
         EXAMPLE],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for name in ("kernels.agg_opt.ops", "core.engine", "elastic.chaos",
                 "elastic.membership", "resilience.supervisor",
                 "resilience.watchdog", "checkpoint.checkpointer",
                 "kernels.swa_attn.ops", "kernels.decode_attn.ops",
                 "kernels.rwkv_scan.ops", "models.rwkv", "launch.serve",
                 "core.client", "optim.api", "optim.sgd", "optim.adam",
                 "core.api", "core.partition", "core.cost_model",
                 "telemetry.tracer", "telemetry.metrics",
                 "telemetry.attribution", "tuning.calibrate",
                 "launch.trace", "tuning.space", "tuning.cost",
                 "tuning.cache", "tuning.tuner", "analysis.rules",
                 "launch.tune", "launch.mesh", "configs.phub_paper",
                 "configs.shapes", "paths"):
        assert f"repro_torch.{name}" in res["modules"]
    assert res["leaked"] == []


def test_entry_points_default_to_cuda():
    from repro_torch.convert import (cache_from_numpy, opt_from_numpy,
                                     params_from_numpy)
    from repro_torch.core import (PHubClient, PHubConnectionManager,
                                  PHubEngine, ProcessGroupComm)
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM, init_cache

    for fn, arg in ((PHubEngine.__init__, "device"),
                    (PHubClient.__init__, "device"),
                    (ProcessGroupComm.__init__, "device"),
                    (PHubConnectionManager.create_service, "device"),
                    (DecoderLM.__init__, "device"),
                    (SyntheticTokens.torch_batch, "device"),
                    (params_from_numpy, "device"),
                    (opt_from_numpy, "device"),
                    (cache_from_numpy, "device"),
                    (init_cache, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn
    # the serving steps run on the engine's device, the card unless asked
    from repro_torch.configs import TrainConfig, get_arch, reduced
    from repro_torch.core import StackedComm
    eng = PHubEngine(reduced(get_arch("llama3.2-1b")), TrainConfig(),
                     StackedComm(1))
    assert eng.device.type == "cuda"
    assert callable(eng.make_prefill_step(16)) and callable(
        eng.make_serve_step())
    for launcher in ("train.py", "serve.py"):
        src = open(os.path.join(ROOT, "src", "repro_torch", "launch",
                                launcher)).read()
        assert 'ap.add_argument("--device", default="cuda")' in src, launcher
    assert 'ap.add_argument("--device", default="cuda")' in open(
        EXAMPLE).read()
