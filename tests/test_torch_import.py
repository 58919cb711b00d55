"""The port stands alone: importing it (and chip_smoke.py) pulls in neither
JAX nor the JAX package, and its entry points default to the card."""
import inspect
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")

PROBE = r"""
import importlib, json, pkgutil, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_no_jax_and_no_repro():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE, os.path.join(ROOT, "src"), ROOT],
        capture_output=True, text=True, env=env, timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "repro_torch.kernels.agg_opt.ops" in res["modules"]
    assert "repro_torch.core.engine" in res["modules"]
    assert res["leaked"] == []


def test_entry_points_default_to_cuda():
    from repro_torch.convert import opt_from_numpy, params_from_numpy
    from repro_torch.core import PHubEngine
    from repro_torch.data import SyntheticTokens
    from repro_torch.models import DecoderLM

    for fn, arg in ((PHubEngine.__init__, "device"),
                    (DecoderLM.__init__, "device"),
                    (SyntheticTokens.torch_batch, "device"),
                    (params_from_numpy, "device"),
                    (opt_from_numpy, "device")):
        assert inspect.signature(fn).parameters[arg].default == "cuda", fn
    src = open(os.path.join(ROOT, "src", "repro_torch", "launch",
                            "train.py")).read()
    assert 'ap.add_argument("--device", default="cuda")' in src
