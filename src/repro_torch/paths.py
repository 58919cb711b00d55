"""Where the port writes what it makes by default: one directory of its
own, ``results/torch/`` at the root of the checkout (listed in
``.gitignore``), with ``telemetry/`` (the launchers' ``--telemetry-out``
and the card's calibrations) and ``tuning/`` (the autotuner's winner
cache) under it.  The other directories of ``results/`` hold the
reference's tracked records (its tuning sweep, telemetry, lint and
dry-run reports); no port code writes there by default."""
import os

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
ARTIFACT_DIR = os.path.join(ROOT, "results", "torch")
TELEMETRY_DIR = os.path.join(ARTIFACT_DIR, "telemetry")
TUNING_DIR = os.path.join(ARTIFACT_DIR, "tuning")
