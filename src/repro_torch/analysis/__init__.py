"""The rack lint's gate on tuned exchange configs
(``repro/analysis/``): rules R1 (traffic), R3 (in place) and R5
(hygiene) over one recorded zero-compute step (``rules.py``).  R2, R4,
the lint matrix and its CLI are ROADMAP.md queue A item 10."""
from .rules import (RULES, Diagnostic, Fixture, StepArtifact,
                    artifact_from_engine, check_hygiene, check_in_place,
                    check_traffic, lint_artifact, lint_tuned_config,
                    seeded_fixtures)

__all__ = [
    "RULES", "Diagnostic", "Fixture", "StepArtifact",
    "artifact_from_engine", "check_hygiene", "check_in_place",
    "check_traffic", "lint_artifact", "lint_tuned_config",
    "seeded_fixtures",
]
