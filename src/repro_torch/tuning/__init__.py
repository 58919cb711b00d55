"""The rack's topology calibration (``repro/tuning/``): probe steps on
the card solved for the cost model's constants (``calibrate``).  The
reference's autotuner (space, cost ranking, cache, tuner) is ROADMAP.md
queue A item 9b."""
from .calibrate import (CARD_PROBE_ELEMS, MIN_TOLERANCE, PROBE_FLAVORS,
                        calibrate, calibration_record, card_base_topology,
                        load_calibration, run_probe_programs,
                        save_calibration, solve_topology)

__all__ = [
    "CARD_PROBE_ELEMS", "MIN_TOLERANCE", "PROBE_FLAVORS", "calibrate",
    "calibration_record", "card_base_topology", "load_calibration",
    "run_probe_programs", "save_calibration", "solve_topology",
]
