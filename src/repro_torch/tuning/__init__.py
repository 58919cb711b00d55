"""The exchange autotuner (``repro/tuning/``, DESIGN.md §16) and the
rack's topology calibration (§17): the search space (``space.py``), its
ranking on a measured ``RackTopology`` (``cost.py``), the winner cache
(``cache.py``), the tuner that times the top candidates on the card and
lint-gates the winner (``tuner.py``), and the probes that calibrate the
topology on the card (``calibrate.py``)."""
from .cache import (DEFAULT_CACHE_DIR, cache_key, cache_path, device_name,
                    load_cached, model_fingerprint, store_winner)
from .calibrate import (CARD_PROBE_ELEMS, MIN_TOLERANCE, PROBE_FLAVORS,
                        calibrate, calibration_record, card_base_topology,
                        load_calibration, run_probe_programs,
                        save_calibration, solve_topology)
from .cost import context_for, predict, rank_candidates
from .space import Candidate, enumerate_space, mesh_shapes, valid
from .tuner import autotune, lint_candidate, time_candidate

__all__ = [
    "CARD_PROBE_ELEMS", "DEFAULT_CACHE_DIR", "MIN_TOLERANCE",
    "PROBE_FLAVORS", "Candidate", "autotune", "cache_key", "cache_path",
    "calibrate", "calibration_record", "card_base_topology", "context_for",
    "device_name", "enumerate_space", "lint_candidate", "load_cached",
    "load_calibration", "mesh_shapes", "model_fingerprint", "predict",
    "rank_candidates", "run_probe_programs", "save_calibration",
    "solve_topology", "store_winner", "time_candidate", "valid",
]
