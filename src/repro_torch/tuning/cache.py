"""Winner cache for the exchange autotuner (``repro/tuning/cache.py``,
DESIGN.md §16).

Entries live in ``<cache dir>/<key>.json``; the key is a hash of the
*request* -- the baseline ``TrainConfig.exchange_signature`` the caller
started from, the worker count, a fingerprint of the gradient tree (leaf
shapes and dtypes: the chunk plan, and with it every prediction and
timing, depends on nothing else about the model) and the device the
winner was timed on (``torch.cuda.get_device_name()``, or ``"cpu"``).  A
second invocation with the same request hits the cache and spends zero
timed steps; an entry is only trusted if its stored lint verdict is green
(``analysis/rules.py``), which ``launch/train.py --auto-tune`` checks
again before adopting it.

The differences from the reference: the key is the port's own (its
shorter signature, and the device: a winner timed on a CPU is never
trusted on the card), so it never equals a reference key; and the default
directory is the port's (``paths.TUNING_DIR``, ``results/torch/tuning``),
never the reference's ``results/tuning``, which holds its tracked sweep.
"""
from __future__ import annotations

import hashlib
import json
import os

import torch

from ..core.chunking import leaf_paths
from ..paths import TUNING_DIR

DEFAULT_CACHE_DIR = TUNING_DIR


def device_name(device) -> str:
    """The name a winner's timings are keyed by: the card's, or "cpu"."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def model_fingerprint(grads_like) -> list:
    """Sorted (row index, shape, dtype) rows -- everything the chunk plan
    can see of the model."""
    rows = sorted((list(leaf.shape), str(leaf.dtype).replace("torch.", ""))
                  for _, leaf in leaf_paths(grads_like))
    return [[i, s, d] for i, (s, d) in enumerate(rows)]


def cache_key(tc, n_devices: int, grads_like, device: str) -> str:
    """The request's key; ``device`` is ``device_name(...)`` of the card
    (or "cpu") the candidates are timed on."""
    blob = {"signature": list(tc.exchange_signature()),
            "devices": int(n_devices),
            "model": model_fingerprint(grads_like),
            "device": str(device)}
    canon = json.dumps(blob, sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(canon.encode()).hexdigest()[:16]


def cache_path(key: str, cache_dir: str = None) -> str:
    return os.path.join(cache_dir or DEFAULT_CACHE_DIR, f"{key}.json")


def load_cached(key: str, cache_dir: str = None):
    """The stored entry, or None; entries whose lint verdict is not green,
    and files that cannot be read, are misses (never trusted: a re-tune)."""
    path = cache_path(key, cache_dir)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            entry = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(entry, dict) or \
            not entry.get("lint", {}).get("ok"):
        return None
    return entry


def store_winner(key: str, entry: dict, cache_dir: str = None) -> str:
    """Write ``entry`` under ``key`` (a temporary file, then
    ``os.replace``: a reader never sees half a file)."""
    path = cache_path(key, cache_dir)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(entry, f, indent=2, sort_keys=True)
    os.replace(tmp, path)
    return path
