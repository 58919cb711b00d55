"""Sharding planner (``repro/core/sharding.py``): every parameter leaf to
the reference's mesh axes, over torch shapes.

Two storage layouts, as the reference's:

- ``replicated`` (PHub's workers each hold the whole model): a leaf is
  split only over ``model`` (the reference's tensor parallelism).
- ``fsdp`` (the ``fsdp_stream`` strategy): a leaf at least
  ``_MIN_SHARD_ELEMS`` large is also split over ``data``, on its largest
  dimension that divides (never the stacked layer dimension of a
  ``blocks`` leaf); the Pull all-gathers a layer's shards and the Push
  reduce-scatters its gradient.

A spec is a tuple of mesh-axis names or None, one a dimension, trailing
Nones dropped, as the reference's ``PartitionSpec`` entries.  The port's
stacked Comm holds every worker's shard of a leaf on one card side by side,
so its Pull (``make_gather_fn``) is the identity and the Push is the sum
over the workers' gradients (``core/engine.py``); the plan says which
leaves the reference splits over ``data`` and their per-worker shapes.
``_COL``, ``_ROW`` and ``_MIN_SHARD_ELEMS`` are the reference's.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import Callable, Optional

from .chunking import leaf_paths

# leaf name -> the dimension the 'model' axis splits, counted from the end
# of the shape (a block leaf has a leading layer dimension)
_COL = {"wq", "wk", "wv", "w1", "w3", "ck", "cr", "w_r", "w_k", "w_v", "w_g",
        "w_in", "w_gate", "wa", "wb", "moe_w1", "moe_w3", "lm_head"}
_ROW = {"wo", "w2", "cv", "w_o", "w_out", "moe_w2"}
_MIN_SHARD_ELEMS = 1 << 16          # tiny leaves stay whole

LAYOUTS = ("replicated", "fsdp")


def _leaf_name(path: str) -> str:
    keys = re.findall(r"\['([^']+)'\]", path)
    return keys[-1] if keys else path


@dataclass(frozen=True)
class LeafPlan:
    spec: tuple                     # the storage spec (model [+ data] dims)
    model_dim: Optional[int]        # the dimension split over 'model'
    fsdp_dim: Optional[int]         # the dimension split over 'data'


@dataclass(frozen=True)
class ShardingPlan:
    mesh_axes: tuple[str, ...]      # ("data", "model") or ("pod", "data", ...)
    layout: str                     # "replicated" | "fsdp"
    leaves: dict                    # path -> LeafPlan, in leaf order
    tree: dict = field(repr=False, compare=False, default=None)

    @property
    def data_axes(self) -> tuple[str, ...]:
        return tuple(a for a in self.mesh_axes if a in ("pod", "data"))

    def specs(self) -> dict:
        """The parameter tree's shape with each leaf's spec."""
        return self._map(lambda lp: lp.spec)

    def fsdp_dims(self) -> dict:
        """The tree with each leaf's ``fsdp_dim`` (None: replicated)."""
        return self._map(lambda lp: lp.fsdp_dim)

    def _map(self, fn: Callable) -> dict:
        def walk(node, prefix):
            return {k: (walk(v, f"{prefix}[{k!r}]") if isinstance(v, dict)
                        else fn(self.leaves[f"{prefix}[{k!r}]"]))
                    for k, v in node.items()}
        return walk(self.tree, "")


def plan_params(params_shapes: dict, *, mesh_axes: tuple[str, ...],
                axis_sizes: dict[str, int], layout: str = "replicated"
                ) -> ShardingPlan:
    """``params_shapes``: the nested dict of leaves (tensors, meta tensors,
    or anything with ``.shape``)."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}; expected one of "
                         f"{LAYOUTS}")
    mo = axis_sizes.get("model", 1)
    da = axis_sizes.get("data", 1)
    leaves: dict[str, LeafPlan] = {}
    for path, leaf in leaf_paths(params_shapes):
        name = _leaf_name(path)
        shape = tuple(leaf.shape)
        size = math.prod(shape)
        lead = 1 if path.startswith("['blocks']") else 0   # the layer dim

        model_dim = None
        if mo > 1 and size >= _MIN_SHARD_ELEMS and len(shape) > lead:
            if name == "embed":
                for cand in (0, 1):
                    if shape[cand] % mo == 0:
                        model_dim = cand
                        break
            elif name in _COL and shape[-1] % mo == 0:
                model_dim = len(shape) - 1
            elif (name in _ROW and len(shape) - 2 >= lead
                  and shape[-2] % mo == 0):
                model_dim = len(shape) - 2

        fsdp_dim = None
        if layout == "fsdp" and da > 1 and size >= _MIN_SHARD_ELEMS:
            # the largest remaining dimension the data axis divides
            cands = [i for i in range(lead, len(shape))
                     if i != model_dim and shape[i] % da == 0]
            if cands:
                fsdp_dim = max(cands, key=lambda i: shape[i])

        entries: list = [None] * len(shape)
        if model_dim is not None:
            entries[model_dim] = "model"
        if fsdp_dim is not None:
            entries[fsdp_dim] = "data"
        while entries and entries[-1] is None:
            entries.pop()
        leaves[path] = LeafPlan(spec=tuple(entries), model_dim=model_dim,
                                fsdp_dim=fsdp_dim)
    return ShardingPlan(mesh_axes=tuple(mesh_axes), layout=layout,
                        leaves=leaves, tree=params_shapes)


def local_shapes(params_shapes: dict, plan: ShardingPlan,
                 axis_sizes: dict[str, int]) -> dict:
    """One device's leaf shapes under the plan (the model and fsdp
    dimensions divided), as a tree of tuples."""
    def walk(node, prefix):
        out = {}
        for k, v in node.items():
            path = f"{prefix}[{k!r}]"
            if isinstance(v, dict):
                out[k] = walk(v, path)
                continue
            lp = plan.leaves[path]
            shape = list(v.shape)
            if lp.model_dim is not None:
                shape[lp.model_dim] //= axis_sizes.get("model", 1)
            if lp.fsdp_dim is not None:
                shape[lp.fsdp_dim] //= axis_sizes.get("data", 1)
            out[k] = tuple(shape)
        return out
    return walk(params_shapes, "")


def make_gather_fn(plan: ShardingPlan, params_template=None):
    """PHub's Pull for the fsdp layout, ``gather(section, subtree)``: None
    for the replicated layout (no Pull).  On the stacked Comm the W shards
    of an fsdp leaf lie side by side on the card and are the whole leaf, so
    the gather returns the subtree as it is."""
    if plan.layout != "fsdp":
        return None

    def gather(section: str, subtree):
        return subtree
    return gather
