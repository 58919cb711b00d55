"""Analytic ranking of autotuner candidates (``repro/tuning/cost.py``,
DESIGN.md §16).

Each candidate is priced with ``cost_model.predicted_step_seconds`` over
the chunk plan it would actually induce (its own chunk size and shard
count), on the two-tier ``RackTopology`` -- so the ranking sees exactly
the windowing/latency and per-tier bandwidth trade-offs the real
schedule pays, and the analytic order is meaningful enough that only the
top-k need real timed steps.

The difference from the reference: there is no default topology.  The
reference's ``DEFAULT_TOPOLOGY`` holds constants fit to a CPU host's
forced devices; the port ranks on a topology its caller measured (on the
card: ``tuning/calibrate.py``'s probes, ``launch/tune.py --calibrate``),
and a ranking without one raises.  ``grads_like`` is a dict of meta
tensors (``models.param_specs(cfg)``), so ranking allocates nothing.
"""
from __future__ import annotations

from ..core.chunking import build_plan
from ..core.comm import StackedComm
from ..core.cost_model import RackTopology, predicted_step_seconds
from ..core.wire import WireFormat
from ..launch.mesh import make_comm
from .space import Candidate


def context_for(c: Candidate) -> StackedComm:
    """The candidate's worker layout, ``make_comm(pods, data)`` (the
    reference's ``ExchangeContext`` over its ``(pod, data)`` axes): the
    one layout its timing, its lint and ``train --auto-tune`` run on."""
    return make_comm(c.pods, c.data)


def _wire(name):
    if name in (None, "identity"):
        return None
    return WireFormat(name)


def _require(topo) -> None:
    if topo is None:
        raise ValueError(
            "ranking needs an explicit RackTopology: the port carries no "
            "default topology (calibrate one on the card: launch/tune.py "
            "--calibrate, tuning/calibrate.py)")


def predict(grads_like, c: Candidate, topo: RackTopology, *,
            compute_s: float = 0.0) -> dict:
    """predicted_step_seconds for one candidate on its own chunk plan."""
    _require(topo)
    comm = context_for(c)
    plan = build_plan(grads_like, chunk_bytes=c.chunk_size_bytes,
                      n_shards=max(comm.n_shards(c.strategy), 1))
    return predicted_step_seconds(
        plan.groups, strategy=c.strategy, topo=topo,
        wire=_wire(c.wire_format), wire_dcn=_wire(c.wire_format_dcn),
        windows=c.pipeline_windows, n_workers=c.n_workers,
        pod_size=c.pods, compute_s=compute_s)


def rank_candidates(grads_like, candidates, topo: RackTopology = None, *,
                    compute_s: float = 0.0) -> list:
    """[(candidate, prediction)] sorted fastest-first (a stable sort);
    candidates the cost model refuses (unmodeled strategies) are
    dropped.  ``topo`` is required."""
    _require(topo)
    out = []
    for c in candidates:
        try:
            pred = predict(grads_like, c, topo, compute_s=compute_s)
        except ValueError:
            continue
        out.append((c, pred))
    out.sort(key=lambda cp: cp[1]["seconds"])
    return out
