"""Exchange strategies over a Comm (``repro/core/exchange.py``).

- **sharded_ps**: PHub's chunk-balanced reduce-scatter, the fused agg+opt
  on the chunks each shard owns, and the all-gather of the updated chunks.
  On the stacked Comm the W workers' gradients are the rows of one ``(W,
  padded)`` tensor and every shard lives there too, so the three steps
  collapse into one pass over the whole domain.  Over a process group
  (``ProcessGroupComm``) they are three: the push (one ``all_to_all``: the
  owner receives every worker's run of its shard), the rule's fused kernel
  on the ``(W, L)`` received rows (it sums them in worker order, as the
  stacked pass does, so the two Comms agree bitwise), and the pull (one
  ``all_gather``).
- **hierarchical** (PHub's rack deployment, §3.4), P pods of D workers,
  D shards: each pod's in-pod partial is the sum of its D rows in data
  order, the cross-pod leg runs on the owner shard only (1/D of the
  cross-rack bytes), the rule divides by N = P·D (or the live count) and
  the new shard is all-gathered inside the pod.  On the stacked Comm the
  partials are added in place into each pod's row d = 0 (D-1 elementwise
  adds over the strided ``(P, padded)`` view: the gradient buffer is
  scratch by then), and one launch of the rule's kernel reads those P
  rows through its row stride (``D·padded`` elements apart), so the
  cross-pod sum runs in pod order inside the kernel, with the divisor N.
  At P = 1 that is one row with divisor D: in an f32 group it equals the
  sharded_ps step bitwise (the adds run in the kernel's worker order), in
  a bf16 group it does not (the in-pod adds round to bf16, the kernel
  sums in f32).  Over a process group: the in-pod push over the pod's
  subgroup, the D received rows summed in data order, ``cross_gather`` of
  the partial into (P, L) rows, the rule's kernel on them, and the pull
  inside the pod.  The P owners of shard j compute the same update: their
  slots are bitwise equal (pod-replicated).
- **allreduce** (the baseline): every worker's gradient summed, divided
  by N and the rule run on the full vector on every worker (one shard).
  Stacked: the rule's kernel over the whole ``(W, padded)`` buffer, the
  per-element arithmetic of sharded_ps, so the new parameters equal the
  stacked sharded_ps step's bitwise (the chunk plan's padding may differ:
  compare the unflattened parameters).  Over a process group: one
  ``all_reduce`` of this rank's row (in f32: a bf16 group's row is cast up,
  as the stacked kernel sums in f32), then the rule on the one summed row
  with divisor N on every rank, each holding the full slots.  At two ranks
  the sum commutes and the step equals the stacked one bitwise; at more,
  the library's summation order is not the worker order.
- **centralized_ps** (the baseline): the W gradients incast to one
  parameter server.  Stacked it is allreduce's pass (the reference's
  masked ``psum`` broadcast of rank 0's p' is the identity on one card).
  Over a process group rank 0 is the PS: ``gather_to(0)`` brings the W
  rows, rank 0 runs the rule's kernel on them in worker order, and
  ``broadcast_from(0)`` sends p'.  Only rank 0 holds and updates the slots
  (the reference keeps identical copies on every rank: DESIGN.md §7 says
  its centralized PS reproduces the traffic pattern only).

The identity wire's path at one window is here
(``core/pipeline.py::run_exchange`` dispatches here or to the windowed
exchange); an encoded wire takes ``core/pipeline.py::run_wire_exchange``
and an encoded DCN tier ``core/pipeline.py::run_dcn_exchange``.
fsdp_stream has no chunk domain: its step reduces each leaf's gradient
inside the workers' backwards and runs the rule leaf by leaf
(``core/engine.py``), on the stacked Comm only (over a process group it is
ROADMAP.md queue A item 4b).
"""
from __future__ import annotations

from typing import Callable

import torch

from .comm import ProcessGroupComm
from .pipeline import (PIPELINED_STRATEGIES, check_stacked, mean_divisor,
                       pipelined_exchange, pod_rows_, ring_tier)

STRATEGIES = ("allreduce", "sharded_ps", "centralized_ps", "hierarchical",
              "fsdp_stream")

# update_fn(p, g, slots, divisor=None, p_out=None, at=0) -> (p', slots'):
# the protocol's fused rule, taking g pre-aggregated or stacked (W, n), the
# stacked mean divided by W or by a one-element f32 tensor on the card
# (optim/protocol.py); ``at`` is where p starts in its dtype group (every
# call site passes it; the co-scheduled update finds its tenants' runs by
# it, the solo rules ignore it)
UpdateFn = Callable[..., tuple[torch.Tensor, tuple]]


def check_strategy(strategy: str) -> None:
    """Raise unless ``strategy`` is one the port runs (all five)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown exchange strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")


def check_wire(strategy: str, wire, wire_dcn=None) -> None:
    """Raise unless ``strategy`` can carry ``wire`` (and the DCN tier's
    ``wire_dcn``): an encoded wire needs a chunk strategy with a shard
    dimension, whose ring it re-encodes at every hop
    (``core/pipeline.py``); a DCN wire needs the two-tier hierarchical
    strategy (the reference's engine raises the same)."""
    if not wire.is_identity and strategy not in PIPELINED_STRATEGIES:
        raise ValueError(
            f"wire format {wire.name!r} needs a chunk strategy with a shard "
            f"dimension {PIPELINED_STRATEGIES}; {strategy!r} exchanges "
            f"leaves or full vectors in the state dtype")
    if wire_dcn is not None and strategy != "hierarchical":
        raise ValueError(
            f"wire_format_dcn {wire_dcn.name!r} encodes the cross-pod (DCN) "
            f"leg of the two-tier 'hierarchical' strategy; {strategy!r} has "
            f"no DCN leg")


def exchange_group(comm, g: torch.Tensor, p: torch.Tensor,
                   slots: tuple, update_fn: UpdateFn, n_live=None,
                   strategy: str = "sharded_ps"
                   ) -> tuple[torch.Tensor, tuple]:
    """One dtype group's exchange under ``strategy`` (the engine has
    checked it).  g: (W, padded) stacked worker gradients; p: (padded,);
    ``slots``: the optimizer's state buffers, shard s's state at
    [s*L, (s+1)*L), any number of them (0 for SGD, 4 for Adam).  Over a
    ``ProcessGroupComm``: g is this rank's (1, padded) row and ``slots``
    the state of the shard it owns ((L,) each; under centralized_ps rank
    0's (padded,) and none elsewhere), updated in place.
    ``n_live``: None divides the worker sum by W; a number or a 0-dim
    tensor on the card (the live count of an elastic or gated step, whose
    excluded rows the caller has zeroed) divides it by that, read by the
    kernel on the card (the reference's ``psum_scatter(...) / N``).
    Returns (p', slots'); the rule may update ``slots`` in place and
    return them."""
    check_stacked(comm, g, p)
    if isinstance(comm, ProcessGroupComm):
        if strategy in PIPELINED_STRATEGIES:
            return pipelined_exchange(comm, g, p, slots, update_fn, 1,
                                      n_live, strategy=strategy)
        return _process_group_baseline(comm, g, p, slots, update_fn, n_live,
                                       strategy)
    # p' into a new buffer and every slot updated in place: the state is
    # the step's own, as the reference's donated buffers (rack lint R3)
    p_out = torch.empty_like(p)
    if comm.n_workers == 1:
        # the reduce-scatter over one worker is the identity, and /1 (or
        # /max(n_live, 1) = /1) is exact: the reference's path into
        # agg_opt_chunks
        return update_fn(p, g[0], slots, p_out=p_out, at=0)
    if strategy == "hierarchical":
        # the in-pod partials into each pod's row d = 0, then one launch
        # over the P partial rows: the cross-pod sum in pod order, / N
        P, D = comm.pods, comm.pod_size
        rows = pod_rows_(g, P, on_hop=lambda parts: comm.record(
            "push", "reduce-scatter", "ici", parts))
        # the cross-pod all-reduce of worker 0's shard
        comm.record_all_reduce("cross_reduce", "all-reduce", "dcn",
                               rows[:, :p.numel() // D], P)
        out = update_fn(p, rows, slots, divisor=mean_divisor(
            comm.n_workers if n_live is None else n_live, g.device),
            p_out=p_out, at=0)
        comm.record_gather("pull", "all-gather", "ici", (out[0],), D)
        return out
    # sharded_ps: shard s owns the contiguous run [s*L, (s+1)*L) of every
    # row, so one tall-aggregation pass over the whole domain equals the S
    # per-shard (sum over workers, /W, update) passes of the reference;
    # allreduce and centralized_ps have one shard, the same pass
    _record_flat(comm, strategy, g)
    if n_live is None:
        out = update_fn(p, g, slots, p_out=p_out, at=0)
    else:
        out = update_fn(p, g, slots, divisor=mean_divisor(n_live, g.device),
                        p_out=p_out, at=0)
    if strategy == "sharded_ps":
        comm.record_gather("pull", "all-gather", ring_tier(comm, strategy),
                           (out[0],), comm.n_workers)
    return out


def _record_flat(comm, strategy: str, g: torch.Tensor) -> None:
    """The collective the flat stacked pass over the rows ``g`` stands in
    for: sharded_ps's reduce-scatter over W shards, allreduce's ring
    all-reduce (centralized_ps's incast has no traffic model and is not
    recorded)."""
    W = comm.n_workers
    if strategy == "sharded_ps":
        comm.record_scatter("push", "reduce-scatter",
                            ring_tier(comm, strategy), g, W)
    elif strategy == "allreduce":
        comm.record_all_reduce("all_reduce", "all-reduce", "ici", g, W)


def _process_group_baseline(comm: ProcessGroupComm, g, p, slots, update_fn,
                            n_live, strategy: str):
    """allreduce and centralized_ps over a process group (module
    docstring)."""
    W = comm.n_workers
    if strategy == "allreduce":
        row = g[0]
        if W == 1:
            return update_fn(p, row, slots, at=0)
        total = comm.all_reduce(row.float() if row.dtype != torch.float32
                                else row)
        return update_fn(p, total[None], slots, divisor=mean_divisor(
            W if n_live is None else n_live, g.device), at=0)
    rows = comm.gather_to(g[0], 0)
    if comm.rank == 0:
        if W == 1:
            p2, slots = update_fn(p, rows[0], slots, at=0)
        elif n_live is None:
            p2, slots = update_fn(p, rows, slots, at=0)
        else:
            p2, slots = update_fn(p, rows, slots,
                                  divisor=mean_divisor(n_live, g.device),
                                  at=0)
    else:
        p2 = torch.empty_like(p)
    return comm.broadcast_from(p2, 0), slots
