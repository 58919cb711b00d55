"""Exchange strategies over a Comm (``repro/core/exchange.py``).

The port has sharded_ps on the stacked-worker Comm: PHub's chunk-balanced
reduce-scatter, the fused agg+opt on the chunks each shard owns, and the
all-gather of the updated chunks.  On one card the W workers' gradients
are the rows of one ``(W, padded)`` tensor and every shard lives there
too, so the three steps collapse into one pass over the whole domain.
The other strategies are ROADMAP.md queue A item 7.  This is the identity
wire's path; an encoded wire takes ``core/pipeline.py::run_wire_exchange``.
"""
from __future__ import annotations

from typing import Callable

import torch

from .comm import StackedComm
from .pipeline import PIPELINED_STRATEGIES

STRATEGIES = ("allreduce", "sharded_ps", "centralized_ps", "hierarchical",
              "fsdp_stream")

# update_fn(p, g, slots, divisor=None) -> (p', slots'): the protocol's fused
# rule, taking g pre-aggregated or stacked (W, n), the stacked mean divided
# by W or by a one-element f32 tensor on the card (optim/protocol.py)
UpdateFn = Callable[..., tuple[torch.Tensor, tuple]]


def check_strategy(strategy: str) -> None:
    """Raise unless ``strategy`` is one the port runs."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown exchange strategy {strategy!r}; "
                         f"expected one of {STRATEGIES}")
    if strategy != "sharded_ps":
        raise NotImplementedError(
            f"strategy {strategy!r} is not ported yet (ROADMAP.md queue A "
            f"item 7)")


def check_wire(strategy: str, wire) -> None:
    """Raise unless ``strategy`` can carry ``wire``: an encoded wire needs
    a chunk strategy with a shard dimension, whose ring it re-encodes at
    every hop (``core/pipeline.py``)."""
    if not wire.is_identity and strategy not in PIPELINED_STRATEGIES:
        raise ValueError(
            f"wire format {wire.name!r} needs a chunk strategy with a shard "
            f"dimension {PIPELINED_STRATEGIES}; {strategy!r} exchanges "
            f"leaves or full vectors in the state dtype")


def exchange_group(comm: StackedComm, g: torch.Tensor, p: torch.Tensor,
                   slots: tuple, update_fn: UpdateFn, n_live=None
                   ) -> tuple[torch.Tensor, tuple]:
    """One dtype group's sharded_ps exchange (the engine has checked the
    strategy).  g: (W, padded) stacked worker gradients; p: (padded,);
    ``slots``: the optimizer's (padded,) state buffers, shard s's state at
    [s*L, (s+1)*L), any number of them (0 for SGD, 4 for Adam).
    ``n_live``: None divides the worker sum by W; a number or a 0-dim
    tensor on the card (the live count of an elastic or gated step, whose
    excluded rows the caller has zeroed) divides it by that, read by the
    kernel on the card (the reference's ``psum_scatter(...) / N``).
    Returns (p', slots'); the rule may update ``slots`` in place and
    return them."""
    W = comm.n_workers
    if tuple(g.shape) != (W, p.numel()):
        raise ValueError(f"g {tuple(g.shape)} is not (n_workers={W}, "
                         f"{p.numel()})")
    if W == 1:
        # the reduce-scatter over one worker is the identity, and /1 (or
        # /max(n_live, 1) = /1) is exact: the reference's path into
        # agg_opt_chunks
        return update_fn(p, g[0], slots)
    # shard s owns the contiguous run [s*L, (s+1)*L) of every row, so one
    # tall-aggregation pass over the whole domain equals the S per-shard
    # (sum over workers, /W, update) passes of the reference
    if n_live is None:
        return update_fn(p, g, slots)
    divisor = torch.as_tensor(n_live, dtype=torch.float32).to(g.device)
    return update_fn(p, g, slots, divisor=divisor.reshape(1))
