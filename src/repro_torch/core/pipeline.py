"""The encoded-wire exchange on stacked workers (``repro/core/pipeline.py``).

The reference's ``pipelined_wire_exchange`` runs on each device: the ring
partial of every shard hops the S workers encoded, each hop decoding it,
adding its own rows and encoding it again; the owner decodes the last
partial, adds its own rows and updates; the parameter delta is encoded for
the pull, and what the rounding drops is carried in ``wire_ef``.  On one
card the S workers are the rows of the ``(S, padded)`` gradient buffer
(``core/comm.py``), and shard j's partial starts at worker j+1, as in the
reference's ring:

    acc_j = G[j+1, j],  encoded
    acc_j = decode(acc_j) + G[j+k, j],  encoded,   k = 2 .. S-1
    g_j   = (decode(acc_j) + G[j, j]) / N          (at the owner, j)

(indices mod S; G[w, j] is worker w's run of shard j, ``[j*L, (j+1)*L)`` of
row w).  The codec works chunk by chunk and every shard is whole chunks,
so each hop runs over all S shards at once: one ``quantize_chunks`` or
``dequantize_chunks`` launch over the whole ``(padded,)`` domain.  Every
hop re-quantizes, so the order is part of the result.

One window: the reference's arithmetic does not depend on the window
count (whole chunks per window), and windows wait for ROADMAP.md queue A
item 8.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .chunking import GroupPlan
from .comm import StackedComm

PIPELINED_STRATEGIES = ("sharded_ps", "hierarchical")


def _runs(g: torch.Tensor, k: int):
    """(shard j's columns, the row that holds G[j+k, j]) for every j."""
    S, n = g.shape
    L = n // S
    return [(slice(j * L, (j + 1) * L), (j + k) % S) for j in range(S)]


def add_ring_rows_(acc: torch.Tensor, g: torch.Tensor, k: int
                   ) -> torch.Tensor:
    """acc[shard j] += G[j+k, j] for every shard j, in f32, in place."""
    for cols, w in _runs(g, k):
        acc[cols].add_(g[w, cols])
    return acc


def ring_rows(g: torch.Tensor, k: int) -> torch.Tensor:
    """The (padded,) f32 vector whose shard j is G[j+k, j]."""
    out = torch.empty(g.shape[1], dtype=torch.float32, device=g.device)
    for cols, w in _runs(g, k):
        out[cols].copy_(g[w, cols])
    return out


def ring_reduce_scatter(g: torch.Tensor, wire, chunk_elems: int
                        ) -> Optional[tuple]:
    """The encoded ring reduce-scatter of every shard at once: g is the
    (S, padded) stacked gradient buffer; returns the still-encoded partial
    that arrives at each owner (all shards in one wire tuple), without the
    owner's own rows; None when S == 1 (nothing crosses a wire).  The
    counterpart of the reference's ``rs_window`` at one window."""
    S = g.shape[0]
    if S == 1:
        return None
    parts = wire.encode(ring_rows(g, 1), chunk_elems)
    for k in range(2, S):
        acc = wire.decode(parts, chunk_elems)
        del parts                          # free the payload before encoding
        parts = wire.encode(add_ring_rows_(acc, g, k), chunk_elems)
        del acc
    return parts


def pipelined_wire_exchange(comm: StackedComm, g: torch.Tensor,
                            p: torch.Tensor, slots: tuple,
                            update_fn: Callable, wire, chunk_elems: int,
                            residual: torch.Tensor,
                            fused_dequant: Optional[Callable] = None):
    """One dtype group's sharded_ps exchange over an encoded wire, at one
    window.  g: (S, padded) stacked gradients; p: (padded,); ``slots``:
    the rule's (padded,) state vectors; ``residual``: the (padded,) f32
    ``wire_ef`` slot.  ``fused_dequant(p, parts, g, slots)`` fuses the
    owner's decode, its own rows (read on g's block diagonal) and the mean
    into the rule (``ShardedOptimizer.kernel_dequant_update``); without it
    the partial is decoded, the own rows added, the sum divided by N and
    handed to ``update_fn``.  Returns (p', slots', residual'), where p' is
    p plus the decoded pull delta (not the rule's p'): what every worker
    applies after the all-gather, which is the identity on one card."""
    S, ce = comm.n_workers, chunk_elems
    if tuple(g.shape) != (S, p.numel()):
        raise ValueError(f"g {tuple(g.shape)} is not (n_workers={S}, "
                         f"{p.numel()})")
    parts = ring_reduce_scatter(g, wire, ce)
    if parts is None:
        # S == 1: the own row alone, and the mean over one worker is exact
        p2, s2 = update_fn(p, g[0], slots)
    elif fused_dequant is not None:
        p2, s2 = fused_dequant(p, parts, g, slots)
    else:
        gsum = wire.decode(parts, ce)
        del parts
        add_ring_rows_(gsum, g, 0)
        # divided, by a tensor on the device: PyTorch's CUDA division by a
        # Python number multiplies by the reciprocal
        p2, s2 = update_fn(p, gsum.div_(gsum.new_tensor(float(S))), slots)
        del gsum

    # pull: encode the delta plus the carried residual; the decoded payload
    # is both what the residual keeps and what the workers add to p
    e = (p2.float() - p.float()).add_(residual)
    del p2
    parts = wire.encode(e, ce)
    d = wire.decode(parts, ce)
    del parts
    r = e.sub_(d)
    return d.add_(p).to(p.dtype), s2, r


def run_wire_exchange(strategy: str, comm: StackedComm, g: torch.Tensor,
                      p: torch.Tensor, slots: tuple, update_fn: Callable,
                      group: GroupPlan, wire, residual: torch.Tensor,
                      fused_dequant: Optional[Callable] = None):
    """Dispatch one dtype group over a non-identity wire; the identity wire
    takes ``core/exchange.py::exchange_group``, the pre-wire path."""
    if wire.is_identity:
        raise ValueError("identity wire travels exchange_group (the "
                         "pre-wire path); run_wire_exchange is the encoded "
                         "datapath")
    if strategy not in PIPELINED_STRATEGIES:
        raise ValueError(
            f"wire format {wire.name!r} needs a strategy with a shard "
            f"dimension {PIPELINED_STRATEGIES}; {strategy!r} has none")
    return pipelined_wire_exchange(comm, g, p, slots, update_fn, wire,
                                   group.chunk_elems, residual, fused_dequant)
