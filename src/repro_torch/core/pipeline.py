"""PHub's gradient processing pipeline on stacked workers
(``repro/core/pipeline.py``): the windowed exchange, the chunk-ready
dispatch, and the encoded-wire exchange.

**Windows.**  The reference splits each dtype group's chunk domain into
``W`` windows (``effective_windows``: a whole number of chunks each) and
runs window w's ring reduce-scatter while window w-1 optimizes.  On one
card the ring moves no data (``core/exchange.py``), so window w's work is
the fused aggregate+update of the strip ``[j*L + w*Lw, j*L + (w+1)*Lw)``
of every shard j, windows in the reference's order: one kernel launch
per (window, shard), reading the strip of every worker's row in place in
the stacked ``(W, padded)`` buffer (a ``(W, Lw)`` view whose rows lie
``padded`` apart: the kernels take a row stride).  One launch per
(window, shard) rather than one per window: each (window, shard) has one
contiguous run of p and of every slot, so the kernels need only the row
stride and no second (shard-run) stride, and a strip of llama3.2-1b is
still 7,543 chunks, so the 20 launches of a W=4 step cost less than 1%
of the update's device time.  The new parameters go
into one ``(padded,)`` vector, a window's strips at their own offsets,
and every slot is updated in place.  The rules are elementwise, so a
windowed exchange equals the monolithic one bitwise.

**Chunk-ready** (``ChunkReadyExchange``, the reference's
``chunk_ready_exchange``).  Window w's update may start once every leaf
that meets its strips has its gradient; the engine reports each leaf as
the last worker's backward produces it, and the window's launches go on a
side CUDA stream, ordered after the gradient copies by an event.

**The encoded wire** (``run_wire_exchange``): the reference's
``pipelined_wire_exchange`` runs on each device: the ring partial of every
shard hops the S workers encoded, each hop decoding it, adding its own
rows and encoding it again; the owner decodes the last partial, adds its
own rows and updates; the parameter delta is encoded for the pull, and
what the rounding drops is carried in ``wire_ef``.  On one
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
hop re-quantizes, so the order is part of the result.  It runs at one
window: the encoded wire in windows and chunk-ready over a wire
(``pipelined_wire_exchange`` at W > 1, ``run_chunk_ready_wire_exchange``)
are ROADMAP.md queue A item 11, and ``check_pipeline`` refuses them.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import chunking
from .chunking import GroupPlan
from .comm import StackedComm

PIPELINED_STRATEGIES = ("sharded_ps", "hierarchical")


def check_pipeline(tc, wire) -> None:
    """Raise where the reference's engine raises for the pipeline's
    options: chunk-ready dispatch or windows on a strategy with no shard
    dimension, flat residency on one with no chunk domain; and
    ``NotImplementedError`` for an encoded wire at windows > 1 or with
    chunk-ready dispatch, which the port does not run yet."""
    if tc.overlap_backward and tc.strategy not in PIPELINED_STRATEGIES:
        raise ValueError(
            f"overlap_backward windows the shard dimension "
            f"({PIPELINED_STRATEGIES}); {tc.strategy!r} has no chunk-ready "
            f"seam")
    if tc.pipeline_windows > 1 and tc.strategy not in PIPELINED_STRATEGIES:
        raise ValueError(
            f"pipeline_windows windows the shard dimension "
            f"({PIPELINED_STRATEGIES}); {tc.strategy!r} has none")
    if tc.flat_residency and tc.strategy == "fsdp_stream":
        raise ValueError(
            "flat_residency requires a chunk-domain strategy: fsdp_stream "
            "shards leaves over 'data' and has no flat parameter store")
    if not wire.is_identity and (tc.pipeline_windows > 1
                                 or tc.overlap_backward):
        raise NotImplementedError(
            f"the {wire.name!r} wire runs at one window without chunk-ready "
            f"dispatch (pipeline_windows={tc.pipeline_windows}, "
            f"overlap_backward={tc.overlap_backward}); windows and "
            f"chunk-ready over an encoded wire are ROADMAP.md queue A "
            f"item 11")


def effective_windows(group, requested: int) -> int:
    """Largest window count <= ``requested`` that splits the shard into a
    whole number of chunks (windows respect chunk boundaries, so the fused
    agg+opt kernel's chunks stay aligned)."""
    cps = group.chunks_per_shard
    w = max(1, min(requested, cps))
    while cps % w:
        w -= 1
    return w


def window_runs(group: GroupPlan, windows: int, w: int) -> tuple:
    """Window w's strip of every shard j, ``[j*L + w*Lw, j*L + (w+1)*Lw)``,
    as slices of the flat domain, in shard order."""
    L = group.shard_len
    Lw = L // windows
    return tuple(slice(j * L + w * Lw, j * L + (w + 1) * Lw)
                 for j in range(group.n_shards))


def mean_divisor(n_live, device):
    """The stacked mean's divisor for the rules' kernels: None (divide by
    W), or ``n_live`` (a number or a 0-dim tensor on the card) as a
    one-element f32 tensor on ``device``."""
    if n_live is None:
        return None
    return torch.as_tensor(n_live, dtype=torch.float32).to(device).reshape(1)


def exchange_window(comm: StackedComm, g: torch.Tensor, p: torch.Tensor,
                    slots: tuple, update_fn: Callable, group: GroupPlan,
                    windows: int, w: int, p_out: torch.Tensor,
                    divisor=None) -> None:
    """Window w of the stacked windowed exchange: for every shard j, the
    fused aggregate+update of its strip, one launch reading the strip of
    every worker's row of ``g`` (W, padded) in place; p' into ``p_out``
    at the strip's offsets, the slots updated in place.  At W == 1 the
    reduce-scatter is the identity and the mean over one worker exact
    (the reference's path into agg_opt_chunks), as in ``exchange_group``."""
    for sl in window_runs(group, windows, w):
        sw = tuple(s[sl] for s in slots)
        if comm.n_workers == 1:
            update_fn(p[sl], g[0, sl], sw, p_out=p_out[sl])
        else:
            update_fn(p[sl], g[:, sl], sw, divisor=divisor, p_out=p_out[sl])


def pipelined_exchange(comm: StackedComm, g: torch.Tensor, p: torch.Tensor,
                       slots: tuple, update_fn: Callable, group: GroupPlan,
                       windows: int, n_live=None) -> tuple:
    """The windowed counterpart of ``exchange_group``: windows 0 .. W-1 in
    order, each ``exchange_window``.  Returns (p', slots), the slots
    updated in place; p' equals the monolithic exchange's bitwise."""
    check_stacked(comm, g, p)
    p_out = torch.empty_like(p)
    divisor = mean_divisor(n_live, g.device)
    for w in range(windows):
        exchange_window(comm, g, p, slots, update_fn, group, windows, w,
                        p_out, divisor)
    return p_out, slots


def run_exchange(strategy: str, comm: StackedComm, g: torch.Tensor,
                 p: torch.Tensor, slots: tuple, update_fn: Callable,
                 group: GroupPlan, windows: int, n_live=None) -> tuple:
    """Dispatch one dtype group over the identity wire: the windowed
    exchange when the strategy has a shard dimension and more than one
    effective window, else the monolithic ``exchange_group``, unchanged."""
    from .exchange import exchange_group
    if strategy in PIPELINED_STRATEGIES:
        w = effective_windows(group, windows)
        if w > 1:
            return pipelined_exchange(comm, g, p, slots, update_fn, group,
                                      w, n_live)
    return exchange_group(comm, g, p, slots, update_fn, n_live)


def check_stacked(comm: StackedComm, g: torch.Tensor, p: torch.Tensor):
    """Raise unless g is the (n_workers, p.numel()) stacked buffer."""
    W = comm.n_workers
    if tuple(g.shape) != (W, p.numel()):
        raise ValueError(f"g {tuple(g.shape)} is not (n_workers={W}, "
                         f"{p.numel()})")


def run_chunk_ready_exchange(strategy: str, comm: StackedComm,
                             g: torch.Tensor, p: torch.Tensor, slots: tuple,
                             update_fn: Callable, group: GroupPlan,
                             windows: int, n_live=None, stream=None):
    """The chunk-ready dispatch of one dtype group: a ``ChunkReadyExchange``
    at the effective window count, or None when that is 1 (one window
    waits for the whole backward: the caller runs the monolithic
    ``exchange_group`` after it, as the reference does)."""
    if strategy not in PIPELINED_STRATEGIES:
        raise ValueError(f"strategy {strategy!r} has no shard dimension to "
                         f"window; use exchange_group")
    w = effective_windows(group, windows)
    if w == 1:
        return None
    return ChunkReadyExchange(comm, g, p, slots, update_fn, group, w, n_live,
                              stream)


class ChunkReadyExchange:
    """One dtype group's chunk-ready exchange for one step (the
    reference's ``chunk_ready_exchange``): the windowed exchange, each
    window launched once every leaf that meets its strips has its
    gradient in ``g``.  Build it after every row but the last worker's is
    in ``g`` (and ``p``, ``slots`` are final); call ``leaf_ready(i)``
    once leaf i (an index into ``group.paths``) is in the last row, in
    the stream order of the copy; ``finish()`` returns (p', slots).

    On the card each window goes on ``stream``, ordered after the work
    queued so far on the current stream by an event (the leaf's copy, in
    the backward's stream when called from an autograd hook); ``finish``
    makes the current stream wait for it.  ``g``, ``p`` and the slots are
    allocated before the backward, p' at the first window's launch (so it
    is not alive through the backward when the windows are ready only at
    its end), and all are kept until ``finish``: nothing the side stream
    reads or writes is freed under it, and p' is a new buffer the
    backward never reads.  On the CPU a window runs when it becomes
    ready."""

    def __init__(self, comm: StackedComm, g: torch.Tensor, p: torch.Tensor,
                 slots: tuple, update_fn: Callable, group: GroupPlan,
                 windows: int, n_live=None, stream=None):
        check_stacked(comm, g, p)
        self.args = (comm, g, p, slots, update_fn, group, windows)
        self.p_out = None
        self.divisor = mean_divisor(n_live, g.device)
        self.stream = stream
        self.waiting = [set(ix)
                        for ix in chunking.window_leaves(group, windows)]
        self.order: list[int] = []          # windows in launch order
        for w, need in enumerate(self.waiting):
            if not need:                    # padding only: ready now
                self._launch(w)

    def leaf_ready(self, i: int) -> None:
        for w, need in enumerate(self.waiting):
            if i in need:
                need.discard(i)
                if not need:
                    self._launch(w)

    def _launch(self, w: int) -> None:
        comm, g, p, slots, update_fn, group, windows = self.args
        with torch.no_grad():
            if self.p_out is None:
                self.p_out = torch.empty_like(p)
            run = (comm, g, p, slots, update_fn, group, windows, w,
                   self.p_out, self.divisor)
            if self.stream is None:
                exchange_window(*run)
            else:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(g.device))
                self.stream.wait_event(done)
                with torch.cuda.stream(self.stream):
                    exchange_window(*run)
        self.order.append(w)

    def finish(self) -> tuple:
        missing = [w for w, need in enumerate(self.waiting) if need]
        if missing:
            raise RuntimeError(f"windows {missing} never became ready: "
                               f"their leaves' gradients did not arrive")
        if self.stream is not None:
            torch.cuda.current_stream(self.p_out.device).wait_stream(
                self.stream)
        return self.p_out, self.args[3]


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
    check_stacked(comm, g, p)
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
