"""PHub's gradient processing pipeline on stacked workers
(``repro/core/pipeline.py``): the windowed exchange, the chunk-ready
dispatch, and the encoded-wire exchange, in windows too.

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
``chunk_ready_exchange`` and ``run_chunk_ready_wire_exchange``).  Window
w's update may start once every leaf that meets its strips has its
gradient; the engine reports each leaf as the last worker's backward
produces it, and the window's launches go on a side CUDA stream, ordered
after the gradient copies by an event.

**The encoded wire** (``pipelined_wire_exchange``, the reference's):
the ring partial of every shard hops the S workers encoded, each hop
decoding it, adding its own rows and encoding it again; the owner decodes
the last partial, adds its own rows and updates; after the last window
the parameter delta of the whole domain is encoded for the pull, and what
the rounding drops is carried in ``wire_ef``.  On one card the S workers
are the rows of the ``(S, padded)`` gradient buffer (``core/comm.py``),
and shard j's partial starts at worker j+1, as in the reference's ring:

    acc_j = G[j+1, j],  encoded
    acc_j = decode(acc_j) + G[j+k, j],  encoded,   k = 2 .. S-1
    g_j   = (decode(acc_j) + G[j, j]) / N          (at the owner, j)

(indices mod S; G[w, j] is worker w's run of window w's strip of shard j
in row w).  The codec works chunk by chunk and every strip is whole
chunks, so each hop of a window runs over the window's strips of all S
shards at once, packed: one ``quantize_chunks`` or ``dequantize_chunks``
launch a hop, and the owners' tail (``dequant_agg_opt_chunks``, for
Nesterov) one launch a window reading p, m and the owners' rows in place.
Every hop re-quantizes, so the order is part of the result; windows are
whole chunks, so the windowed schedule equals one window bitwise.  N is
the worker count, or a membership's live count: a number (a static
membership: the tail kernel's ``inv_n`` is baked from it, as in the
reference) or a tensor on the card (the sanity gate's, the tail kernel's
divisor pointer; the other rules divide the decoded sum by it).

**Over a process group** (``ProcessGroupExchange``, one worker a rank,
``core/comm.py::ProcessGroupComm``): window w packs this rank's strips
``[j*L + w*Lw, j*L + (w+1)*Lw)`` of every shard j contiguously and sends
them in one ``all_to_all``; the owner makes one update launch on the
``(W, Lw)`` received rows, its slots updated in place, and one pull
(``all_gather``) follows the last window, as the reference's tail
all-gather does.  Over an encoded wire the ring above becomes real hops:
shard j's partial starts at rank j+1, each hop sends the encoded partial
(the payload as uint32 words, the f32 scales) to rank+1, and the receiver
decodes it, adds its own run and encodes it again; the owner's tail is
the same kernel on its own rows.  The pull encodes the shard's delta plus
``wire_ef``, all-gathers words and scales, and every rank decodes all S
shards.  The hop order is the stacked ring's, so both Comms give the same
bits.

**The hierarchical strategy** (``core/exchange.py``; P pods of D, S = D
shards): every mode above runs on the pod's rows.  Identity wire: window
w's in-pod adds (each pod's rows summed in data order into its row d = 0,
``pod_rows_``) come before its launches, which read the P partial rows
through the row stride with divisor N.  Over a process group a window
pushes its strips inside the pod, sums the D received rows in data order
and gathers its owner strip across the pods (``cross_gather``).  The
encoded ICI wire rings inside each pod (shard j's partial starts at the
pod's worker j+1; on one card the pods' rings run packed, one codec launch
a hop), the owner decodes and adds its own run, and the cross-pod leg
follows: identity (the P decoded partials summed in pod order by the
rule's kernel, divisor N) or the DCN tier scales-only; the fused tail is
not used once there is a cross-pod leg, as in the reference.  The pull
is the encoded delta plus ``wire_ef`` inside the pod.

**The DCN tier** (``pipelined_dcn_exchange``, the reference's; identity
ICI wire, an encoded ``wire_format_dcn``): per window, each pod's
partial of its owner strips plus that pod's residual ``x`` is encoded
(one ``quantize_chunks`` launch over the window's strips of every (pod,
shard), packed), the words and scales cross the pods, every pod's row is
decoded (one ``dequantize_chunks`` launch) and the P decoded rows go to
the rule's kernel as stacked rows with divisor N: the kernel adds them in
pod order and divides, which is the reference's fixed-pod-order sum and
``/ N`` (one route, the same arithmetic; no separate sum pass).  The new
residual is ``x - decode(encode(x))``, per pod: on one card ``wire_ef``
holds (P*S, L) rows pod-major; a rank keeps its own (L,).  A single pod
skips the leg and passes the residual through untouched, as the
reference does.  The ring flavour runs even at one window, so windowed
and monolithic DCN exchanges share one code path and equal each other
bitwise.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..kernels.agg_opt.ref import own_strips
from . import chunking
from .chunking import GroupPlan
from .comm import ProcessGroupComm, StackedComm, require_stacked

PIPELINED_STRATEGIES = ("sharded_ps", "hierarchical")


def check_pipeline(tc) -> None:
    """Raise where the reference's engine raises for the pipeline's
    options: chunk-ready dispatch or windows on a strategy with no shard
    dimension, flat residency on one with no chunk domain.  Every wire
    runs in windows and with chunk-ready dispatch."""
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


def tiers(comm, strategy: str) -> tuple[int, int]:
    """(P, S): the pods and the shards of one pod a chunk strategy
    exchanges over: hierarchical (comm.pods, D), sharded_ps (1, W), flat
    across the pods."""
    if strategy == "hierarchical":
        return comm.pods, comm.pod_size
    return 1, comm.n_shards(strategy)


def ring_tier(comm, strategy: str) -> str:
    """The tier a chunk strategy's ring and pull cross: sharded_ps's ring
    spans the pods when there are several ("dcn"), hierarchical's stays
    inside one ("ici"), as the cost model prices them."""
    return ("dcn" if strategy == "sharded_ps" and comm.pods > 1
            else "ici")


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
    one-element f32 tensor on ``device`` (a number by a fill: no copy from
    the host)."""
    if n_live is None:
        return None
    if isinstance(n_live, torch.Tensor):
        return n_live.to(device, torch.float32).reshape(1)
    return torch.full((1,), float(n_live), dtype=torch.float32,
                      device=device)


def pod_rows_(g: torch.Tensor, pods: int, windows: int = 1, w: int = 0,
              on_hop: Optional[Callable] = None) -> torch.Tensor:
    """The hierarchical in-pod partials of window w: g is the (P*D, n)
    stacked buffer, pod q's rows q*D .. q*D+D-1; each pod's D rows of
    window w's strips (D shards) are added in data order into its row
    d = 0, in place, in g's dtype (D-1 adds over every pod at once).
    Returns the (P, n) view of the rows d = 0 (``D*n`` elements apart),
    whose window-w strips now hold the pods' partials.  ``on_hop(parts)``
    sees each add as one in-pod hop: the strip of shard 0 that worker
    (pod 0, d) hands its owner."""
    R, n = g.shape
    D = R // pods
    gp = g.view(pods, D, n)
    if D > 1:
        L = n // D
        Lw = L // windows
        strips = gp.view(pods, D, D, L)[..., w * Lw:(w + 1) * Lw]
        for d in range(1, D):
            strips[:, 0].add_(strips[:, d])
            if on_hop is not None:
                on_hop((strips[0, d, 0],))
    return gp[:, 0]


def pipelined_exchange(comm, g: torch.Tensor, p: torch.Tensor,
                       slots: tuple, update_fn: Callable, windows: int,
                       n_live=None, strategy: str = "sharded_ps") -> tuple:
    """The windowed counterpart of ``exchange_group``: windows 0 .. W-1 in
    order, each ``WindowedExchange.window``.  Returns (p', slots), the
    slots updated in place; p' equals the monolithic exchange's bitwise."""
    ex = _windowed(comm)(comm, g, p, slots, update_fn, windows, n_live,
                         strategy=strategy)
    for w in range(windows):
        ex.window(w)
    return ex.finish()


def run_exchange(strategy: str, comm, g: torch.Tensor,
                 p: torch.Tensor, slots: tuple, update_fn: Callable,
                 group: GroupPlan, windows: int, n_live=None) -> tuple:
    """Dispatch one dtype group over the identity wire: the windowed
    exchange when the strategy has a shard dimension and more than one
    effective window, else the monolithic ``exchange_group``, unchanged."""
    from .exchange import exchange_group
    if strategy in PIPELINED_STRATEGIES:
        w = effective_windows(group, windows)
        if w > 1:
            return pipelined_exchange(comm, g, p, slots, update_fn, w,
                                      n_live, strategy)
    return exchange_group(comm, g, p, slots, update_fn, n_live, strategy)


def check_stacked(comm, g: torch.Tensor, p: torch.Tensor):
    """Raise unless g is the (local workers, p.numel()) buffer of this
    process's rows: every worker's on the stacked Comm, one a rank."""
    W = comm.local_workers()
    if tuple(g.shape) != (W, p.numel()):
        raise ValueError(f"g {tuple(g.shape)} is not (local workers={W}, "
                         f"{p.numel()})")


def _check_wire_strategy(strategy: str, wire) -> None:
    if wire.is_identity:
        raise ValueError("identity wire travels exchange_group (the "
                         "pre-wire path); run_wire_exchange is the encoded "
                         "datapath")
    if strategy not in PIPELINED_STRATEGIES:
        raise ValueError(
            f"wire format {wire.name!r} needs a strategy with a shard "
            f"dimension {PIPELINED_STRATEGIES}; {strategy!r} has none")


def _check_dcn_strategy(strategy: str, wire_dcn) -> None:
    if wire_dcn is None:
        raise ValueError("run_dcn_exchange needs an encoded DCN wire; an "
                         "identity DCN tier travels run_exchange")
    if strategy != "hierarchical":
        raise ValueError(
            f"per-tier DCN wire {wire_dcn.name!r} needs the two-tier "
            f"'hierarchical' strategy; {strategy!r} has no DCN leg")


def run_chunk_ready_exchange(strategy: str, comm: StackedComm,
                             g: torch.Tensor, p: torch.Tensor, slots: tuple,
                             update_fn: Callable, group: GroupPlan,
                             windows: int, n_live=None, stream=None, *,
                             wire=None, wire_dcn=None, residual=None,
                             fused_dequant=None):
    """The chunk-ready dispatch of one dtype group: a ``ChunkReadyExchange``
    at the effective window count, or None when that is 1 (one window
    waits for the whole backward: the caller runs the monolithic exchange
    after it, as the reference does).  With an encoded ``wire`` (and its
    ``residual``, the ``wire_ef`` slot, and ``fused_dequant``) each window
    runs the encoded ring and ``finish`` the pull, as
    ``run_chunk_ready_wire_exchange`` does; with an encoded ``wire_dcn``
    alone (and its ``residual``) each window runs the DCN tier, as
    ``run_chunk_ready_dcn_exchange`` does."""
    if strategy not in PIPELINED_STRATEGIES:
        raise ValueError(f"strategy {strategy!r} has no shard dimension to "
                         f"window; use exchange_group")
    require_stacked(comm, "chunk-ready dispatch")
    if wire is not None:
        _check_wire_strategy(strategy, wire)
    elif wire_dcn is not None:
        _check_dcn_strategy(strategy, wire_dcn)
    w = effective_windows(group, windows)
    if w == 1:
        return None
    return ChunkReadyExchange(comm, g, p, slots, update_fn, group, w, n_live,
                              stream, strategy=strategy, wire=wire,
                              wire_dcn=wire_dcn, residual=residual,
                              fused_dequant=fused_dequant)


def _strip(v: torch.Tensor, S: int, windows: int, w: int) -> torch.Tensor:
    """Window w's strip of every shard of the (n,) vector v, in place: an
    (S, Lw) view whose rows lie L = n/S apart."""
    L = v.numel() // S
    Lw = L // windows
    return v.view(S, L)[:, w * Lw:(w + 1) * Lw]


def _runs(g: torch.Tensor, k: int, windows: int, w: int, pods: int = 1):
    """(the packed columns, the row and its columns that hold G[q, j+k, j])
    of window w for every pod q and shard j: g is (pods*S, n), pod q's
    rows q*S .. q*S+S-1, packed pod-major then shard."""
    R, n = g.shape
    S = R // pods
    L = n // S
    Lw = L // windows
    return [(slice((q * S + j) * Lw, (q * S + j + 1) * Lw),
             q * S + (j + k) % S,
             slice(j * L + w * Lw, j * L + (w + 1) * Lw))
            for q in range(pods) for j in range(S)]


def add_ring_rows_(acc: torch.Tensor, g: torch.Tensor, k: int,
                   windows: int = 1, w: int = 0, pods: int = 1
                   ) -> torch.Tensor:
    """acc[pod q, shard j] += G[q, j+k, j] for every pod and shard of
    window w (acc holds the window's strips packed), in f32, in place."""
    for packed, row, cols in _runs(g, k, windows, w, pods):
        acc[packed].add_(g[row, cols])
    return acc


def ring_rows(g: torch.Tensor, k: int, windows: int = 1, w: int = 0,
              pods: int = 1) -> torch.Tensor:
    """The f32 vector of window w's strips packed, pod q's shard j being
    G[q, j+k, j]; at one window and one pod the (padded,) vector whose
    shard j is G[j+k, j]."""
    R, n = g.shape
    out = torch.empty(n * pods // windows, dtype=torch.float32,
                      device=g.device)
    for packed, row, cols in _runs(g, k, windows, w, pods):
        out[packed].copy_(g[row, cols])
    return out


def ring_reduce_scatter(g: torch.Tensor, wire, chunk_elems: int,
                        windows: int = 1, w: int = 0, pods: int = 1,
                        on_hop: Optional[Callable] = None
                        ) -> Optional[tuple]:
    """The encoded ring reduce-scatter of window w of every shard at once:
    g is the (S, padded) stacked gradient buffer, or (pods*S, padded) with
    each pod's S rows ringing on their own (all pods packed in one codec
    launch a hop); returns the still-encoded partial that arrives at each
    owner (the window's strips packed in one wire tuple), without the
    owner's own rows; None when S == 1 (nothing crosses a wire).  The
    reference's ``rs_window``.  ``on_hop(parts)`` sees each hop's payload
    as it is encoded: the encoded strip that owner 0 receives (packed
    first)."""
    R = g.shape[0]
    S = R // pods
    if S == 1:
        return None
    parts = wire.encode(ring_rows(g, 1, windows, w, pods), chunk_elems)
    if on_hop is not None:
        on_hop(tuple(t.view(R, -1)[0] for t in parts))
    for k in range(2, S):
        acc = wire.decode(parts, chunk_elems)
        del parts                          # free the payload before encoding
        parts = wire.encode(add_ring_rows_(acc, g, k, windows, w, pods),
                            chunk_elems)
        del acc
        if on_hop is not None:
            on_hop(tuple(t.view(R, -1)[0] for t in parts))
    return parts


def _divisors(comm, n_live, device, hier: bool, wire) -> tuple:
    """(the rule's divisor, the encoded tail's gate divisor) of a windowed
    exchange: None where the kernel divides by its row count or bakes
    1/N (the identity sharded_ps step, one worker), else N (W or the live
    count) as a tensor on the device."""
    W = comm.n_workers
    gate = mean_divisor(n_live, device) \
        if isinstance(n_live, torch.Tensor) else None
    if W == 1:
        return None, gate
    if wire is None and not hier:
        return mean_divisor(n_live, device), gate
    return mean_divisor(W if n_live is None else n_live, device), gate


class WindowedExchange:
    """One dtype group's windowed exchange for one step, over the identity
    wire or an encoded one: ``window(w)`` runs window w (any order), and
    ``finish()`` returns (p', slots) (identity) or (p', slots, wire_ef')
    (an encoded wire, after the pull; an encoded DCN tier, its residual
    updated in place).  p' is allocated at the first window, the slots are
    updated in place.

    Identity: ``exchange_window`` on the worker rows (sharded_ps) or on
    the pods' partial rows after window w's in-pod adds (hierarchical), the
    divisor the live count (None: divide by W) or N; an encoded DCN tier
    at P > 1 encodes each pod's partial plus its residual and the rule
    runs on the decoded rows.  Encoded: window w's ring over its strips
    (``ring_reduce_scatter``, inside each pod), then at one pod the owners'
    tail: ``fused_dequant`` (one launch over the window's strips, p, m and
    the owners' rows read in place; a gate's ``n_live`` tensor goes to its
    divisor pointer, a static membership's is baked in its ``inv_n``) or
    the decoded sum plus the owners' rows divided by N and the rule, per
    (window, shard) (one call over the domain at one window); at S == 1
    the rule on the own row (the mean over one worker is exact); at P > 1
    the decoded partials (through the DCN tier, scales-only, if one is
    engaged) go to the rule's kernel as P rows with divisor N.
    ``finish`` runs the encoded wire's pull: the delta of the whole domain
    plus ``residual`` encoded and decoded, the parameters written back p
    plus the decoded delta, and what the rounding dropped into
    ``residual``, in place (r + (p' - p) accumulates there first: IEEE
    addition commutes, so these are the bits of (p' - p) + r).

    Each stand-in collective is recorded on the Comm, hop by hop, as
    worker 0 receives it (``StackedComm.record``): the ring's hops and
    the pull's all-gather on the ring's tier, the cross-pod leg on "dcn";
    an encoded wire's from each executed hop's payload, the identity
    wire's from the strips this window's pass reads from the other rows."""

    def __init__(self, comm: StackedComm, g: torch.Tensor, p: torch.Tensor,
                 slots: tuple, update_fn: Callable, windows: int,
                 n_live=None, *, strategy: str = "sharded_ps", wire=None,
                 wire_dcn=None, chunk_elems: int = 0, residual=None,
                 fused_dequant=None):
        check_stacked(comm, g, p)
        self.comm, self.g, self.p, self.slots = comm, g, p, slots
        self.update_fn, self.windows = update_fn, windows
        self.P, self.S = tiers(comm, strategy)
        self.hier = strategy == "hierarchical"
        self.wire, self.wire_dcn, self.ce = wire, wire_dcn, chunk_elems
        self.residual, self.fused_dequant = residual, fused_dequant
        self.divisor, self.gate = _divisors(comm, n_live, g.device,
                                            self.hier, wire)
        self.tier = ring_tier(comm, strategy)
        self.p_out = None

    def _hop(self, parts: tuple) -> None:
        """Record one ring hop: ``parts``, what worker 0 receives."""
        self.comm.record("ring_hop", "collective-permute", self.tier, parts)

    def window(self, w: int) -> None:
        if self.p_out is None:
            self.p_out = torch.empty_like(self.p)
        g, p, p_out, slots = self.g, self.p, self.p_out, self.slots
        P, S, W = self.P, self.S, self.windows
        if self.wire is None:
            # the identity ring: the in-pod adds, or the other workers'
            # strips of shard 0 this window's pass reads
            if self.hier:
                rows = pod_rows_(g, P, W, w, on_hop=self._hop)
            else:
                rows = g
                self.comm.record_scatter(
                    "ring_hop", "collective-permute", self.tier,
                    [_strip(r, S, W, w) for r in g], S)
            if self.wire_dcn is not None and P > 1:
                self._dcn_leg(rows, w)
                return
            if self.hier:
                self.comm.record_all_reduce(
                    "cross_reduce", "all-reduce", "dcn",
                    [_strip(r, S, W, w)[0] for r in rows], P)
            exchange_window(rows, p, slots, self.update_fn, S, W, w, p_out,
                            self.divisor)
            return
        if P > 1:
            self._pods_wire(w)
            return
        if S == 1:
            Lw = p.numel() // W
            cols = slice(w * Lw, (w + 1) * Lw)
            self.update_fn(p[cols], g[0, cols], tuple(s[cols] for s in slots),
                           p_out=p_out[cols], at=cols.start)
            return
        L = p.numel() // S
        Lw = L // W
        parts = ring_reduce_scatter(g, self.wire, self.ce, W, w,
                                    on_hop=self._hop)
        if self.fused_dequant is not None:
            self.fused_dequant(
                _strip(p, S, W, w), parts, own_strips(g, W, w),
                tuple(_strip(s, S, W, w) for s in slots),
                divisor=self.gate, p_out=_strip(p_out, S, W, w),
                at=tuple(j * L + w * Lw for j in range(S)))
            return
        gsum = self.wire.decode(parts, self.ce)
        del parts
        add_ring_rows_(gsum, g, 0, W, w)
        # divided, by a tensor on the device: PyTorch's CUDA division by a
        # Python number multiplies by the reciprocal
        gsum.div_(self.divisor)
        if W == 1:                       # the strips are the whole domain
            self.update_fn(p, gsum, slots, p_out=p_out, at=0)
            return
        for j in range(S):
            cols = slice(j * L + w * Lw, j * L + (w + 1) * Lw)
            self.update_fn(p[cols], gsum[j * Lw:(j + 1) * Lw],
                           tuple(s[cols] for s in slots), p_out=p_out[cols],
                           at=cols.start)

    def _dcn_leg(self, rows: torch.Tensor, w: int) -> None:
        """Window w's DCN tier (identity ICI wire, P > 1): x = each pod's
        partial plus its residual, packed (pod, shard); one encode and one
        decode launch; the residual becomes x - decode(encode(x)); the P
        decoded rows to the rule's kernel with divisor N."""
        P, S, W = self.P, self.S, self.windows
        n = self.p.numel()
        L = n // S
        cols = slice(w * (L // W), (w + 1) * (L // W))
        part = rows.unflatten(1, (S, L))[..., cols]            # (P, S, Lw)
        res = self.residual.view(P, S, L)[..., cols]
        x = torch.add(part, res)                                # f32
        parts = self.wire_dcn.encode(x.view(-1), self.ce)
        self._cross_gather(parts)
        res.copy_(x)                  # x - decode(x) lands there below:
        del x                         # x and its decode are never both alive
        d = self.wire_dcn.decode(parts, self.ce)
        del parts
        res.sub_(d.view_as(res))
        self._rule_rows(d.view(P, -1), w)

    def _pods_wire(self, w: int) -> None:
        """Window w over an encoded ICI wire with P > 1 pods: the pods'
        rings (packed), each owner's decoded partial plus its own run, the
        cross-pod leg (identity, or the DCN tier scales-only) and the rule
        on the P rows with divisor N."""
        g, P, S, W, ce = self.g, self.P, self.S, self.windows, self.ce
        parts = ring_reduce_scatter(g, self.wire, ce, W, w, P,
                                    on_hop=self._hop)
        if parts is None:                 # one worker a pod: its own rows
            gsum = ring_rows(g, 0, W, w, P)
        else:
            gsum = self.wire.decode(parts, ce)
            del parts
            add_ring_rows_(gsum, g, 0, W, w, P)
        if self.wire_dcn is None:
            # the cross-pod all-reduce of worker 0's decoded strip
            self.comm.record_all_reduce("cross_reduce", "all-reduce", "dcn",
                                        gsum.view(P, S, -1)[:, 0], P)
        else:
            parts = self.wire_dcn.encode(gsum, ce)
            self._cross_gather(parts)
            del gsum
            gsum = self.wire_dcn.decode(parts, ce)
            del parts
        self._rule_rows(gsum.view(P, -1), w)

    def _cross_gather(self, parts: tuple) -> None:
        """Record the DCN tier's all-gather of the encoded (pod, shard)
        strips ``parts``: worker 0 receives the other pods' shard 0."""
        P, S = self.P, self.S
        self.comm.record_gather("cross_gather", "all-gather", "dcn",
                                tuple(t.view(P, S, -1)[:, 0] for t in parts),
                                P)

    def _rule_rows(self, rows: torch.Tensor, w: int) -> None:
        """The rule on window w's packed (P, S*Lw) rows (pod q's shard j
        at columns [j*Lw, (j+1)*Lw)), divisor N: one launch at one window
        (the rows are then the domain's layout), else one a shard."""
        p, p_out, slots, S, W = (self.p, self.p_out, self.slots, self.S,
                                 self.windows)
        if W == 1:
            self.update_fn(p, rows, slots, divisor=self.divisor, p_out=p_out,
                           at=0)
            return
        L = p.numel() // S
        Lw = L // W
        for j in range(S):
            cols = slice(j * L + w * Lw, j * L + (w + 1) * Lw)
            self.update_fn(p[cols], rows[:, j * Lw:(j + 1) * Lw],
                           tuple(s[cols] for s in slots),
                           divisor=self.divisor, p_out=p_out[cols],
                           at=cols.start)

    def finish(self) -> tuple:
        S = self.S
        if self.wire is None:
            self.comm.record_gather("pull", "all-gather", self.tier,
                                    (self.p_out,), S)
            if self.wire_dcn is not None:
                return self.p_out, self.slots, self.residual
            return self.p_out, self.slots
        # pull: encode the delta plus the carried residual; the decoded
        # payload is both what the residual keeps and what the workers add
        # to p
        p, ce = self.p, self.ce
        e = self.residual.add_(self.p_out.float() - p.float())
        self.p_out = None
        parts = self.wire.encode(e, ce)
        self.comm.record_gather("pull", "all-gather", self.tier, parts, S)
        d = self.wire.decode(parts, ce)
        del parts
        r = e.sub_(d)
        return d.add_(p).to(p.dtype), self.slots, r


def exchange_window(rows: torch.Tensor, p: torch.Tensor, slots: tuple,
                    update_fn: Callable, S: int, windows: int, w: int,
                    p_out: torch.Tensor, divisor=None) -> None:
    """Window w of the stacked windowed exchange over the identity wire:
    for every shard j of the S, the fused aggregate+update of its strip,
    one launch reading the strip of every row of ``rows`` (R, padded) in
    place (the workers' rows, or the pods' partial rows); p' into
    ``p_out`` at the strip's offsets, the slots updated in place.  One row
    and no divisor is one worker: the reduce-scatter is the identity and
    the mean over one worker exact (the reference's path into
    agg_opt_chunks), as in ``exchange_group``."""
    L = p.numel() // S
    Lw = L // windows
    for j in range(S):
        sl = slice(j * L + w * Lw, j * L + (w + 1) * Lw)
        sw = tuple(s[sl] for s in slots)
        if rows.shape[0] == 1 and divisor is None:
            update_fn(p[sl], rows[0, sl], sw, p_out=p_out[sl], at=sl.start)
        else:
            update_fn(p[sl], rows[:, sl], sw, divisor=divisor,
                      p_out=p_out[sl], at=sl.start)


class ChunkReadyExchange:
    """One dtype group's chunk-ready exchange for one step (the
    reference's ``chunk_ready_exchange``, and over an encoded ``wire``
    its ``run_chunk_ready_wire_exchange``, over an encoded ``wire_dcn``
    its ``run_chunk_ready_dcn_exchange``): the windowed exchange, each
    window launched once every leaf that meets its strips has its
    gradient in ``g``.  Build it after every row but the last worker's is
    in ``g`` (and ``p``, ``slots`` are final); call ``leaf_ready(i)``
    once leaf i (an index into ``group.paths``) is in the last row, in
    the stream order of the copy; ``finish()`` returns what
    ``WindowedExchange.finish`` does (the encoded wire's pull runs there,
    after every window).

    On the card each window goes on ``stream``, ordered after the work
    queued so far on the current stream by an event (the leaf's copy, in
    the backward's stream when called from an autograd hook); ``finish``
    makes the current stream wait for it.  ``g``, ``p`` and the slots are
    allocated before the backward, p' at the first window's launch (so it
    is not alive through the backward when the windows are ready only at
    its end), and all are kept until ``finish``: nothing the side stream
    reads or writes is freed under it, and p' is a new buffer the
    backward never reads.  The hierarchical in-pod adds of a window run
    on the side stream with its launches.  On the CPU a window runs when
    it becomes ready."""

    def __init__(self, comm: StackedComm, g: torch.Tensor, p: torch.Tensor,
                 slots: tuple, update_fn: Callable, group: GroupPlan,
                 windows: int, n_live=None, stream=None, *,
                 strategy: str = "sharded_ps", wire=None, wire_dcn=None,
                 residual=None, fused_dequant=None):
        self.ex = WindowedExchange(comm, g, p, slots, update_fn, windows,
                                   n_live, strategy=strategy, wire=wire,
                                   wire_dcn=wire_dcn,
                                   chunk_elems=group.chunk_elems,
                                   residual=residual,
                                   fused_dequant=fused_dequant)
        self.g = g
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
        with torch.no_grad():
            if self.ex.p_out is None:        # on the backward's stream
                self.ex.p_out = torch.empty_like(self.ex.p)
            if self.stream is None:
                self.ex.window(w)
            else:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(self.g.device))
                self.stream.wait_event(done)
                with torch.cuda.stream(self.stream):
                    self.ex.window(w)
        self.order.append(w)

    def finish(self) -> tuple:
        missing = [w for w, need in enumerate(self.waiting) if need]
        if missing:
            raise RuntimeError(f"windows {missing} never became ready: "
                               f"their leaves' gradients did not arrive")
        if self.stream is not None:
            torch.cuda.current_stream(self.g.device).wait_stream(
                self.stream)
        with torch.no_grad():
            return self.ex.finish()


def pipelined_wire_exchange(comm, g: torch.Tensor,
                            p: torch.Tensor, slots: tuple,
                            update_fn: Callable, wire, chunk_elems: int,
                            residual: torch.Tensor,
                            fused_dequant: Optional[Callable] = None,
                            windows: int = 1, n_live=None,
                            strategy: str = "sharded_ps", wire_dcn=None):
    """One dtype group's exchange over an encoded wire, windows 0 .. W-1
    in order, then the pull.  g: (W, padded) stacked gradients; p:
    (padded,); ``slots``: the rule's (padded,) state vectors, updated in
    place; ``residual``: the (padded,) f32 ``wire_ef`` slot.
    ``fused_dequant(p, parts, g_own, slots, divisor=, p_out=, at=)``
    fuses the owner's decode, its own rows and the mean into the rule
    (``ShardedOptimizer.kernel_dequant_update``; unused once a cross-pod
    leg follows the ring); without it the partial is decoded, the own
    rows added, the sum divided by N and handed to ``update_fn``.
    ``n_live``: None (N = W), a number (a static membership) or a 0-dim
    tensor on the card (the gate's).  ``strategy``: sharded_ps or
    hierarchical (the ring inside each pod, then the cross-pod leg, over
    ``wire_dcn`` scales-only if given).  Returns (p', slots', residual'),
    where p' is p plus the decoded pull delta (not the rule's p'): what
    every worker applies after the all-gather, which is the identity on
    one card.  Over a process group g is this rank's (1, padded) row and
    ``slots`` and ``residual`` its shard's (L,); residual' is written into
    ``residual``, as the slots are updated in place."""
    ex = _windowed(comm)(comm, g, p, slots, update_fn, windows, n_live,
                         strategy=strategy, wire=wire, wire_dcn=wire_dcn,
                         chunk_elems=chunk_elems, residual=residual,
                         fused_dequant=fused_dequant)
    for w in range(windows):
        ex.window(w)
    return ex.finish()


def run_wire_exchange(strategy: str, comm, g: torch.Tensor,
                      p: torch.Tensor, slots: tuple, update_fn: Callable,
                      group: GroupPlan, wire, residual: torch.Tensor,
                      fused_dequant: Optional[Callable] = None,
                      windows: int = 1, n_live=None, wire_dcn=None):
    """Dispatch one dtype group over a non-identity wire at the effective
    window count (one window is the schedule's W = 1, as in the
    reference); the identity wire takes ``run_exchange``."""
    _check_wire_strategy(strategy, wire)
    if wire_dcn is not None:
        _check_dcn_strategy(strategy, wire_dcn)
    return pipelined_wire_exchange(comm, g, p, slots, update_fn, wire,
                                   group.chunk_elems, residual,
                                   fused_dequant,
                                   effective_windows(group, windows), n_live,
                                   strategy, wire_dcn)


def pipelined_dcn_exchange(comm, g: torch.Tensor, p: torch.Tensor,
                           slots: tuple, update_fn: Callable, wire_dcn,
                           chunk_elems: int, residual: torch.Tensor,
                           windows: int = 1, n_live=None):
    """The hierarchical exchange with identity in-pod rings and an encoded
    cross-pod (DCN) leg, windows 0 .. W-1 in order (the reference's
    ``pipelined_dcn_exchange``; module docstring).  g: (W, padded) stacked
    gradients (one row a rank over a process group); ``residual``: the
    DCN tier's ``wire_ef``, (P*padded,) pod-major on the stacked Comm,
    this rank's (L,) over a process group, updated in place.  Returns
    (p', slots', residual')."""
    ex = _windowed(comm)(comm, g, p, slots, update_fn, windows, n_live,
                         strategy="hierarchical", wire_dcn=wire_dcn,
                         chunk_elems=chunk_elems, residual=residual)
    for w in range(windows):
        ex.window(w)
    return ex.finish()


def run_dcn_exchange(strategy: str, comm, g: torch.Tensor, p: torch.Tensor,
                     slots: tuple, update_fn: Callable, group: GroupPlan,
                     wire_dcn, residual: torch.Tensor, windows: int = 1,
                     n_live=None):
    """Dispatch one dtype group over identity ICI and an encoded DCN tier
    at the effective window count; the windowed flavour runs even at one
    window, so windowed and monolithic share one code path."""
    _check_dcn_strategy(strategy, wire_dcn)
    return pipelined_dcn_exchange(comm, g, p, slots, update_fn, wire_dcn,
                                  group.chunk_elems, residual,
                                  effective_windows(group, windows), n_live)


def _windowed(comm):
    """The windowed exchange's class for ``comm``."""
    return (ProcessGroupExchange if isinstance(comm, ProcessGroupComm)
            else WindowedExchange)


class ProcessGroupExchange:
    """``WindowedExchange`` over a process group, one worker a rank: g is
    this rank's (1, padded) gradient row, p the whole (padded,) vector,
    ``slots`` (and an encoded wire's or DCN tier's ``residual``) the (L,)
    state of the shard this rank owns, updated in place.  ``window(w)``
    runs window w (every rank the same windows in the same order: each is
    a collective), ``finish()`` the pull and returns what
    ``WindowedExchange.finish`` does, p' the whole new (padded,) vector on
    every rank.  sharded_ps exchanges over the world (S = W, this rank
    owns shard ``rank``); hierarchical over the pod's subgroup (S = D,
    shard ``data_index``), the cross-pod leg over the ranks of the same
    data index.

    Identity: window w's strips of every shard of the group, packed, go
    out in one push; sharded_ps runs the rule on the (W, Lw) received rows
    (its kernel sums them in worker order and divides by W or the live
    count); hierarchical sums the D received rows in data order into the
    first, gathers that partial across the pods (or, with an encoded DCN
    tier, encodes it plus its residual, gathers the words and scales and
    decodes the P rows) and runs the rule on the P rows with divisor N.
    Encoded: window w's ring (``_ring``, inside the group) brings the
    still-encoded partial of this rank's strip; at one pod the tail runs
    as on the stacked Comm, on this rank's own strip; at P > 1 the decoded
    partial plus the own run crosses the pods (identity, or the DCN tier
    scales-only) and the rule runs on the P rows; at S == 1 and one pod
    the rule on the own row."""

    def __init__(self, comm: ProcessGroupComm, g: torch.Tensor,
                 p: torch.Tensor, slots: tuple, update_fn: Callable,
                 windows: int, n_live=None, *, strategy: str = "sharded_ps",
                 wire=None, wire_dcn=None, chunk_elems: int = 0,
                 residual=None, fused_dequant=None):
        check_stacked(comm, g, p)
        self.hier = strategy == "hierarchical"
        self.P, self.S = tiers(comm, strategy)
        self.over = "pod" if self.hier else "world"
        self.r = comm.data_index if self.hier else comm.rank
        self.L = L = p.numel() // self.S
        self.Lw = L // windows
        self.comm, self.row, self.p = comm, g[0], p
        self.p_sh = p[self.r * L:(self.r + 1) * L]
        self.slots, self.update_fn, self.windows = slots, update_fn, windows
        self.wire, self.wire_dcn, self.ce = wire, wire_dcn, chunk_elems
        self.residual, self.fused_dequant = residual, fused_dequant
        self.divisor, self.gate = _divisors(comm, n_live, g.device,
                                            self.hier, wire)
        self.p_out = None              # the new shard, (L,)

    def _run(self, j: int, w: int) -> torch.Tensor:
        """This rank's run of window w's strip of shard j."""
        lo = j * self.L + w * self.Lw
        return self.row[lo:lo + self.Lw]

    def window(self, w: int) -> None:
        if self.p_out is None:
            self.p_out = torch.empty_like(self.p_sh)
        comm, S, P = self.comm, self.S, self.P
        cols = slice(w * self.Lw, (w + 1) * self.Lw)
        p, p_out = self.p_sh[cols], self.p_out[cols]
        slots = tuple(s[cols] for s in self.slots)
        at = self.r * self.L + cols.start      # the strip in the group
        if self.wire is None:
            rows = comm.push(_strip(self.row, S, self.windows, w), self.over)
            if self.hier:
                for d in range(1, S):     # the in-pod sum, in data order
                    rows[0].add_(rows[d])
                if P > 1:
                    rows = self._cross(rows[0], w, residual=True)
                else:
                    rows = rows[:1]
            self._rule(p, rows, slots, p_out, at)
            return
        own = self._run(self.r, w)
        if P > 1:
            if S > 1:
                gsum = self.wire.decode(self._ring(w), self.ce)
                gsum.add_(own)
            else:
                gsum = own.float()
            self._rule(p, self._cross(gsum, w, residual=False), slots,
                       p_out, at)
            return
        if S == 1:
            self.update_fn(p, own, slots, p_out=p_out, at=at)
            return
        parts = self._ring(w)
        if self.fused_dequant is not None:
            self.fused_dequant(p, parts, own, slots, divisor=self.gate,
                               p_out=p_out, at=at)
            return
        gsum = self.wire.decode(parts, self.ce)
        del parts
        # divided, by a tensor on the device (see WindowedExchange.window)
        gsum.add_(own).div_(self.divisor)
        self.update_fn(p, gsum, slots, p_out=p_out, at=at)

    def _rule(self, p, rows, slots, p_out, at: int) -> None:
        """The rule on the rows this rank aggregates: pre-aggregated for
        one worker in all, else stacked with the divisor."""
        if self.comm.n_workers == 1:
            self.update_fn(p, rows[0], slots, p_out=p_out, at=at)
        else:
            self.update_fn(p, rows, slots, divisor=self.divisor,
                           p_out=p_out, at=at)

    def _cross(self, x: torch.Tensor, w: int, residual: bool
               ) -> torch.Tensor:
        """The cross-pod leg of window w's owner strip: the (P, Lw) rows
        of every pod's ``x`` in pod order, gathered as they are, or
        through the DCN tier (encoded, gathered, every row decoded; with
        ``residual`` this pod's residual is added before the encode and
        becomes x - decode(encode(x)))."""
        dcn, ce = self.wire_dcn, self.ce
        if dcn is None:
            return self.comm.cross_gather(x)
        if residual:
            res = self.residual[w * self.Lw:(w + 1) * self.Lw]
            x = torch.add(x, res)                             # f32
        parts = dcn.pack_words(dcn.encode(x, ce))
        if residual:
            res.copy_(x)              # x - decode(x) lands there below
        del x
        rows = tuple(self.comm.cross_gather(t).view(-1) for t in parts)
        del parts
        d = dcn.decode(dcn.unpack_words(rows), ce)
        del rows
        if residual:
            q = self.comm.pod
            res.sub_(d[q * self.Lw:(q + 1) * self.Lw])
        return d.view(self.P, self.Lw)

    def _ring(self, w: int) -> tuple:
        """Window w's encoded ring over this rank's group: this rank starts
        shard r-1's partial with its own run, then at hop k = 2 .. S-1
        receives shard r-k's partial from the previous member, decodes it,
        adds its run and encodes it again; the last hop brings the partial
        of its own shard, returned still encoded (the stacked ring's order,
        ``ring_reduce_scatter``)."""
        S, r, wire, ce = self.S, self.r, self.wire, self.ce
        parts = wire.encode(self._run((r - 1) % S, w).float(), ce)
        for k in range(2, S):
            parts = self._hop(parts)
            acc = wire.decode(parts, ce)
            del parts                      # free the payload before encoding
            parts = wire.encode(acc.add_(self._run((r - k) % S, w)), ce)
            del acc
        return self._hop(parts)

    def _hop(self, parts: tuple) -> tuple:
        send = self.wire.pack_words(parts)
        recv = self.comm.ring_hop(send, tuple(torch.empty_like(t)
                                              for t in send), self.over)
        return self.wire.unpack_words(recv)

    def finish(self) -> tuple:
        comm, p = self.comm, self.p
        if self.wire is None:
            solo = len(comm.members(self.over)) == 1     # p_out is p'
            out = comm.pull(self.p_out, None if solo else torch.empty_like(p),
                            self.over)
            self.p_out = None
            if self.wire_dcn is not None:
                return out, self.slots, self.residual
            return out, self.slots
        # pull: this shard's delta plus its carried residual encoded, the
        # words and scales gathered, every shard decoded on every rank
        ce, r, L, S = self.ce, self.r, self.L, self.S
        e = self.residual.add_(self.p_out.float() - self.p_sh.float())
        self.p_out = None
        parts = self.wire.pack_words(self.wire.encode(e, ce))
        gathered = tuple(comm.pull(t, t.new_empty(t.numel() * S), self.over)
                         for t in parts)
        del parts
        d = self.wire.decode(self.wire.unpack_words(gathered), ce)
        del gathered
        res = e.sub_(d[r * L:(r + 1) * L])
        return d.add_(p).to(p.dtype), self.slots, res
