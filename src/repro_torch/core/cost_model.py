"""The paper's analytic models and the rack's byte accounting
(``repro/core/cost_model.py``).

1. §2.3.1 / Fig. 4: the least bandwidth a host needs to hide the exchange
   behind compute, for each PS configuration (Table 2).
2. §3.4: the condition under which the hierarchical reduction pays;
   ``cross_rack_bytes``, the 1/N claim.
3. Multi-tenant accounting: each tenant's bytes a co-scheduled step and
   its share of the packed rack chunk domain (DESIGN.md §9).
4. The rebalance traffic of a resize (``rebalance_traffic``, DESIGN.md
   §12).
5. The exchange's link bytes and launches by collective and tier
   (``predicted_exchange_traffic``, the reference's
   ``predicted_exchange_hlo``) and the step time they predict over a
   two-tier ``RackTopology`` (``predicted_step_seconds``); the overlap of
   chunk-ready dispatch with the backward (``backward_overlap_fraction``).
6. §4.9 / Table 5: throughput per dollar.

All of it is host arithmetic, equal to the reference's on the same
inputs.  The port carries no default topology: a ``RackTopology`` holds
only what its caller measured or chose (the reference's default is a CPU
calibration of its tuner; the port's tuner, ``tuning/cost.py``, ranks on
the card's own calibration).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .chunking import dtype_name


# ---------------------------------------------------------------- §2.3.1

def min_bandwidth_bits(config: str, model_bytes: float, compute_s: float,
                       n_workers: int) -> float:
    """Fig. 4 bottom row: the least bidirectional bandwidth a machine
    needs (bits/s) to hide the parameter exchange behind compute."""
    M = model_bytes * 8.0
    N = n_workers
    T = compute_s
    if config == "CC":          # colocated centralized
        return 2 * M * (N - 1) / N / T * 2
    if config == "CS":          # colocated sharded (worker + 1/N PS a host)
        return 2 * M * (N - 1) / N / T * 2
    if config == "NCC":         # non-colocated centralized (PS side)
        return 2 * M * N / T
    if config == "NCS":         # non-colocated sharded (a PS shard)
        return 2 * M / T
    raise ValueError(config)


# ---------------------------------------------------------------- §3.4

@dataclass(frozen=True, kw_only=True)
class RackTopology:
    """A rack's link parameters (§3.4), in two tiers: the intra-rack
    interconnect (ICI: NVLink/PCIe/ToR in the paper, the workers of a pod
    here) and the cross-rack network (DCN: the oversubscribed core, the
    pods), each with its own bandwidth a link and latency a launch.  It
    holds no numbers of its own: the bandwidths, and the latencies
    ``predicted_step_seconds`` reads, come from the caller.

    ``bw_ici`` / ``bw_dcn`` default to ``bw_pbox`` / ``bw_core``;
    ``bw_codec`` is the wire codec's rate in raw bytes/s (None: free, an
    offloaded codec); ``allreduce_factor`` multiplies the time of an
    all-reduce's link bytes (a reduce pass and a broadcast pass over the
    buffer give 2; 1, the default, charges them once as a switch or ring
    offload carries them)."""
    n_workers_per_rack: int      # N
    n_racks: int                 # r
    bw_worker: float             # B_wkr  (bytes/s)
    bw_pbox: float               # B_pbox (bytes/s)
    bw_core: float               # B_core (bytes/s, oversubscribed core)
    bw_ici: float | None = None
    bw_dcn: float | None = None
    lat_ici: float | None = None     # seconds a collective launch, ICI
    lat_dcn: float | None = None     # seconds a collective launch, DCN
    bw_codec: float | None = None
    allreduce_factor: float = 1.0

    @property
    def ici_bandwidth(self) -> float:
        return self.bw_ici if self.bw_ici is not None else self.bw_pbox

    @property
    def dcn_bandwidth(self) -> float:
        return self.bw_dcn if self.bw_dcn is not None else self.bw_core


def hierarchical_beneficial(t: RackTopology, ring: bool = True) -> bool:
    """The paper's §3.4 condition: the flat cross-rack transfer takes
    longer than the two-level reduction."""
    N, r = t.n_workers_per_rack, t.n_racks
    b_bn = min((r - 1) * t.bw_pbox, t.bw_core)
    lhs = max((N - 1) / b_bn, 1.0 / (N * t.bw_worker))
    C = (r - 1) / (r * b_bn) if ring else (N - 1) / (N * b_bn)
    rhs = max(1.0 / t.bw_pbox, N / t.bw_worker) + C
    return lhs > rhs


def cross_rack_bytes(model_bytes: float, n_workers_per_rack: int,
                     n_racks: int, hierarchical: bool) -> float:
    """Cross-rack bytes a rack an iteration (the 1/N claim)."""
    if n_racks <= 1:
        return 0.0
    if hierarchical:
        # only the PBoxes exchange: a ring all-reduce of one model copy
        return 2.0 * model_bytes * (n_racks - 1) / n_racks
    # flat sharded PS: every worker exchanges with every remote shard
    w = n_workers_per_rack
    remote_frac = (n_racks - 1) / n_racks
    return 2.0 * model_bytes * w * remote_frac


# ------------------------------------------------- multi-tenant accounting


def tenant_step_traffic(strategy: str, model_bytes: float,
                        n_workers: int, wire_bytes: float = None) -> dict:
    """Per-worker bytes one tenant contributes to one exchange step (solo
    or co-scheduled: packing changes the layout, not the volume).

    sharded_ps / hierarchical: reduce-scatter out and all-gather back,
    each (N-1)/N of the tenant's bytes a worker; allreduce lowers to the
    same ring pair; centralized_ps pushes and pulls the whole model a
    worker (the §2.3.1 incast).  ``wire_bytes``, if given, is the tenant's
    bytes as encoded; ``wire_push/pull_bytes`` report what the rack
    carries next to the raw figures."""
    N = max(n_workers, 1)
    M = float(model_bytes)
    Mw = M if wire_bytes is None else float(wire_bytes)
    if strategy in ("sharded_ps", "hierarchical", "allreduce",
                    "fsdp_stream"):
        frac = (N - 1) / N
    elif strategy == "centralized_ps":
        frac = 1.0
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    return {"push_bytes": M * frac, "pull_bytes": M * frac,
            "wire_push_bytes": Mw * frac, "wire_pull_bytes": Mw * frac}


def wire_bytes_for_groups(groups, wire=None) -> float:
    """Encoded bytes of (n_elems, dtype, chunk_elems) triples under
    ``wire`` (a ``core/wire.py::WireFormat``; None: raw bytes)."""
    total = 0.0
    for n_elems, dtype, chunk_elems in groups:
        if wire is None:
            total += n_elems * dtype.itemsize
        else:
            total += wire.payload_bytes(n_elems, dtype, chunk_elems)
    return total


def tenant_accounting(domain, strategy: str, n_workers: int,
                      wire=None) -> dict:
    """Per-tenant view of a TenantPackedDomain: model bytes, the padded
    bytes it holds in the packed domain, its share of the domain, and its
    per-step traffic, raw and as encoded under the rack's shared ``wire``.
    The static figures are flat; the per-step traffic is under
    ``"per_step"`` (``PHubConnectionManager.accounting`` adds a
    ``"cumulative"`` block with the same key names beside it).  Wire bytes
    count each tenant's chunk-padded extent: the wire encodes whole
    chunks."""
    padded_total = sum(g.padded * g.dtype.itemsize
                       for g in domain.groups.values())
    out = {}
    for tenant in domain.tenants:
        model_bytes = domain.tenant_bytes(tenant)
        padded = sum(s.padded * g.dtype.itemsize
                     for g in domain.groups.values()
                     for s in g.slots if s.tenant == tenant)
        wire_bytes = wire_bytes_for_groups(
            ((s.padded, g.dtype, g.chunk_elems)
             for g in domain.groups.values()
             for s in g.slots if s.tenant == tenant), wire)
        out[tenant] = {
            "model_bytes": model_bytes,
            "padded_bytes": padded,
            "wire_bytes": wire_bytes,
            "compression": model_bytes / max(wire_bytes, 1e-9),
            "domain_share": padded / max(padded_total, 1),
            "per_step": tenant_step_traffic(strategy, model_bytes,
                                            n_workers,
                                            wire_bytes=wire_bytes),
        }
    return out


# --------------------------------------------------- rebalance accounting

def rebalance_traffic(plan, slot_specs=(), mo: int = 1) -> dict:
    """The migration traffic of one chunk-domain rebalance (DESIGN.md
    §12).  ``plan``: an ``elastic.RebalancePlan``; ``slot_specs``: the
    exchange slots riding the domain (the rules' and ``wire_ef``): every
    moved chunk drags its parameter bytes and one stripe a slot, at the
    slot's dtype; ``mo``: rows a buffer keeps an element (the reference's
    model-parallel ranks; 1 in the port).  Only the delta runs count: a
    chunk whose packed position is unchanged costs nothing."""
    per_group = {}
    moved_total = resident_total = 0.0
    for key, g in plan.groups.items():
        param_b = g.dtype.itemsize
        slot_b = sum(s.resolve_dtype(g.dtype).itemsize for s in slot_specs)
        moved = g.moved_elems() * (param_b + slot_b) * max(mo, 1)
        resident = g.total_elems() * (param_b + slot_b) * max(mo, 1)
        per_group[key] = {"moved_bytes": moved, "resident_bytes": resident,
                          "moved_elems": g.moved_elems(),
                          "total_elems": g.total_elems()}
        moved_total += moved
        resident_total += resident
    return {"moved_bytes": moved_total, "resident_bytes": resident_total,
            "moved_fraction": moved_total / max(resident_total, 1e-9),
            "per_group": per_group}


def _is_identity(wire) -> bool:
    return wire is None or getattr(wire, "name", "identity") == "identity"


# ------------------------------------------- the exchange's link traffic

def predicted_exchange_traffic(groups, *, strategy: str, wire=None,
                               windows: int = 1, n_workers: int = 1,
                               pod_size: int = 1, wire_dcn=None) -> dict:
    """The link bytes and launches of one exchange step by collective kind
    and tier: the reference's ``predicted_exchange_hlo``, whose body
    counts them from the chunk groups (the port has no HLO; the kinds keep
    XLA's names).

    Two figures a (kind, tier): ``by_kind``, what a static parse of the
    reference's optimized HLO sees (the identity windowed ring rolls its
    hops into one loop body, so its collective-permute counts once a
    window), and ``runtime_by_kind``, loop-carried collectives times
    their trip count: the bytes the links carry.  ``per_group`` lists
    each group's operations with their launches.

    ``groups``: chunk groups (``GroupPlan`` / ``PackedGroup``: ``padded``,
    ``shard_len``, ``chunk_elems``, ``n_shards``, ``dtype``); ``wire``: a
    ``core/wire.py::WireFormat`` or None (identity); ``pod_size``: the
    pods of the hierarchical strategy's DCN tier (1: one pod);
    ``wire_dcn``: the DCN tier's own WireFormat or None: engaged, the
    cross-pod leg is a per-window all-gather of the encoded payload
    (``payload * (P-1)`` link bytes) instead of the f32 all-reduce, and
    an identity-ICI schedule rings even in one window.  Models sharded_ps,
    hierarchical and allreduce; anything else raises ValueError."""
    from .pipeline import effective_windows

    identity = _is_identity(wire)
    dcn_wire = wire_dcn is not None and not _is_identity(wire_dcn)
    if strategy not in ("sharded_ps", "hierarchical", "allreduce"):
        raise ValueError(f"strategy {strategy!r} has no traffic model")
    if not identity and strategy == "allreduce":
        raise ValueError("wire encoding rides the pipelined ring "
                         "strategies only")
    if dcn_wire and strategy != "hierarchical":
        raise ValueError("a per-tier DCN wire rides the two-tier "
                         "'hierarchical' strategy only")

    hlo: dict = {}
    runtime: dict = {}
    per_group = []

    def add(kind, tier, hlo_b, runtime_b=None, launches=1):
        hlo.setdefault(kind, {"ici": 0.0, "dcn": 0.0})[tier] += hlo_b
        runtime.setdefault(kind, {"ici": 0.0, "dcn": 0.0})[tier] += (
            hlo_b if runtime_b is None else runtime_b)
        detail.append({"kind": kind, "tier": tier, "hlo_bytes": hlo_b,
                       "runtime_bytes": hlo_b if runtime_b is None
                       else runtime_b, "launches": launches})

    for g in groups:
        detail: list = []
        item = g.dtype.itemsize
        S = max(int(g.n_shards), 1)
        padded_b = g.padded * item
        shard_b = g.shard_len * item
        if strategy == "allreduce":
            N = max(n_workers, 1)
            add("all-reduce", "ici", 2.0 * padded_b * (N - 1) / N,
                launches=1)
            per_group.append({"dtype": dtype_name(g.dtype), "windows": 1,
                              "ops": detail})
            continue
        W = effective_windows(g, windows)
        Lw = g.shard_len // W
        P = pod_size
        ring_tier = ("dcn" if strategy == "sharded_ps" and pod_size > 1
                     else "ici")
        if identity:
            if S > 1 and W == 1 and not dcn_wire:
                add("reduce-scatter", ring_tier, float(shard_b) * (S - 1),
                    launches=S - 1)
            elif S > 1:
                # a ring: one permute in the HLO, S-1 hops at run time
                # (the DCN tier rings even in one window)
                add("collective-permute", ring_tier, float(W * Lw * item),
                    float(W * (S - 1) * Lw * item), launches=W * (S - 1))
            if S > 1:
                add("all-gather", ring_tier, padded_b * (S - 1) / S,
                    launches=1)
            if strategy == "hierarchical" and pod_size > 1:
                if dcn_wire:
                    # the encoded cross-pod reduce: one all-gather of the
                    # payload (and its scales) a window
                    add("all-gather", "dcn",
                        float(W) * wire_dcn.payload_bytes(
                            Lw, g.dtype, g.chunk_elems) * (P - 1),
                        launches=W)
                else:
                    add("all-reduce", "dcn", 2.0 * shard_b * (P - 1) / P,
                        launches=1)
        else:
            hop_b = wire.payload_bytes(Lw, g.dtype, g.chunk_elems)
            wire_padded_b = wire.payload_bytes(g.padded, g.dtype,
                                               g.chunk_elems)
            if S > 1:
                # the encoded ring: every hop is its own permute
                add("collective-permute", ring_tier,
                    float(W * (S - 1)) * hop_b, launches=W * (S - 1))
                add("all-gather", ring_tier, wire_padded_b * (S - 1) / S,
                    launches=1)
            if strategy == "hierarchical" and pod_size > 1:
                if dcn_wire:
                    # the encoded cross-pod reduce of the decoded f32 window
                    add("all-gather", "dcn",
                        float(W) * wire_dcn.payload_bytes(
                            Lw, torch.float32, g.chunk_elems) * (P - 1),
                        launches=W)
                else:
                    # the cross-pod sum runs on the decoded f32 window
                    add("all-reduce", "dcn", 2.0 * (g.shard_len * 4)
                        * (P - 1) / P, launches=1)
        per_group.append({"dtype": dtype_name(g.dtype), "windows": W,
                          "ops": detail})
    return {"by_kind": hlo, "runtime_by_kind": runtime,
            "per_group": per_group}


def predicted_step_seconds(groups, *, strategy: str, topo: RackTopology,
                           wire=None, wire_dcn=None, windows: int = 1,
                           n_workers: int = 1, pod_size: int = 1,
                           compute_s: float = 0.0) -> dict:
    """The exchange step's time over a two-tier ``RackTopology``: each
    tier's link bytes (``predicted_exchange_traffic``'s runtime bytes)
    over its bandwidth plus its sequential launches times its latency (a
    W-window ring over S shards issues W*(S-1) dependent hops); the tiers
    add (the hierarchical schedule serializes each window's ICI ring
    against its DCN reduction); ``compute_s`` adds a flat compute floor.

    ``topo.bw_codec`` prices the wire codec: every raw byte an encoded
    wire passes through it (twice a ring hop, encode and decode, plus the
    decode of the gathered payload; likewise a DCN window) costs ``1 /
    bw_codec`` seconds; None is a free codec.  A tier without a latency
    in ``topo`` raises (the port has no default topology).

    Returns ``{"seconds", "comm_s", "ici_s", "dcn_s", "codec_s",
    "codec_bytes", "bytes", "launches"}``, ``bytes`` and ``launches`` by
    tier."""
    from .pipeline import effective_windows

    if topo.lat_ici is None or topo.lat_dcn is None:
        raise ValueError(
            "predicted_step_seconds needs the topology's launch latencies "
            "(lat_ici, lat_dcn): the port carries no default topology")
    pred = predicted_exchange_traffic(groups, strategy=strategy, wire=wire,
                                      windows=windows, n_workers=n_workers,
                                      pod_size=pod_size, wire_dcn=wire_dcn)
    bytes_t = {"ici": 0.0, "dcn": 0.0}
    time_bytes = {"ici": 0.0, "dcn": 0.0}
    launches = {"ici": 0.0, "dcn": 0.0}
    for gdesc in pred["per_group"]:
        for op in gdesc["ops"]:
            bytes_t[op["tier"]] += op["runtime_bytes"]
            time_bytes[op["tier"]] += op["runtime_bytes"] * (
                topo.allreduce_factor if op["kind"] == "all-reduce"
                else 1.0)
            launches[op["tier"]] += op["launches"]

    identity = _is_identity(wire)
    dcn_wire = wire_dcn is not None and not _is_identity(wire_dcn)
    codec_bytes = 0.0
    for g in groups:
        if strategy == "allreduce":
            continue
        item = g.dtype.itemsize
        S = max(int(g.n_shards), 1)
        W = effective_windows(g, windows)
        Lw = g.shard_len // W
        if not identity and S > 1:
            # an encode and a decode a ring hop, one decode of the gathered
            # whole-domain payload at the end
            codec_bytes += 2.0 * W * (S - 1) * Lw * item + g.padded * item
        if dcn_wire and strategy == "hierarchical" and pod_size > 1:
            # encode the local f32 window, decode the P gathered payloads
            codec_bytes += float(W) * Lw * 4.0 * (1 + pod_size)
    codec_s = (codec_bytes / topo.bw_codec
               if topo.bw_codec and codec_bytes else 0.0)

    bw = {"ici": topo.ici_bandwidth, "dcn": topo.dcn_bandwidth}
    lat = {"ici": topo.lat_ici, "dcn": topo.lat_dcn}
    tier_s = {t: time_bytes[t] / max(bw[t], 1e-9) + launches[t] * lat[t]
              for t in ("ici", "dcn")}
    comm = tier_s["ici"] + tier_s["dcn"] + codec_s
    return {"seconds": compute_s + comm, "comm_s": comm,
            "ici_s": tier_s["ici"], "dcn_s": tier_s["dcn"],
            "codec_s": codec_s, "codec_bytes": codec_bytes,
            "bytes": bytes_t, "launches": launches}


# ------------------------------------------------ backward overlap (§14)

def backward_overlap_fraction(ready_fracs, window_comm_s,
                              backward_s: float) -> dict:
    """Overlap of chunk-ready dispatch with the backward (DESIGN.md §14).

    ``ready_fracs``: each window's readiness fraction in dispatch order
    (``chunking.chunk_ready_schedule``'s ``ready`` reordered by its
    ``order``); ``window_comm_s``: each window's exchange time in the same
    order; ``backward_s``: the backward's duration.  Windows start when
    ready and serialize on the exchange: ``start_w = max(end_{w-1},
    ready_w * backward_s)``; what a window transfers before
    ``backward_s`` is hidden.

    Returns ``overlap_fraction`` (hidden / total, 0 without comm),
    ``hidden_s``, ``exposed_s`` (comm past the backward's end: the step's
    tail), ``total_comm_s`` and ``step_overhead_s`` against a schedule
    that starts every window at its readiness with no serialization."""
    ready = list(ready_fracs)
    comm = list(window_comm_s)
    if len(ready) != len(comm):
        raise ValueError(
            f"{len(ready)} readiness fractions vs {len(comm)} windows")
    total = sum(comm)
    if total <= 0.0:
        return {"overlap_fraction": 0.0, "hidden_s": 0.0, "exposed_s": 0.0,
                "total_comm_s": 0.0, "step_overhead_s": 0.0}
    hidden = 0.0
    end = 0.0
    for r, c in zip(ready, comm):
        start = max(end, r * backward_s)
        end = start + c
        hidden += min(max(backward_s - start, 0.0), c)
    # ideal: every window starts at its readiness (infinite links)
    ideal_exposed = max((max(r * backward_s + c - backward_s, 0.0)
                         for r, c in zip(ready, comm)), default=0.0)
    exposed = max(end - backward_s, 0.0)
    return {"overlap_fraction": hidden / total, "hidden_s": hidden,
            "exposed_s": exposed, "total_comm_s": total,
            "step_overhead_s": exposed - ideal_exposed}


# ---------------------------------------------------------------- §4.9

@dataclass(frozen=True)
class CostInputs:
    """The paper's §4.9 prices (US$)."""
    worker_base: float = 4117.0          # W  (Supermicro worker, no GPUs)
    gpu: float = 699.0                   # G
    gpus_per_worker: int = 4
    phub_base: float = 8407.0            # H
    nic_fast: float = 795.0              # 100 GbE ConnectX-4
    nic_slow: float = 260.0              # 25 GbE ConnectX-4 Lx
    nic_phub_port: float = 162.5         # a 25 GbE port, 20 ports
    cable_fast: float = 94.0
    cable_slow: float = 31.25            # breakout, a port
    switch: float = 21077.0              # Arista 7060CX-32S
    switch_ports: int = 32


def amortized_network(n: CostInputs, nic: float, cable: float, *,
                      oversub: float, breakout: int = 1) -> float:
    """The paper's §4.9: A = (N + S + C) + F (4S + 2C); S the ToR's cost a
    port (shared ``breakout`` ways by 25 GbE hosts on a 100 GbE port), F
    the share of aggregation and core ports a worker needs (1 at full
    bisection, 1/oversub under an oversubscribed ToR)."""
    s = n.switch / n.switch_ports / breakout
    F = 1.0 / max(oversub, 1.0)
    return (nic + s + cable) + F * (4 * s + 2 * cable)


def throughput_per_dollar(throughput: float, *, phub: bool, oversub: float,
                          workers_per_phub: int = 44,
                          n: CostInputs = CostInputs()) -> float:
    """The paper's Table 5: samples/s per $1000 of a worker's capital."""
    if phub:
        A = amortized_network(n, n.nic_slow, n.cable_slow, oversub=oversub,
                              breakout=4)
        # the PHub node: base, 20 x 25 GbE ports and their network share,
        # amortized over the workers it serves (K, the worker:PHub ratio)
        P = n.phub_base + 20 * n.nic_phub_port + 20 * A
        worker_cost = (n.worker_base + n.gpus_per_worker * n.gpu + A
                       + P / workers_per_phub)
    else:
        A = amortized_network(n, n.nic_fast, n.cable_fast, oversub=1.0)
        worker_cost = n.worker_base + n.gpus_per_worker * n.gpu + A
    return throughput / (worker_cost / 1000.0)
