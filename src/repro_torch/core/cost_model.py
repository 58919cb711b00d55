"""Per-tenant byte accounting of the co-scheduled rack
(``repro/core/cost_model.py``'s multi-tenant part).

``tenant_step_traffic``: the bytes one tenant pushes and pulls a step per
worker under a strategy, raw and as encoded; ``wire_bytes_for_groups``:
encoded bytes under a wire format; ``tenant_accounting``: the per-tenant
view of a ``TenantPackedDomain`` that ``PHubConnectionManager.accounting``
reports.  The rest of the reference's cost model (the analytic step and
exchange times, the rebalance traffic) is ROADMAP.md queue A item 9.
"""
from __future__ import annotations


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
