"""Chunk-domain rebalancing: minimal-movement delta plans between two
partitions of the rack's chunk domain (``repro/elastic/rebalance.py``,
DESIGN.md §12).

A rack resize (8 -> 6 workers) changes ``n_shards`` of every chunk domain:
the shared ``TenantPackedDomain`` re-packs with other LPT quotas and a
solo engine's ``ChunkPlan`` re-pads to the new shard granularity.  The
optimizer slots (momentum, Adam's four, the encoded wire's ``wire_ef``
residual) live in that domain, so a resize moves every slot buffer from
the old placement to the new one.

``plan_rebalance(old, new)`` is the delta plan between two partitions of
the same tenant chunk set:

  * every tenant chunk is in exactly one run: a chunk moves at most once;
  * the runs with ``src != dst`` cover exactly the symmetric difference of
    the two placements: a chunk whose packed position is unchanged costs
    no movement (and no traffic in ``cost_model.rebalance_traffic``);
  * plans compose: ``plan(a->b)`` then ``plan(b->c)`` lands every chunk on
    its ``plan(a->c)`` placement.

Coordinates are packed element offsets (chunk-granular); the plan is host
arithmetic on Python ints, as the reference computes it.  Rack padding
belongs to no tenant and is never moved: the new buffer's pad starts at
zero.  Every slot (Adam's k1/k2 too, whose tick is gated to positions that
have seen gradient, ``optim/protocol.py``) holds exactly 0 on the dead
tail, so a zero pad is state-exact: a resize round trip equals a run that
never resized, pad included.

``RebalancePlan.apply`` moves one ``(R, old_padded)`` tensor on its own
device, one slice copy a run; ``migrate_engine_state`` moves a solo
service's model and optimizer state across a resize, one slot at a time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

SOLO_TENANT = "__solo__"


@dataclass(frozen=True)
class GroupRebalance:
    """One dtype group's delta plan.  ``moves[tenant]`` is a tuple of
    ``(toff, src, dst, length)`` runs (tenant offset, old packed offset,
    new packed offset, element length), chunk-granular, toff-ascending,
    tiling the tenant's chunk extent exactly once."""
    dtype: Any
    chunk_elems: int
    old_padded: int
    new_padded: int
    moves: dict

    def delta(self, tenant: str) -> tuple:
        """The runs that move (``src != dst``)."""
        return tuple(r for r in self.moves[tenant] if r[1] != r[2])

    def moved_elems(self) -> int:
        return sum(r[3] for t in self.moves for r in self.delta(t))

    def total_elems(self) -> int:
        return sum(r[3] for t in self.moves for r in self.moves[t])


@dataclass(frozen=True)
class RebalancePlan:
    """Delta plans for every dtype group of a domain resize."""
    groups: dict                     # dtype_name -> GroupRebalance

    def apply(self, key: str, rows: torch.Tensor) -> torch.Tensor:
        """One ``(R, old_padded)`` buffer of group ``key`` in the new
        placement: a new ``(R, new_padded)`` tensor on the same device and
        of the same dtype, each run one slice copy, the rest zero."""
        g = self.groups[key]
        if rows.ndim != 2 or rows.shape[1] != g.old_padded:
            raise ValueError(
                f"group {key!r}: expected (R, {g.old_padded}) rows, got "
                f"{tuple(rows.shape)}")
        out = rows.new_zeros((rows.shape[0], g.new_padded))
        for tenant in g.moves:
            for _, src, dst, ln in g.moves[tenant]:
                out[:, dst:dst + ln].copy_(rows[:, src:src + ln])
        return out

    def chunk_placements(self, key: str) -> dict:
        """{tenant: [(src_chunk, dst_chunk), ...]} a tenant chunk each, in
        tenant-chunk order: the expansion the property tests and
        ``compose`` work over."""
        g = self.groups[key]
        ce = g.chunk_elems
        out = {}
        for tenant, runs in g.moves.items():
            pairs = []
            for toff, src, dst, ln in runs:
                for k in range(ln // ce):
                    pairs.append(((src + k * ce) // ce, (dst + k * ce) // ce))
            out[tenant] = pairs
        return out

    def compose(self, other: "RebalancePlan") -> "RebalancePlan":
        """``self`` (a->b) then ``other`` (b->c): the a->c plan.  Raises
        when the intermediate placements disagree (``self``'s destinations
        must be ``other``'s sources chunk for chunk)."""
        groups = {}
        if set(self.groups) != set(other.groups):
            raise ValueError(
                f"plans cover different dtype groups: "
                f"{sorted(self.groups)} vs {sorted(other.groups)}")
        for key, ga in self.groups.items():
            gb = other.groups[key]
            if ga.new_padded != gb.old_padded:
                raise ValueError(
                    f"group {key!r}: intermediate domain sizes disagree "
                    f"({ga.new_padded} vs {gb.old_padded})")
            if set(ga.moves) != set(gb.moves):
                raise ValueError(
                    f"group {key!r}: plans cover different tenants")
            ce = ga.chunk_elems
            moves = {}
            pa = self.chunk_placements(key)
            pb = other.chunk_placements(key)
            for tenant in ga.moves:
                via = dict(pb[tenant])           # b_chunk -> c_chunk
                runs = []
                toff = 0
                for src_a, dst_b in pa[tenant]:
                    if dst_b not in via:
                        raise ValueError(
                            f"group {key!r} tenant {tenant!r}: chunk at "
                            f"b-offset {dst_b * ce} has no onward "
                            f"placement in the second plan")
                    run = (toff, src_a * ce, via[dst_b] * ce, ce)
                    if (runs and runs[-1][0] + runs[-1][3] == run[0]
                            and runs[-1][1] + runs[-1][3] == run[1]
                            and runs[-1][2] + runs[-1][3] == run[2]):
                        prev = runs.pop()
                        run = (prev[0], prev[1], prev[2], prev[3] + ce)
                    runs.append(run)
                    toff += ce
                moves[tenant] = tuple(runs)
            groups[key] = GroupRebalance(
                dtype=ga.dtype, chunk_elems=ce, old_padded=ga.old_padded,
                new_padded=gb.new_padded, moves=moves)
        return RebalancePlan(groups=groups)

    def moved_elems(self) -> dict:
        return {key: g.moved_elems() for key, g in self.groups.items()}


# -------------------------------------------------------------- placements

def domain_placements(domain) -> dict:
    """TenantPackedDomain -> {key: (dtype, ce, padded, {tenant: ((toff,
    poff, len), ...)})}: each tenant's chunk-granular residency,
    toff-ascending."""
    out = {}
    for key, g in domain.groups.items():
        runs = {s.tenant: tuple(sorted(s.runs)) for s in g.slots}
        out[key] = (g.dtype, g.chunk_elems, g.padded, runs)
    return out


def plan_placements(chunk_plan) -> dict:
    """ChunkPlan -> single-tenant placements: a solo engine's domain is
    identity-placed (element positions never depend on the shard count,
    only the pad tail does), so its runs are one identity span over the
    chunk-ceiled live extent."""
    out = {}
    for g in chunk_plan.groups:
        out[g.key] = (g.dtype, g.chunk_elems, g.padded,
                      {SOLO_TENANT: ((0, 0, g.live_elems),)})
    return out


def _placements_of(obj) -> dict:
    if hasattr(obj, "tenants"):                 # TenantPackedDomain
        return domain_placements(obj)
    return plan_placements(obj)                 # ChunkPlan


def _merge_segments(runs_old, runs_new):
    """Intersect two run lists tiling the same tenant-offset extent into
    maximal (toff, src, dst, len) segments, joining segments whose
    displacement continues contiguously."""
    out: list[tuple[int, int, int, int]] = []
    io = ino = 0
    while io < len(runs_old) and ino < len(runs_new):
        to, po, lo = runs_old[io]
        tn, pn, ln = runs_new[ino]
        start = max(to, tn)
        end = min(to + lo, tn + ln)
        if end > start:
            seg = (start, po + (start - to), pn + (start - tn), end - start)
            if (out and out[-1][0] + out[-1][3] == seg[0]
                    and out[-1][1] + out[-1][3] == seg[1]
                    and out[-1][2] + out[-1][3] == seg[2]):
                prev = out.pop()
                seg = (prev[0], prev[1], prev[2], prev[3] + seg[3])
            out.append(seg)
        if to + lo <= tn + ln:
            io += 1
        if tn + ln <= to + lo:
            ino += 1
    return tuple(out)


def plan_rebalance(old, new) -> RebalancePlan:
    """Delta plan between two partitions of the same tenant chunk set.

    ``old`` / ``new``: TenantPackedDomain or ChunkPlan (a solo engine's
    domain is the single-tenant identity placement).  Raises when the two
    disagree on dtype groups, tenants, chunk size or any tenant's chunk
    extent: those are different models, not two placements of one."""
    po, pn = _placements_of(old), _placements_of(new)
    if set(po) != set(pn):
        raise ValueError(f"partitions cover different dtype groups: "
                         f"{sorted(po)} vs {sorted(pn)}")
    groups = {}
    for key in po:
        dt_o, ce_o, pad_o, runs_o = po[key]
        dt_n, ce_n, pad_n, runs_n = pn[key]
        if ce_o != ce_n:
            raise ValueError(f"group {key!r}: chunk_elems {ce_o} != {ce_n};"
                             f" partitions must share chunk_size_bytes")
        if set(runs_o) != set(runs_n):
            raise ValueError(f"group {key!r}: tenant sets differ "
                             f"({sorted(runs_o)} vs {sorted(runs_n)})")
        moves = {}
        for tenant in runs_o:
            ext_o = sum(r[2] for r in runs_o[tenant])
            ext_n = sum(r[2] for r in runs_n[tenant])
            if ext_o != ext_n:
                raise ValueError(
                    f"group {key!r} tenant {tenant!r}: chunk extents "
                    f"differ ({ext_o} vs {ext_n} elems) — not two "
                    f"placements of one model")
            moves[tenant] = _merge_segments(runs_o[tenant], runs_n[tenant])
        groups[key] = GroupRebalance(dtype=dt_o, chunk_elems=ce_o,
                                     old_padded=pad_o, new_padded=pad_n,
                                     moves=moves)
    return RebalancePlan(groups=groups)


def solo_resize_plan(dtype, chunk_elems: int, live: int, old_padded: int,
                     new_padded: int) -> RebalancePlan:
    """The identity-placement resize plan of one solo dtype group (the
    checkpoint restore at another world size, where only the buffer shapes
    survive): live chunks stay in place, the pad tail is re-cut for the
    new shard count.  The group is keyed by its dtype's name
    (``"float32"``), as the engine keys its groups."""
    if live <= 0 or live % chunk_elems or live > min(old_padded, new_padded):
        raise ValueError(
            f"live extent {live} incompatible with chunk_elems "
            f"{chunk_elems} and padded sizes {old_padded}/{new_padded}")
    g = GroupRebalance(dtype=dtype, chunk_elems=chunk_elems,
                       old_padded=old_padded, new_padded=new_padded,
                       moves={SOLO_TENANT: ((0, 0, 0, live),)})
    return RebalancePlan(groups={str(dtype).removeprefix("torch."): g})


# ---------------------------------------------------------- state migration

def _slot_rows(eng, group, spec) -> int:
    """Rows of one element a slot keeps (1, or the DCN tier residual's one
    a pod): the shape a slot has beside its shard axis."""
    r, n = eng.slot_shape(group, spec)
    return r * n // group.padded


def check_resizable(old_eng, new_eng) -> None:
    """Raise ValueError unless ``new_eng`` is ``old_eng`` at another rack
    size: the same exchange signature, and every slot keeping as many rows
    an element (the reference's model-parallel degree)."""
    if old_eng.tc.exchange_signature() != new_eng.tc.exchange_signature():
        raise ValueError(
            f"resize changed the exchange signature "
            f"({old_eng.tc.exchange_signature()} -> "
            f"{new_eng.tc.exchange_signature()}); a resize migrates state "
            f"across rack sizes, not across exchange configurations")
    if old_eng.chunk_plan is None:
        return                  # fsdp_stream: the leaves are the state
    old_groups = {g.key: g for g in old_eng.chunk_plan.groups}
    for g in new_eng.chunk_plan.groups:
        for spec in new_eng.exchange_slots:
            a = _slot_rows(old_eng, old_groups[g.key], spec)
            b = _slot_rows(new_eng, g, spec)
            if a != b:
                raise ValueError(
                    f"resize changed the rows slot {g.key}/{spec.name} "
                    f"keeps an element ({a} -> {b}); only the worker "
                    f"extent of the rack is elastic (the port has no "
                    f"model-parallel axis, and the DCN tier's residual "
                    f"keeps one row a pod)")


def migrate_engine_state(old_eng, new_eng, model, opt: dict):
    """Move one solo service's caller-held (model, opt) from ``old_eng``'s
    rack size to ``new_eng``'s through the rebalance plan (once a resize,
    on the device the state lives on).

    Every declared exchange slot (the rule's, then ``wire_ef``) keeps its
    chunk-granular live region bitwise; the old pad tail is dropped and
    the new one starts at zero.  The slots are moved one at a time and
    ``opt``'s entries replaced as they go, so an old slot is freed (when
    the caller holds no other reference to it) before the next new one is
    allocated: the peak is the state plus one slot, not twice the state.
    Under flat residency the store moves too and the model's parameters
    are re-pointed at the new one; otherwise the parameter tree stays
    where it is.  An fsdp_stream service's state is its leaves, the same
    at every rack size: it comes back as it is.  Returns (model, opt)."""
    check_resizable(old_eng, new_eng)
    if old_eng.chunk_plan is None:
        # fsdp_stream: the parameters and {slot: tree} are whole leaves on
        # the card at any rack size (the reference re-lays the same
        # leaves out over its new mesh), so nothing moves
        return model, opt
    plan = plan_rebalance(old_eng.chunk_plan, new_eng.chunk_plan)
    if old_eng.tc.flat_residency:
        store = model.flat_store
        if store is None:
            raise ValueError("flat_residency: the model's parameters are "
                             "not views of a flat store")
        with torch.no_grad():
            new_store = {k: plan.apply(k, v) for k, v in store.items()}
        del store
        new_eng._adopt_store(model, new_store)
    with torch.no_grad():
        for g in new_eng.chunk_plan.groups:
            slots = opt[g.key]
            for spec in new_eng.exchange_slots:
                old = slots[spec.name]
                rows = old.view(-1, plan.groups[g.key].old_padded)
                del old
                slots[spec.name] = plan.apply(g.key, rows).view(
                    new_eng.slot_shape(g, spec))
                del rows
    return model, opt
