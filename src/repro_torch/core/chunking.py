"""Fine-grained key chunking (§3.2.3), as ``repro/core/chunking.py`` does it.

Each dtype group of the parameter (or gradient) tree is raveled and
concatenated into one vector, padded to ``n_shards * chunk`` granularity,
and viewed as an ``(n_shards, shard_len)`` matrix whose row i is the
contiguous run of chunks shard i owns.  Trees are nested dicts of tensors.
Leaves are ordered by the reference's path strings (``"['blocks']['ln1']"``)
and groups are keyed by dtype name (``"float32"``), so the port's chunk
domain matches the reference's element for element.

The gradient processing pipeline's planning is here too: the window
layout (``split_windows``, ``window_chunks``), the chunk-ready readiness
analysis (``window_leaves``, ``chunk_ready_schedule``), and the flat
parameter store (``FlatParamStore``, ``build_store_layout``), whose
``to_tree`` leaves are views of the store, so a model whose parameters
are those views trains on the exchange's own domain.

The co-scheduler's shared rack domain is here too (``TenantPackedDomain``,
``pack_domains``): per dtype, every attached tenant's chunks packed
shard-major, tenant-major inside a shard, so that each tenant holds one
contiguous run of every shard it meets.  Besides the reference's copying
``pack``/``unpack``, ``segments`` maps a range of a tenant's flat vector
onto packed offsets, so that a worker's gradients and a tenant's
parameters are written into the packed buffers directly.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch

from .partition import cochunk_counts


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"``: the reference's ``str(np.dtype)``."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class GroupPlan:
    dtype: torch.dtype            # dtype of this group
    paths: tuple[str, ...]        # leaf paths (sorted) in concat order
    shapes: tuple[tuple[int, ...], ...]
    sizes: tuple[int, ...]
    total: int                    # unpadded element count
    padded: int                   # total padded to n_shards * shard_len
    shard_len: int                # elements per shard (multiple of chunk_elems)
    chunk_elems: int
    n_shards: int

    @property
    def key(self) -> str:
        return dtype_name(self.dtype)

    @property
    def n_chunks(self) -> int:
        return self.padded // self.chunk_elems

    @property
    def chunks_per_shard(self) -> int:
        return self.shard_len // self.chunk_elems

    @property
    def live_elems(self) -> int:
        """The chunk-granular live extent: ``total`` rounded up to whole
        chunks.  Past it is the rack's pad, which never receives gradient;
        a resize or a restore at another world size keeps the live extent
        bitwise and re-cuts the pad."""
        return -(-self.total // self.chunk_elems) * self.chunk_elems


def chunk_spans(n_elems: int, chunk_elems: int) -> tuple:
    """Chunk-granular (start, length) spans tiling a chunk-aligned
    [0, n_elems) exactly once."""
    if n_elems % chunk_elems:
        raise ValueError(f"{n_elems} elements do not tile into "
                         f"{chunk_elems}-element chunks; the exchange only "
                         f"encodes chunk-aligned vectors")
    return tuple((k * chunk_elems, chunk_elems)
                 for k in range(n_elems // chunk_elems))


@dataclass(frozen=True)
class ChunkPlan:
    groups: tuple[GroupPlan, ...]
    chunk_bytes: int
    n_shards: int


def leaf_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict in the reference's flatten order
    (keys sorted at every level), with ``jax.tree_util.keystr`` paths."""
    out = []
    for k in sorted(tree):
        path = f"{prefix}[{k!r}]"
        v = tree[k]
        if isinstance(v, dict):
            out.extend(leaf_paths(v, path))
        else:
            out.append((path, v))
    return out


def build_plan(tree, *, chunk_bytes: int, n_shards: int) -> ChunkPlan:
    """tree: nested dict of tensors (or of anything with .shape/.dtype)."""
    by_dtype: dict[torch.dtype, list[tuple[str, tuple[int, ...]]]] = {}
    for path, leaf in leaf_paths(tree):
        by_dtype.setdefault(leaf.dtype, []).append((path, tuple(leaf.shape)))
    groups = []
    for dt in sorted(by_dtype, key=dtype_name):
        entries = sorted(by_dtype[dt])
        paths = tuple(p for p, _ in entries)
        shapes = tuple(s for _, s in entries)
        sizes = tuple(_numel(s) for s in shapes)
        total = int(sum(sizes))
        ce = max(chunk_bytes // dt.itemsize, 1)
        stride = n_shards * ce
        padded = -(-max(total, 1) // stride) * stride
        groups.append(GroupPlan(dtype=dt, paths=paths, shapes=shapes,
                                sizes=sizes, total=total, padded=padded,
                                shard_len=padded // n_shards, chunk_elems=ce,
                                n_shards=n_shards))
    return ChunkPlan(groups=tuple(groups), chunk_bytes=chunk_bytes,
                     n_shards=n_shards)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def flatten_groups(plan: ChunkPlan, tree) -> dict[str, torch.Tensor]:
    """Ravel + concat per dtype group -> {dtype_name: (padded,) vector}."""
    return flatten_leaves(plan, dict(leaf_paths(tree)))


def flatten_leaves(plan: ChunkPlan, leaves: dict[str, torch.Tensor],
                   out: Optional[dict[str, torch.Tensor]] = None
                   ) -> dict[str, torch.Tensor]:
    """``flatten_groups`` from {path: leaf}.  ``out`` ({dtype_name:
    (padded,) tensor}, e.g. one worker's row of the stacked gradient
    buffer) is written in place instead of allocating; its pad tail is
    zeroed either way."""
    res = {}
    for g in plan.groups:
        first = leaves[g.paths[0]]
        flat = (torch.empty(g.padded, dtype=g.dtype, device=first.device)
                if out is None else out[g.key])
        off = 0
        for path, size in zip(g.paths, g.sizes):
            flat[off:off + size].copy_(leaves[path].reshape(-1))
            off += size
        flat[g.total:].zero_()
        res[g.key] = flat
    return res


def group_leaves(group: GroupPlan, flat: torch.Tensor
                 ) -> dict[str, torch.Tensor]:
    """{path: view of ``flat``} for every leaf of one dtype group."""
    out, off = {}, 0
    for path, shape, size in zip(group.paths, group.shapes, group.sizes):
        out[path] = flat[off:off + size].view(shape)
        off += size
    return out


def unflatten_groups(plan: ChunkPlan, flats: dict[str, torch.Tensor], like):
    """Inverse of flatten_groups; ``like`` supplies the nested-dict
    structure.  Leaves are views into ``flats``."""
    leaves = {}
    for g in plan.groups:
        leaves.update(group_leaves(g, flats[g.key]))

    def rebuild(node, prefix):
        return {k: (rebuild(v, f"{prefix}[{k!r}]") if isinstance(v, dict)
                    else leaves[f"{prefix}[{k!r}]"])
                for k, v in node.items()}
    return rebuild(like, "")


def shard_matrix(plan_group: GroupPlan, flat: torch.Tensor) -> torch.Tensor:
    """(padded,) -> (n_shards, shard_len): row i = chunks owned by shard i."""
    return flat.view(plan_group.n_shards, plan_group.shard_len)


# ------------------------------------------------ chunk-ready planning (§14)

def split_windows(flat: torch.Tensor, group: GroupPlan, windows: int
                  ) -> tuple:
    """(padded,) flat vector -> tuple of ``windows`` per-window buffers in
    the window_flats layout: buffer w has shape (S*Lw,) with row j's strip
    [j*L + w*Lw, j*L + (w+1)*Lw) at [j*Lw, (j+1)*Lw) (a copy).  windows ==
    1 returns the flat vector itself."""
    if windows <= 1:
        return (flat,)
    S, L = group.n_shards, group.shard_len
    if L % windows:
        raise ValueError(f"{windows} windows do not tile shard_len {L}")
    m = flat.view(S, windows, L // windows)
    return tuple(m[:, w, :].reshape(-1) for w in range(windows))


def window_chunks(group: GroupPlan, windows: int) -> tuple:
    """Chunk indices of the padded domain covered by each window, in
    flat-domain order within the window: window w covers chunks ``j*cps +
    w*cpw + c`` for every shard row j.  Over w = 0..windows-1 they tile
    range(n_chunks) exactly once."""
    cps = group.chunks_per_shard
    if windows < 1 or cps % windows:
        raise ValueError(
            f"{windows} windows do not tile {cps} chunks per shard")
    cpw = cps // windows
    return tuple(
        tuple(j * cps + w * cpw + c
              for j in range(group.n_shards) for c in range(cpw))
        for w in range(windows))


def leaf_offsets(group: GroupPlan) -> tuple[int, ...]:
    """Each leaf's offset in the group's flat vector (concat order)."""
    offs, off = [], 0
    for size in group.sizes:
        offs.append(off)
        off += size
    return tuple(offs)


def window_leaves(group: GroupPlan, windows: int) -> tuple:
    """For each window, the indices (into ``group.paths``) of the leaves
    that meet one of its strips ``[j*L + w*Lw, j*L + (w+1)*Lw)``: the
    leaves whose gradients the window's update waits for.  A window that
    covers only padding waits for none."""
    S, L = group.n_shards, group.shard_len
    if windows < 1 or L % windows:
        raise ValueError(f"{windows} windows do not tile shard_len {L}")
    Lw = L // windows
    spans = tuple(zip(leaf_offsets(group), group.sizes))
    return tuple(
        tuple(i for i, (o, sz) in enumerate(spans)
              if any(o < j * L + w * Lw + Lw and o + sz > j * L + w * Lw
                     for j in range(S)))
        for w in range(windows))


def chunk_ready_schedule(group: GroupPlan, windows: int) -> tuple:
    """Static readiness analysis for the chunk-ready dispatch (the
    reference's): the backward materializes leaf gradients in reverse
    concat order, so the leaf at flat offset ``off`` closes after fraction
    ``(M - off) / M`` of it (M = live elements).  Window w is ready at the
    fraction of its earliest-offset leaf (0.0 for a window of padding
    only).  Returns ``(order, ready)``: the windows sorted by ascending
    readiness, ties in ascending index, and each window's fraction."""
    offs = leaf_offsets(group)
    M = max(group.total, 1)
    ready = tuple(
        0.0 if not ix else (M - min(offs[i] for i in ix)) / M
        for ix in window_leaves(group, windows))
    order = tuple(sorted(range(windows), key=lambda w: (ready[w], w)))
    return order, ready


# ------------------------------------------------------- flat param residency

@dataclass(frozen=True)
class FlatParamStore:
    """Static offset table of persistent flat chunk-domain residency
    (DESIGN.md §8).  The store itself is ``{dtype_name: (mo, padded)
    tensor}`` whose row is the concat-order flattening of the leaves, the
    vector ``flatten_groups`` builds.  The port has no model axis, so one
    row (``mo == 1``).

    ``to_tree`` gives the leaves as views of the store (no copy): a model
    whose parameters are these views trains on the store itself, and the
    exchange's p' becomes the next store.  The reference needs a custom
    VJP (its ``reader``) because XLA does not fuse the transpose of the
    per-leaf slicing; in PyTorch each leaf's gradient is its own tensor,
    and ``grad_from_tree`` writes each element of it once into a flat row
    (the engine's per-worker write into its stacked buffer), so a reader
    would remove no pass over the gradient."""
    plan: ChunkPlan
    mo: int
    offsets: dict                 # group key -> (int, ...) per path

    def store_shapes(self) -> dict:
        return {g.key: (self.mo, g.padded) for g in self.plan.groups}

    def from_tree(self, tree) -> dict:
        """Parameter tree -> {dtype_name: (1, padded)} store (a copy; the
        pad is zero)."""
        return {k: v.view(1, -1)
                for k, v in flatten_groups(self.plan, tree).items()}

    def to_tree(self, store: dict, like) -> dict:
        """Store -> parameter tree of views of the store; ``like`` gives
        the nesting."""
        return unflatten_groups(self.plan,
                                {k: v[0] for k, v in store.items()}, like)

    def grad_from_tree(self, ct_tree, out: Optional[dict] = None) -> dict:
        """The flat gradient {dtype_name: (1, padded)} from per-leaf
        gradients, each element written once (the pad zeroed); ``out``
        ({dtype_name: (padded,) row}, e.g. one worker's row of the stacked
        buffer) is written in place instead of allocating."""
        flats = flatten_leaves(self.plan, dict(leaf_paths(ct_tree)), out)
        return {k: v.view(1, -1) for k, v in flats.items()}

    def window_flats(self, ct_tree, windows: dict) -> dict:
        """Per-window flat gradients, the reference's chunk-ready
        assembly: per dtype group, ``windows[key]`` buffers, buffer w of
        shape (S*Lw,) holding the strips ``[j*L + w*Lw, j*L + (w+1)*Lw)``
        at ``[j*Lw, (j+1)*Lw)``, built by copying exactly the leaf pieces
        that meet them; padding stays zero.  The engine reads the same
        strips in place in its stacked buffer instead (rows ``padded``
        apart), since a window's readiness is an event there, not
        dataflow."""
        cts = dict(leaf_paths(ct_tree))
        out = {}
        for g in self.plan.groups:
            W = windows[g.key]
            S, L = g.n_shards, g.shard_len
            if W < 1 or L % W:
                raise ValueError(
                    f"group {g.key}: {W} windows do not tile shard_len {L}")
            Lw = L // W
            bufs = []
            for w in range(W):
                first = cts[g.paths[0]]
                buf = torch.zeros(S * Lw, dtype=g.dtype, device=first.device)
                for path, size, off in zip(g.paths, g.sizes,
                                           self.offsets[g.key]):
                    for j in range(S):
                        lo = j * L + w * Lw
                        a, b = max(off, lo), min(off + size, lo + Lw)
                        if a < b:
                            buf[j * Lw + a - lo:j * Lw + b - lo].copy_(
                                cts[path].reshape(-1)[a - off:b - off])
                bufs.append(buf)
            out[g.key] = tuple(bufs)
        return out


def build_store_layout(plan: ChunkPlan, model_dims: dict,
                       mo: int) -> FlatParamStore:
    """The store's offset table.  ``model_dims`` (leaf path -> the dim
    sharded over a model axis) and ``mo`` (model ranks) are the
    reference's; the port has no model axis, so a sharded leaf or
    ``mo > 1`` raises."""
    if max(mo, 1) > 1 or any(d is not None for d in model_dims.values()):
        raise NotImplementedError(
            "a flat store with model-sharded rows (mo > 1) needs the "
            "model axis, which the port does not have yet (ROADMAP.md "
            "queue A item 5b)")
    return FlatParamStore(plan=plan, mo=1, offsets={
        g.key: leaf_offsets(g) for g in plan.groups})


# ------------------------------------------------------ multi-tenant packing

@dataclass(frozen=True)
class TenantSlot:
    """One tenant's residency inside a packed dtype group."""
    tenant: str
    total: int                    # unpadded element count
    padded: int                   # chunk-granularity padding: n_chunks * ce
    runs: tuple[tuple[int, int, int], ...]   # (tenant_off, packed_off, len)


@dataclass(frozen=True)
class PackedGroup:
    """One dtype group of the shared rack chunk domain: every tenant's
    chunks packed shard-major (counts from ``partition.cochunk_counts``).
    It has the fields of a ``GroupPlan`` that the exchange reads (``key``,
    ``dtype``, ``padded``, ``shard_len``, ``chunk_elems``, ``n_shards``,
    ``chunks_per_shard``, ``n_chunks``), so the exchange takes it where it
    takes a plan's group."""
    dtype: torch.dtype
    chunk_elems: int
    n_shards: int
    shard_len: int                # elements per shard (multiple of ce)
    padded: int                   # n_shards * shard_len
    slots: tuple[TenantSlot, ...]
    # packed-order segments: (tenant|None, tenant_off, length); None = pad
    layout: tuple[tuple[Any, int, int], ...]

    @property
    def key(self) -> str:
        return dtype_name(self.dtype)

    @property
    def chunks_per_shard(self) -> int:
        return self.shard_len // self.chunk_elems

    @property
    def n_chunks(self) -> int:
        return self.padded // self.chunk_elems

    def slot(self, tenant: str) -> TenantSlot:
        for s in self.slots:
            if s.tenant == tenant:
                return s
        raise KeyError(tenant)

    def pad_runs(self) -> tuple[tuple[int, int], ...]:
        """(packed_off, length) of every pad segment (no tenant's)."""
        out, off = [], 0
        for tenant, _, length in self.layout:
            if tenant is None:
                out.append((off, length))
            off += length
        return tuple(out)


@dataclass(frozen=True)
class TenantPackedDomain:
    """Shared rack-scale chunk domain of co-scheduled tenants (§3.1
    multi-tenancy): per dtype, every tenant's chunk-padded flat vector is
    split into per-shard quota runs and packed shard-major, so one
    exchange carries every job's gradients at once.  The offset tables
    (``TenantSlot.runs``) are the namespace isolation: each tenant's
    update touches exactly its own ranges."""
    groups: dict                  # dtype_name -> PackedGroup
    tenants: tuple[str, ...]
    n_shards: int
    chunk_bytes: int

    def pack(self, key: str, flats: dict) -> torch.Tensor:
        """Per-tenant chunk-padded flats -> one (padded,) packed vector (a
        copy; the pad zero)."""
        g = self.groups[key]
        first = next(iter(flats.values()))
        out = torch.zeros(g.padded, dtype=g.dtype, device=first.device)
        off = 0
        for tenant, toff, length in g.layout:
            if tenant is not None:
                out[off:off + length].copy_(flats[tenant][toff:toff + length])
            off += length
        return out

    def unpack(self, key: str, packed: torch.Tensor,
               tenant: str) -> torch.Tensor:
        """Packed vector -> the tenant's (slot.padded,) chunk-padded flat
        (a copy)."""
        g = self.groups[key]
        runs = sorted(g.slot(tenant).runs)        # ascending tenant_off
        return torch.cat([packed[poff:poff + length]
                          for _, poff, length in runs])

    def segments(self, key: str, tenant: str, lo: int, hi: int
                 ) -> list[tuple[int, int, int]]:
        """The tenant's flat range [lo, hi) as (tenant_off, packed_off,
        length) pieces of its runs, in tenant order."""
        out = []
        for toff, poff, length in sorted(self.groups[key].slot(tenant).runs):
            a, b = max(lo, toff), min(hi, toff + length)
            if a < b:
                out.append((a, poff + a - toff, b - a))
        return out

    def leaf_pieces(self, key: str, tenant: str, group: GroupPlan
                    ) -> tuple:
        """For the tenant's own dtype group plan ``group``: (path,
        leaf_off, packed_off, length) of every piece of every leaf, so a
        leaf's flat gradient or parameter is written into the packed
        buffer directly; and the packed (off, length) pieces of the
        tenant's chunk tail [total, slot.padded), which stay zero."""
        pieces, off = [], 0
        for path, size in zip(group.paths, group.sizes):
            for toff, poff, length in self.segments(key, tenant, off,
                                                    off + size):
                pieces.append((path, toff - off, poff, length))
            off += size
        slot = self.groups[key].slot(tenant)
        tail = tuple((poff, length) for _, poff, length in
                     self.segments(key, tenant, slot.total, slot.padded))
        return tuple(pieces), tail

    def coef_vector(self, key: str, values: dict, fill: float = 0.0
                    ) -> torch.Tensor:
        """(padded,) per-position coefficient table in the group dtype, on
        the CPU: position i carries its owner tenant's value (pad chunks
        ``fill``): the reference's way to apply each tenant's rule to its
        own chunk ranges inside one shared update."""
        g = self.groups[key]
        out = torch.full((g.padded,), fill, dtype=g.dtype)
        off = 0
        for tenant, _, length in g.layout:
            if tenant is not None:
                out[off:off + length] = values[tenant]
            off += length
        return out

    def tenant_bytes(self, tenant: str) -> int:
        """Unpadded model bytes this tenant exchanges per step."""
        return sum(g.slot(tenant).total * g.dtype.itemsize
                   for g in self.groups.values()
                   if any(s.tenant == tenant for s in g.slots))

    def shard_loads(self, key: str) -> dict:
        """Per-tenant chunks per shard (balance introspection)."""
        g = self.groups[key]
        loads = {s.tenant: [0] * g.n_shards for s in g.slots}
        for s in g.slots:
            for _, poff, length in s.runs:
                loads[s.tenant][poff // g.shard_len] += \
                    length // g.chunk_elems
        return loads


def pack_domains(tenant_plans: dict, *, n_shards: int,
                 chunk_bytes: int) -> TenantPackedDomain:
    """Pack per-tenant ChunkPlans into one TenantPackedDomain.

    Tenants are padded only to chunk granularity here: the rack-level
    padding to ``n_shards`` granularity is shared across jobs, and the LPT
    quota (``partition.cochunk_counts``) decides which shard serves which
    slice of which tenant."""
    tenants = tuple(tenant_plans)
    by_dtype: dict[str, list[tuple[str, GroupPlan]]] = {}
    for t in tenants:
        for g in tenant_plans[t].groups:
            if g.chunk_elems != max(chunk_bytes // g.dtype.itemsize, 1):
                raise ValueError(
                    f"tenant {t!r} group {g.key} was chunked at a different "
                    f"chunk size; co-scheduled tenants must share "
                    f"chunk_size_bytes")
            by_dtype.setdefault(g.key, []).append((t, g))
    groups = {}
    for key, members in by_dtype.items():
        ce = members[0][1].chunk_elems
        n_chunks = [-(-m.total // ce) for _, m in members]
        counts, pad = cochunk_counts(n_chunks, n_shards)
        cps = (sum(n_chunks) + sum(pad)) // n_shards
        shard_len = cps * ce
        layout: list[tuple[Any, int, int]] = []
        slot_runs: dict[str, list[tuple[int, int, int]]] = {
            t: [] for t, _ in members}
        cursors = {t: 0 for t, _ in members}
        off = 0
        for s in range(n_shards):
            for ti, (t, _) in enumerate(members):
                q = counts[ti][s]
                if not q:
                    continue
                length = q * ce
                layout.append((t, cursors[t], length))
                slot_runs[t].append((cursors[t], off, length))
                cursors[t] += length
                off += length
            if pad[s]:
                layout.append((None, 0, pad[s] * ce))
                off += pad[s] * ce
        slots = tuple(
            TenantSlot(tenant=t, total=m.total, padded=n_chunks[ti] * ce,
                       runs=tuple(slot_runs[t]))
            for ti, (t, m) in enumerate(members))
        groups[key] = PackedGroup(
            dtype=members[0][1].dtype, chunk_elems=ce, n_shards=n_shards,
            shard_len=shard_len, padded=n_shards * shard_len, slots=slots,
            layout=tuple(layout))
    return TenantPackedDomain(groups=groups, tenants=tenants,
                              n_shards=n_shards, chunk_bytes=chunk_bytes)
