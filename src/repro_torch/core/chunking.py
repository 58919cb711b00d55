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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import torch


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
