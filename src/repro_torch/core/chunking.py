"""Fine-grained key chunking (§3.2.3), as ``repro/core/chunking.py`` does it.

Each dtype group of the parameter (or gradient) tree is raveled and
concatenated into one vector, padded to ``n_shards * chunk`` granularity,
and viewed as an ``(n_shards, shard_len)`` matrix whose row i is the
contiguous run of chunks shard i owns.  Trees are nested dicts of tensors.
Leaves are ordered by the reference's path strings (``"['blocks']['ln1']"``)
and groups are keyed by dtype name (``"float32"``), so the port's chunk
domain matches the reference's element for element.
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
