"""Balanced chunk -> shard assignment (§3.2.4), as
``repro/core/partition.py`` does it.

PHub balances chunk load across cores, queue pairs and interfaces with a
4/3-approximation set partition.  LPT (Longest Processing Time greedy) is
that algorithm: sort the items by cost, descending, and put each in the
currently lightest bin; Graham's bound keeps the makespan within 4/3 -
1/(3m) of the optimum.

On the flat chunk domain every shard's bytes balance by construction, so
LPT serves where items stay discrete: the co-scheduler's cross-tenant
chunk quotas (``cochunk_counts``, the packed rack domain of
``core/chunking.py::pack_domains``) and the accounting of a re-quota
(``quota_movement``).  Plain Python, no tensors.
"""
from __future__ import annotations

import heapq
from typing import Sequence


def lpt_partition(costs: Sequence[int], n_bins: int) -> list[int]:
    """The bin of each item.  Greedy LPT: a 4/3-approximation of the
    optimal makespan; ties go to the lowest bin id."""
    order = sorted(range(len(costs)), key=lambda i: -costs[i])
    heap = [(0, b) for b in range(n_bins)]
    heapq.heapify(heap)
    assign = [0] * len(costs)
    for i in order:
        load, b = heapq.heappop(heap)
        assign[i] = b
        heapq.heappush(heap, (load + costs[i], b))
    return assign


def bin_loads(costs: Sequence[int], assign: Sequence[int],
              n_bins: int) -> list[int]:
    """Each bin's summed cost."""
    loads = [0] * n_bins
    for c, b in zip(costs, assign):
        loads[b] += c
    return loads


def makespan_ratio(costs: Sequence[int], assign: Sequence[int],
                   n_bins: int) -> float:
    """max bin load / perfect-balance load (1.0 = perfectly balanced)."""
    loads = bin_loads(costs, assign, n_bins)
    ideal = max(sum(costs) / n_bins, 1e-12)
    return max(loads) / ideal


def quota_movement(counts_a: Sequence[Sequence[int]],
                   counts_b: Sequence[Sequence[int]]) -> int:
    """Shard-level lower bound on the chunks a re-quota must move: for each
    tenant, the chunks that leave shards whose quota shrank (``sum_s max(0,
    a[t][s] - b[t][s])``).  The shard counts may differ (a rack resize):
    the shorter quota row is zero-extended."""
    moved = 0
    for row_a, row_b in zip(counts_a, counts_b):
        n = max(len(row_a), len(row_b))
        a = list(row_a) + [0] * (n - len(row_a))
        b = list(row_b) + [0] * (n - len(row_b))
        moved += sum(max(0, x - y) for x, y in zip(a, b))
    return moved


def cochunk_counts(chunks_per_tenant: Sequence[int], n_shards: int
                   ) -> tuple[list[list[int]], list[int]]:
    """Cross-tenant chunk -> shard quotas for the packed rack domain.

    Every tenant's chunks are unit-cost items fed tenant-major through LPT,
    plus pad pseudo-chunks rounding the total up to ``n_shards``
    granularity.  Unit costs make LPT level the bins exactly (every shard
    owns ``total / n_shards`` chunks) while the tenant-major order cycles
    each tenant's chunks across the bins, so no tenant's chunks pile onto
    one shard: §3.2.4's balance lifted from keys within a job to jobs
    within a rack.

    Returns ``(counts, pad)``: ``counts[t][s]`` is tenant t's chunk quota
    on shard s and ``pad[s]`` the pad chunks closing shard s."""
    total = sum(chunks_per_tenant)
    n_pad = (-total) % n_shards
    assign = lpt_partition([1] * (total + n_pad), n_shards)
    counts = []
    i = 0
    for c in chunks_per_tenant:
        row = [0] * n_shards
        for _ in range(c):
            row[assign[i]] += 1
            i += 1
        counts.append(row)
    pad = [0] * n_shards
    for _ in range(n_pad):
        pad[assign[i]] += 1
        i += 1
    return counts, pad
