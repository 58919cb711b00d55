"""Worker substrate: where the reference has mesh axes, the port has a Comm.

The reference runs one worker per device and names them by mesh axes
(``repro/launch/mesh.py``, ``ExchangeContext`` in
``repro/core/exchange.py``).  NCCL puts no two ranks on one GPU, so on one
card the port stacks the workers instead: ``StackedComm`` holds W workers
as dim 0 of one tensor, and a reduce-scatter is a sum over that dim.  The
``torch.distributed`` backend (gloo on the CPU, NCCL across cards) is the
open part of ROADMAP.md queue A item 4.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StackedComm:
    """W workers on one device, stacked along dim 0."""
    n_workers: int

    def __post_init__(self):
        if self.n_workers < 1:
            raise ValueError(f"n_workers must be >= 1, got {self.n_workers}")

    def n_shards(self, strategy: str) -> int:
        """Rows of the chunk shard-matrix for this strategy (the
        reference's ``ExchangeContext.n_shards`` on a flat data axis)."""
        if strategy == "sharded_ps":
            return self.n_workers
        if strategy in ("allreduce", "centralized_ps"):
            return 1
        raise NotImplementedError(
            f"strategy {strategy!r} has no stacked-worker layout yet "
            f"(ROADMAP.md queue A item 5)")

    def state_len(self, strategy: str, padded: int) -> int:
        """Optimizer-state length per shard."""
        return padded // self.n_shards(strategy)
