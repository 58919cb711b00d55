"""Elastic rack (DESIGN.md §12): live worker membership, the k-of-n push
mask and seeded failure injection.  Rebalancing on a world resize is
ROADMAP.md queue A item 13."""
from .membership import DEAD, LIVE, SLOW, Membership, WorkerState
from .chaos import (CKPT_CORRUPT, ChaosEvent, ChaosSchedule, FAULT_KINDS,
                    FaultEvent, FaultSchedule, GRAD_BLOWUP, NAN_PUSH, STALL,
                    corrupt_checkpoint)
