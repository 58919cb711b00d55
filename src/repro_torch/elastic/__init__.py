"""Elastic rack (DESIGN.md §12): live worker membership, the k-of-n push
mask, seeded failure injection and the minimal-movement rebalance of the
chunk domain across a world resize (``rebalance``)."""
from .membership import DEAD, LIVE, SLOW, Membership, WorkerState
from .rebalance import (GroupRebalance, RebalancePlan, SOLO_TENANT,
                        domain_placements, migrate_engine_state,
                        plan_placements, plan_rebalance, solo_resize_plan)
from .chaos import (CKPT_CORRUPT, ChaosEvent, ChaosSchedule, FAULT_KINDS,
                    FaultEvent, FaultSchedule, GRAD_BLOWUP, NAN_PUSH, STALL,
                    corrupt_checkpoint)
