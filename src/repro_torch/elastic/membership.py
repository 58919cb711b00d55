"""Live worker membership for an elastic PHub rack (DESIGN.md §12); a copy
of ``repro/elastic/membership.py`` (numpy only).  On one card the worker
positions are the rows of the stacked gradient buffer
(``core/comm.py::StackedComm``), and ``PHubEngine.make_train_step``
zeroes an excluded worker's row before the exchange.

Every layer below this one — the pipelined exchange, tenant co-scheduling,
the push/pull client, the wire ring — assumes a fixed, healthy worker set
for the whole run: one slow or lost VM stalls the synchronous exchange for
every tenant on the rack.  ``Membership`` makes the worker set a *dynamic*
property of a running deployment: an epoch-numbered, immutable snapshot of
which worker positions are live contributors, which are straggling, and
which have left.

Semantics (backup-worker / partial aggregation, the k-of-n commit):

  * A worker position is ``live`` when its pushes join the aggregation.
  * ``slow`` workers keep computing but the rack stops *waiting* for them
    — their pushes are excluded from the step (masked bitwise at the push
    site) and the mean renormalizes over the live contributor count.  The
    recorded latency factor is bookkeeping for schedulers and benchmarks.
  * ``dead`` workers have left (failure or scale-down); ``join`` brings a
    position back.

Transitions return a NEW membership with ``epoch + 1``.  Compiled-step
caches key on ``program_key()`` — the world size plus the contributor
mask, the membership analog of ``TrainConfig.exchange_signature`` — so a
transition re-keys the engine's train step instead of silently running a
stale mask, while a *recurring* live set (die, rejoin, die again) reuses
its first compilation; the epoch is identity/provenance (checkpoint
stamps, drift fail-fasts).  A transition that
would drop the live count below ``min_live`` (the ``k`` of k-of-n) fails
fast: the rack refuses to commit steps without quorum.

Emulation caveat: workers are rows of the stacked buffer and their
number is fixed per engine — "leaving" masks a position's gradient out of
the aggregation (exact: +0.0 contributions).  A true *resize* (fewer
workers, state migrated through the rebalance plan) is
``PHubConnectionManager.resize``, which rebuilds the engines on a new
Comm and starts a fresh membership there (``resized``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

LIVE, SLOW, DEAD = "live", "slow", "dead"
_STATUSES = (LIVE, SLOW, DEAD)


@dataclass(frozen=True)
class WorkerState:
    """One worker position's liveness/latency state."""
    status: str = LIVE
    latency: float = 1.0            # relative step latency (1.0 = nominal)

    def __post_init__(self):
        if self.status not in _STATUSES:
            raise ValueError(f"unknown worker status {self.status!r}; "
                             f"expected one of {_STATUSES}")

    @property
    def contributes(self) -> bool:
        return self.status == LIVE


@dataclass(frozen=True)
class Membership:
    """Epoch-numbered live worker set over a rack of ``world`` positions."""
    epoch: int
    workers: tuple[WorkerState, ...]
    min_live: int = 1               # the k of k-of-n: quorum floor

    # ------------------------------------------------------------ factory

    @classmethod
    def full(cls, world: int, *, min_live: int = 1,
             epoch: int = 0) -> "Membership":
        if world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        if not 1 <= min_live <= world:
            raise ValueError(f"min_live {min_live} outside [1, {world}]")
        return cls(epoch=epoch, workers=tuple(WorkerState()
                                              for _ in range(world)),
                   min_live=min_live)

    # ------------------------------------------------------------- views

    @property
    def world(self) -> int:
        return len(self.workers)

    @property
    def n_live(self) -> int:
        return sum(1 for w in self.workers if w.contributes)

    @property
    def all_live(self) -> bool:
        return all(w.contributes for w in self.workers)

    @property
    def live_ranks(self) -> tuple[int, ...]:
        return tuple(i for i, w in enumerate(self.workers) if w.contributes)

    def mask(self) -> np.ndarray:
        """(world,) float32 contributor mask: 1.0 live, 0.0 excluded.
        Applied at the *push site* (an excluded worker's row of the
        stacked gradient buffer is zeroed), which excludes masked
        gradients from every downstream reduction bitwise — an all-zero
        contribution adds exactly nothing in IEEE arithmetic."""
        return np.asarray([1.0 if w.contributes else 0.0
                           for w in self.workers], np.float32)

    def signature(self) -> tuple:
        """Full identity: epoch + world + live set (provenance — stamps
        checkpoints, names membership drift in fail-fast messages)."""
        return (self.epoch, self.world,
                tuple(w.contributes for w in self.workers))

    def program_key(self) -> tuple:
        """What a step function actually depends on: the world size and
        the contributor mask.  Step caches key on THIS, not the epoch —
        two memberships with different epochs but the same live set run
        the same step, so a worker dying, rejoining, and dying again
        reuses the first step function instead of building one per
        transition."""
        return (self.world, tuple(w.contributes for w in self.workers))

    def validate_world(self, n_workers: int):
        if self.world != n_workers:
            raise ValueError(
                f"membership covers {self.world} worker positions but the "
                f"exchange runs over {n_workers}; build the engine for "
                f"the new world size instead of reusing a membership "
                f"across world sizes")

    def require_quorum(self, k: int | None = None):
        """Fail fast when fewer than ``k`` (default ``min_live``) pushes
        can arrive — the step must not commit."""
        k = self.min_live if k is None else k
        if self.n_live < k:
            raise RuntimeError(
                f"membership epoch {self.epoch}: only {self.n_live} of "
                f"{self.world} workers live, below quorum k={k}")

    # ------------------------------------------------------- transitions

    def _check_rank(self, rank: int):
        if not 0 <= rank < self.world:
            raise ValueError(f"worker rank {rank} outside rack "
                             f"[0, {self.world})")

    def _with(self, rank: int, state: WorkerState) -> "Membership":
        workers = tuple(state if i == rank else w
                        for i, w in enumerate(self.workers))
        m = replace(self, epoch=self.epoch + 1, workers=workers)
        if m.n_live < m.min_live:
            raise RuntimeError(
                f"transition at epoch {self.epoch} would leave "
                f"{m.n_live} live workers, below quorum "
                f"min_live={m.min_live}")
        return m

    def leave(self, rank: int) -> "Membership":
        """Worker ``rank`` left the rack (failure or scale-down)."""
        self._check_rank(rank)
        if self.workers[rank].status == DEAD:
            raise ValueError(f"worker {rank} already left "
                             f"(epoch {self.epoch})")
        return self._with(rank, WorkerState(status=DEAD, latency=np.inf))

    def join(self, rank: int) -> "Membership":
        """Worker ``rank`` (re)joined: a fresh live contributor."""
        self._check_rank(rank)
        if self.workers[rank].contributes:
            raise ValueError(f"worker {rank} is already live "
                             f"(epoch {self.epoch})")
        return self._with(rank, WorkerState())

    def mark_slow(self, rank: int, factor: float) -> "Membership":
        """Worker ``rank`` straggles at ``factor``× nominal latency: stop
        waiting for its pushes (k-of-n semantics)."""
        self._check_rank(rank)
        if factor < 1.0:
            raise ValueError(f"slowdown factor must be >= 1.0, "
                             f"got {factor}")
        if self.workers[rank].status == DEAD:
            raise ValueError(f"worker {rank} left the rack; join it back "
                             f"before marking it slow")
        return self._with(rank, WorkerState(status=SLOW,
                                            latency=float(factor)))

    def mark_recovered(self, rank: int) -> "Membership":
        """A previously slow worker caught back up."""
        self._check_rank(rank)
        if self.workers[rank].status != SLOW:
            raise ValueError(f"worker {rank} is {self.workers[rank].status}"
                             f", not slow (epoch {self.epoch})")
        return self._with(rank, WorkerState())

    def demote(self, rank: int, factor: float = 8.0) -> "Membership":
        """Escalating demotion for repeat offenders (the resilience
        supervisor's containment path): a live worker is first marked
        slow — its pushes stop joining the aggregation but it may still
        recover — and a worker demoted *again* while slow leaves the rack
        outright.  Quorum is enforced by the underlying transition."""
        self._check_rank(rank)
        status = self.workers[rank].status
        if status == LIVE:
            return self.mark_slow(rank, factor)
        if status == SLOW:
            return self.leave(rank)
        raise ValueError(f"worker {rank} already left the rack "
                         f"(epoch {self.epoch}); nothing to demote")

    def resized(self, world: int) -> "Membership":
        """Fresh all-live membership over a different rack size; the epoch
        counter carries over (+1) so every step cache re-keys."""
        m = Membership.full(world, min_live=min(self.min_live, world))
        return replace(m, epoch=self.epoch + 1)
