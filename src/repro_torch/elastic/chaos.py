"""Deterministic failure injection for elastic racks (DESIGN.md §12); a
copy of ``repro/elastic/chaos.py`` (numpy RNG, so the same seed gives the
reference's schedules event for event).

Tests and benchmarks need *reproducible* churn: the same seed must produce
the same kill/slow/rejoin schedule on every run.  A
``ChaosSchedule`` is a seeded, precomputed event list over a fixed number
of steps:

    sched = ChaosSchedule.seeded(seed=7, world=8, steps=40)
    for step in range(40):
        membership = sched.apply(membership, step)   # may bump the epoch
        ...train step under `membership`...

Events never violate quorum: the generator tracks the live set and only
emits kills/slowdowns while more than ``min_live`` contributors remain,
and every kill is eventually matched by a rejoin candidate so long runs
don't drain the rack.  Slowdown factors are drawn from ``slow_factors``
— they matter to the *benchmark* emulation (a straggler's latency factor
is how the resilience benchmark models the push the barrier would have
waited for), not to the masked arithmetic.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .membership import DEAD, SLOW, Membership

KILL, SLOW_EV, REJOIN, RECOVER = "kill", "slow", "rejoin", "recover"


@dataclass(frozen=True)
class ChaosEvent:
    step: int
    kind: str                       # kill | slow | rejoin | recover
    worker: int
    factor: float = 1.0             # slowdown factor (kind == "slow")


@dataclass(frozen=True)
class ChaosSchedule:
    events: tuple[ChaosEvent, ...]
    world: int

    @classmethod
    def seeded(cls, *, seed: int, world: int, steps: int,
               event_every: int = 5, min_live: int | None = None,
               slow_factors: tuple[float, ...] = (2.0, 4.0, 8.0)
               ) -> "ChaosSchedule":
        """Deterministic schedule: roughly one event per ``event_every``
        steps, alternating pressure (kill/slow) with relief
        (rejoin/recover), never dropping the live set below ``min_live``
        (default: world // 2 + 1 — a majority quorum)."""
        if min_live is None:
            min_live = world // 2 + 1
        rng = np.random.default_rng(seed)
        status = {r: "live" for r in range(world)}
        events: list[ChaosEvent] = []
        for step in range(event_every, steps, event_every):
            live = [r for r, s in status.items() if s == "live"]
            downed = [r for r, s in status.items() if s != "live"]
            can_press = len(live) > min_live
            press = can_press and (not downed or rng.random() < 0.5)
            if press:
                w = int(rng.choice(live))
                if rng.random() < 0.5:
                    events.append(ChaosEvent(step, KILL, w))
                    status[w] = DEAD
                else:
                    f = float(rng.choice(slow_factors))
                    events.append(ChaosEvent(step, SLOW_EV, w, f))
                    status[w] = SLOW
            elif downed:
                w = int(rng.choice(downed))
                kind = REJOIN if status[w] == DEAD else RECOVER
                events.append(ChaosEvent(step, kind, w))
                status[w] = "live"
        return cls(events=tuple(events), world=world)

    def events_at(self, step: int) -> tuple[ChaosEvent, ...]:
        return tuple(e for e in self.events if e.step == step)

    def apply(self, membership: Membership, step: int) -> Membership:
        """Fold this step's events into ``membership`` (no-op — same
        object, same epoch — when the step has none)."""
        membership.validate_world(self.world)
        for e in self.events_at(step):
            if e.kind == KILL:
                membership = membership.leave(e.worker)
            elif e.kind == SLOW_EV:
                membership = membership.mark_slow(e.worker, e.factor)
            elif e.kind == REJOIN:
                membership = membership.join(e.worker)
            elif e.kind == RECOVER:
                membership = membership.mark_recovered(e.worker)
            else:
                raise ValueError(f"unknown chaos event kind {e.kind!r}")
        return membership

    def latency_factors(self, step: int) -> np.ndarray:
        """(world,) per-worker latency factors in force *after* the events
        up to and including ``step`` — the resilience benchmark's input
        for emulating how long a full barrier would wait (dead workers
        report inf: a barrier never commits without them)."""
        f = np.ones((self.world,), np.float64)
        for e in self.events:
            if e.step > step:
                break
            if e.kind == KILL:
                f[e.worker] = np.inf
            elif e.kind == SLOW_EV:
                f[e.worker] = e.factor
            else:
                f[e.worker] = 1.0
        return f


# --------------------------------------------------------------- faults
#
# ChaosSchedule above mutates *membership* (who the rack has decided is
# in).  FaultSchedule injects the raw failures that force those decisions:
# poisoned gradients, checkpoint corruption, and step stalls.  The point
# of the split is that faults are what the resilience supervisor must
# *detect* — a fault schedule never touches membership itself; demotion
# is the supervisor's job, and the chaos tests assert it happens.

NAN_PUSH = "nan_push"           # worker's gradient goes NaN pre-push
GRAD_BLOWUP = "grad_blowup"     # worker's gradient scaled by `magnitude`
CKPT_CORRUPT = "ckpt_corrupt"   # latest on-disk snapshot damaged
STALL = "stall"                 # worker's push stalls past the deadline

GRAD_FAULTS = (NAN_PUSH, GRAD_BLOWUP)
FAULT_KINDS = (NAN_PUSH, GRAD_BLOWUP, CKPT_CORRUPT, STALL)


@dataclass(frozen=True)
class FaultEvent:
    step: int
    kind: str                   # one of FAULT_KINDS
    worker: int = -1            # -1: not worker-scoped (ckpt_corrupt)
    magnitude: float = 1.0      # blowup scale / stall attempts
    duration: int = 1           # steps the fault persists (a NaN *storm*)

    def active_at(self, step: int) -> bool:
        return self.step <= step < self.step + self.duration


@dataclass(frozen=True)
class FaultSchedule:
    """Seeded, precomputed fault injections over a fixed run length.

    Gradient faults surface as a per-step (world,) *injection vector*
    the sanity-enabled train step multiplies into each worker's local
    gradient (1.0 = clean, NaN = poisoned push, ``magnitude`` = blow-up);
    IO and stall faults are host-side and are applied by the supervisor
    loop / test harness through ``io_faults_at``/``stalls_at``.

    One-shot semantics (``one_shot=True``, the default): an event is an
    *incident* with a total fire budget of ``duration`` — each call to
    ``inject_vector``/``io_faults_at``/``stalls_at`` that finds it active
    consumes one fire.  The distinction matters after a supervisor
    rollback: the loop replays the same step numbers, and a transient
    fault keyed purely on the step index would replay with them, pinning
    the run in a divergence→rollback cycle forever.  ``reset()`` restores
    the full budget (for a replayed reference run); ``one_shot=False``
    makes the schedule a pure function of the step again.  ``faults_at``
    never consumes (introspection).
    """
    events: tuple[FaultEvent, ...]
    world: int
    one_shot: bool = True
    _spent: dict = field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def seeded(cls, *, seed: int, world: int, steps: int,
               fault_every: int = 6,
               kinds: tuple[str, ...] = FAULT_KINDS,
               blowup: float = 1e20, storm_len: int = 2
               ) -> "FaultSchedule":
        """Roughly one fault per ``fault_every`` steps, cycling through
        ``kinds`` deterministically (same seed => same schedule)."""
        rng = np.random.default_rng(seed)
        events: list[FaultEvent] = []
        for i, step in enumerate(range(fault_every, steps, fault_every)):
            kind = kinds[i % len(kinds)]
            w = int(rng.integers(world)) if kind != CKPT_CORRUPT else -1
            if kind == NAN_PUSH:
                events.append(FaultEvent(step, kind, w,
                                         duration=storm_len))
            elif kind == GRAD_BLOWUP:
                events.append(FaultEvent(step, kind, w, magnitude=blowup))
            elif kind == STALL:
                events.append(FaultEvent(
                    step, kind, w, magnitude=float(int(rng.integers(1, 3)))))
            else:
                events.append(FaultEvent(step, kind))
        return cls(events=tuple(events), world=world)

    def faults_at(self, step: int) -> tuple[FaultEvent, ...]:
        return tuple(e for e in self.events if e.active_at(step))

    def reset(self) -> None:
        """Restore every event's full fire budget (replay the schedule)."""
        self._spent.clear()

    def _charge(self, idx: int, step: int) -> bool:
        """True if event ``idx`` fires at ``step``; consumes one fire."""
        ev = self.events[idx]
        if not ev.active_at(step):
            return False
        if not self.one_shot:
            return True
        if self._spent.get(idx, 0) >= ev.duration:
            return False
        self._spent[idx] = self._spent.get(idx, 0) + 1
        return True

    def inject_vector(self, step: int) -> np.ndarray:
        """(world,) float32 gradient multipliers in force at ``step``.
        Consumes gradient-fault fire budget (call once per executed
        step)."""
        v = np.ones((self.world,), np.float32)
        for i, e in enumerate(self.events):
            if e.kind not in GRAD_FAULTS or not self._charge(i, step):
                continue
            if e.kind == NAN_PUSH:
                v[e.worker] = np.nan
            else:
                v[e.worker] = e.magnitude
        return v

    def io_faults_at(self, step: int) -> tuple[FaultEvent, ...]:
        return tuple(e for i, e in enumerate(self.events)
                     if e.kind == CKPT_CORRUPT and self._charge(i, step))

    def stalls_at(self, step: int) -> tuple[FaultEvent, ...]:
        return tuple(e for i, e in enumerate(self.events)
                     if e.kind == STALL and self._charge(i, step))


def corrupt_checkpoint(directory: str, step: int | None = None, *,
                       mode: str = "truncate", seed: int = 0) -> str:
    """Damage one on-disk snapshot in place (test/benchmark fault
    injector).  ``mode``: 'truncate' cuts arrays.npz to half its length
    (a kill mid-write); 'bitflip' flips one seeded bit in the archive
    body (silent media corruption).  Returns the damaged file's path."""
    import os

    from ..checkpoint import latest_step
    step = step if step is not None else latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}", "arrays.npz")
    blob = open(path, "rb").read()
    if mode == "truncate":
        blob = blob[:max(1, len(blob) // 2)]
    elif mode == "bitflip":
        rng = np.random.default_rng(seed)
        b = bytearray(blob)
        # flip a bit inside the member data region, past the zip headers
        pos = int(rng.integers(len(b) // 4, len(b) - 32))
        b[pos] ^= 1 << int(rng.integers(8))
        blob = bytes(b)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}; "
                         f"expected 'truncate' or 'bitflip'")
    with open(path, "wb") as f:
        f.write(blob)
    return path
