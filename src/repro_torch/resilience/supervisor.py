"""The training supervisor: detect → contain → recover (DESIGN.md §13);
the port of ``repro/resilience/supervisor.py``.

One object owns the whole self-healing loop around a ``PHubEngine``:

  detect   — every step runs the sanity-gated train step (the on-card
             NaN/Inf + norm-outlier scan, ``health_chunks``) and the
             supervisor host-syncs the per-worker ``ok_mask`` /
             ``grad_norms`` metrics; the exchange watchdog times dispatch.
  contain  — a poisoned push was already zeroed on the card *before the
             exchange* (the step's own where-semantics gate, the mean
             divided by the dynamic live count); the supervisor's job is
             the slower loop: repeat offenders are demoted through
             ``Membership.demote`` (live→slow→dead) so the static k-of-n
             mask takes over.
  recover  — durable CRC-verified checkpoints every ``checkpoint_every``
             healthy steps (two-phase atomic writes, last ``keep_k``
             retained); on divergence — a non-finite loss, or every
             worker masked for ``divergence_patience`` consecutive steps
             — the engine is rolled back to the latest snapshot that
             passes verification: the parameters (copied into the model
             in place), every optimizer slot and the step counter
             together.

The supervisor is host-side and slow-path: the per-step cost on a clean
rack is one (world,)-vector host sync.  The norm threshold rides as a step
input (``HealthTracker.norm_hi``), so adapting it builds no new step.
The reference's metrics-registry counters and tracer spans are not ported
(ROADMAP.md queue A item 16); ``events``, ``incidents``,
``incident_history`` and ``event_kinds`` are the record.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..checkpoint import (latest_step, restore_latest_valid,
                          save_checkpoint)
from ..elastic import Membership
from ..elastic.chaos import GRAD_FAULTS, STALL, corrupt_checkpoint
from .sanity import HealthTracker, SanityConfig
from .watchdog import (ExchangeTimeout, ExchangeWatchdog, WatchdogConfig,
                       WatchdogExhausted)


@dataclass(frozen=True)
class SupervisorConfig:
    sanity: SanityConfig = field(default_factory=SanityConfig)
    watchdog: WatchdogConfig = field(default_factory=WatchdogConfig)
    checkpoint_dir: str = ""
    checkpoint_every: int = 0           # 0: no durable snapshots
    keep_k: int = 3                     # retained good snapshots
    demote_after: int = 2               # consecutive bad pushes → demote
    divergence_patience: int = 3        # consecutive dead steps → rollback
    max_rollbacks: int = 4              # then give up loudly


class TrainSupervisor:
    """Drives sanity-gated train steps for ``training.loop.fit``.

    ``faults``: an optional ``elastic.FaultSchedule`` — the seeded chaos
    injector.  Gradient faults ride the step's ``inject`` input (enable
    ``SanityConfig.allow_injection``); checkpoint-corruption faults damage
    the latest snapshot on disk; stall faults queue ``ExchangeTimeout``
    into the watchdog.  The supervisor handles its own injected faults.
    """

    def __init__(self, engine, config: Optional[SupervisorConfig] = None,
                 membership: Optional[Membership] = None, faults=None,
                 log_fn=print):
        self.engine = engine
        self.cfg = config or SupervisorConfig()
        world = engine.comm.n_workers
        self.membership = membership or Membership.full(world)
        self.membership.validate_world(world)
        self.tracker = HealthTracker(self.cfg.sanity, world)
        self.watchdog = ExchangeWatchdog(self.cfg.watchdog)
        self.faults = faults
        if (faults is not None and getattr(faults, "world", world) != world
                and any(e.kind in (*GRAD_FAULTS, STALL)
                        for e in faults.events)):
            raise ValueError(f"fault schedule covers {faults.world} "
                             f"workers, rack has {world}")
        self.log_fn = log_fn
        self.events: list[tuple[int, str, str]] = []
        self.incidents: list[dict] = []     # structured event records
        self.rollbacks = 0
        self.last_rollback_s = 0.0      # restore latency of the last one
        self._dead_streak = 0           # consecutive total-push-failures
        self._steps: dict = {}

    # ------------------------------------------------------------- events

    def _event(self, step: int, kind: str, detail: str, **payload) -> None:
        """Record one incident twice: the (step, kind, detail) tuple and
        the structured incident record (``incident_history``)."""
        self.events.append((step, kind, detail))
        self.incidents.append({"step": step, "kind": kind,
                               "detail": detail, **payload})
        if self.log_fn is not None:
            self.log_fn(f"[supervisor] step {step}: {kind} — {detail}")

    def event_kinds(self) -> list[str]:
        return [k for _, k, _ in self.events]

    def incident_history(self, kind: str = None) -> list[dict]:
        """Structured incidents, optionally filtered by kind."""
        if kind is None:
            return list(self.incidents)
        return [e for e in self.incidents if e["kind"] == kind]

    # -------------------------------------------------------------- steps

    def step_fn(self):
        """Sanity-gated step for the current membership, cached by its
        program key (a recurring live set reuses its step)."""
        key = self.membership.program_key()
        if key not in self._steps:
            self._steps[key] = self.engine.make_train_step(
                membership=self.membership, sanity=self.cfg.sanity)
        return self._steps[key]

    def health_inputs(self, step: int) -> dict:
        h = {"norm_hi": np.float32(self.tracker.norm_hi())}
        if self.cfg.sanity.allow_injection:
            if self.faults is not None:
                h["inject"] = self.faults.inject_vector(step)
            else:
                h["inject"] = np.ones((self.membership.world,), np.float32)
        return h

    # ---------------------------------------------------------- the loop

    def run_step(self, state, batch) -> dict:
        """One supervised step: dispatch under the watchdog, digest the
        health metrics, demote offenders, checkpoint or roll back.
        Mutates ``state`` (params/opt/step/losses) and returns the host
        metrics; ``state.step`` moves backward on rollback."""
        i = state.step
        self._apply_io_faults(i)
        health = self.health_inputs(i)
        try:
            new_p, new_o, metrics = self.watchdog.run(
                self.step_fn(), state.params, state.opt, batch, health)
        except WatchdogExhausted as e:
            # injected faults fire pre-dispatch, so state is untouched:
            # demote the implicated worker and re-enter through k-of-n
            self._event(i, "stall_exhausted", str(e), worker=e.worker)
            if e.worker is not None:
                self.demote(i, e.worker, "stalled exchange")
                # the demoted worker left the exchange: its remaining
                # queued stalls cannot block the re-entered step
                dropped = self.watchdog.drop_faults(e.worker)
                if dropped:
                    self._event(i, "faults_flushed",
                                f"worker {e.worker}: {dropped} queued",
                                worker=e.worker, dropped=dropped)
            new_p, new_o, metrics = self.watchdog.run(
                self.step_fn(), state.params, state.opt, batch, health)
        state.params, state.opt = new_p, new_o
        state.step = i + 1
        host = {"loss": float(metrics["loss"]),
                "ok_mask": metrics["ok_mask"].cpu().numpy(),
                "grad_norms": metrics["grad_norms"].cpu().numpy(),
                "n_live": float(metrics["n_live"])}
        state.losses.append(host["loss"])
        self._digest(i, state, host)
        return host

    def _apply_io_faults(self, step: int) -> None:
        if self.faults is None:
            return
        for _ in self.faults.io_faults_at(step):
            if (not self.cfg.checkpoint_dir
                    or latest_step(self.cfg.checkpoint_dir) is None):
                continue
            path = corrupt_checkpoint(self.cfg.checkpoint_dir,
                                      mode="truncate")
            self._event(step, "ckpt_corrupt_injected", path)
        for ev in self.faults.stalls_at(step):
            self.watchdog.inject_fault(
                ExchangeTimeout(f"injected stall (worker {ev.worker})",
                                worker=ev.worker),
                attempts=int(ev.magnitude))
            self._event(step, "stall_injected",
                        f"worker {ev.worker} x{int(ev.magnitude)}")

    def _digest(self, step: int, state, host: dict) -> None:
        ok, norms = host["ok_mask"], host["grad_norms"]
        masked = [int(r) for r in np.nonzero(
            (self.membership.mask() > 0) & (ok == 0))[0]]
        if masked:
            self._event(step, "push_masked",
                        f"workers {masked} excluded "
                        f"(n_live={host['n_live']:g}; norms "
                        f"{[float(norms[r]) for r in masked]})",
                        workers=masked, n_live=host["n_live"])
        self.tracker.observe(ok, norms, live_mask=self.membership.mask())
        dead_step = float(np.sum(ok)) == 0.0
        # a rack-wide failure is a systemic event (data poisoning, a bad
        # threshold, divergence) — roll back below rather than demoting
        # every worker for it; offenses only convict when peers succeed
        if not dead_step:
            for rank in self.tracker.repeat_offenders(self.cfg.demote_after):
                self.demote(step, rank,
                            f"{self.cfg.demote_after} consecutive bad "
                            f"pushes")
        self._dead_streak = self._dead_streak + 1 if dead_step else 0
        diverged = (not np.isfinite(host["loss"])
                    or self._dead_streak >= self.cfg.divergence_patience)
        if diverged:
            why = ("non-finite loss" if not np.isfinite(host["loss"])
                   else f"{self._dead_streak} consecutive steps with "
                        f"every push masked")
            self.rollback(step, state, why)
        elif (self.cfg.checkpoint_dir and self.cfg.checkpoint_every
                and state.step % self.cfg.checkpoint_every == 0):
            save_checkpoint(self.cfg.checkpoint_dir, state.step,
                            {"params": state.params.param_tree(),
                             "opt": state.opt},
                            membership=self.membership,
                            keep_k=self.cfg.keep_k)
            self._event(step, "checkpoint", f"step {state.step} "
                        f"(keep_k={self.cfg.keep_k})",
                        saved_step=state.step)

    # ---------------------------------------------------------- containment

    def demote(self, step: int, rank: int, reason: str) -> None:
        """live→slow→dead escalation via ``Membership.demote``; quorum
        violations surface as events, not crashes (the rack keeps running
        on the current live set)."""
        try:
            self.membership = self.membership.demote(rank)
        except (ValueError, RuntimeError) as e:
            self._event(step, "demote_blocked", f"worker {rank}: {e}")
            return
        self.tracker.reset_rank(rank)
        self._event(step, "demote",
                    f"worker {rank} → "
                    f"{self.membership.workers[rank].status} ({reason}); "
                    f"epoch {self.membership.epoch}, "
                    f"{self.membership.n_live}/{self.membership.world} "
                    f"live",
                    worker=rank, reason=reason,
                    status=self.membership.workers[rank].status,
                    epoch=self.membership.epoch,
                    n_live=self.membership.n_live)

    # ------------------------------------------------------------- recovery

    def rollback(self, step: int, state, reason: str) -> None:
        """Restore the latest snapshot that passes CRC verification — the
        parameters (into the model, in place), every optimizer slot
        (``wire_ef`` included) and the step counter move back together;
        corrupt snapshots are skipped by name.  The restore overrides the
        membership drift check (``membership=None``): demotions since the
        save are *why* we are rolling back, not a configuration bug."""
        if not (self.cfg.checkpoint_dir and self.cfg.checkpoint_every):
            raise RuntimeError(
                f"divergence at step {step} ({reason}) but the supervisor "
                f"has no checkpoint_dir/checkpoint_every to roll back to")
        if self.rollbacks >= self.cfg.max_rollbacks:
            raise RuntimeError(
                f"divergence at step {step} ({reason}) after "
                f"{self.rollbacks} rollbacks — giving up")
        self.rollbacks += 1
        t0 = time.time()
        s, model, opt, skipped = restore_latest_valid(
            self.cfg.checkpoint_dir, self.engine, membership=None,
            model=state.params)
        state.params, state.opt, state.step = model, opt, s
        self.last_rollback_s = time.time() - t0
        del state.losses[s:]
        self.tracker.reset_history()
        self.tracker.reset_offenses()
        self._dead_streak = 0
        self._event(step, "rollback",
                    f"{reason} → restored step {s} in "
                    f"{self.last_rollback_s:.2f}s"
                    + (f", skipped corrupt {skipped}" if skipped else ""),
                    reason=reason, restored_step=s,
                    seconds=self.last_rollback_s,
                    skipped=list(skipped) if skipped else [])
