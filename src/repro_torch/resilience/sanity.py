"""Gradient sanity masking: config + host-side health tracking (§13); a
copy of ``repro/resilience/sanity.py`` (numpy only).

The *on-card* half of the gate lives in ``core/engine.py`` (the sanity
variant of ``make_train_step``): each worker's post-injection gradient
row is reduced to one f32 sum of squares (``health_chunks``, the fused
isfinite+norm pass), a 0/1 verdict is derived — finite AND flat norm
within the supervisor's ceiling — and a bad worker's whole row is zeroed
(``masked_fill_``, where-semantics) before the exchange, whose mean
divides by the *dynamic* count of pushes that joined, kept on the card.

This module is the *host* half: ``SanityConfig`` (the choices a step
function is built with) and ``HealthTracker`` (the running-median
threshold the supervisor feeds back in as a step input, plus per-worker
offense counts driving demotion).  The threshold is an input, not a
property of the step function, so it adapts every step without a new one.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class SanityConfig:
    """The choices a gated step function is built with.

    norm_factor: a worker's flat gradient norm above ``norm_factor`` ×
      the running median of healthy norms fails the outlier test.
    warmup: steps of history before the norm test arms (until then only
      the NaN/Inf scan gates; the threshold is +inf).
    window: running-median window, in steps, of healthy norm medians.
    norm_floor: threshold never drops below this (an all-zero warmup —
      e.g. frozen params — must not mask legitimate first gradients).
    allow_injection: carry a (world,) gradient-multiplier input through
      the step for chaos fault injection (1.0 clean / NaN poison /
      large blow-up).  Off by default: the clean path pays nothing.
    """
    norm_factor: float = 16.0
    warmup: int = 3
    window: int = 32
    norm_floor: float = 1e-6
    allow_injection: bool = False


class HealthTracker:
    """Running-median norm threshold + per-worker offense counts.

    ``observe`` digests one step's replicated (world,) health metrics —
    the 0/1 verdict vector and the per-worker flat norms — appends the
    median of the *healthy* norms to the running window, and bumps a
    consecutive-offense counter per masked worker (reset the step it
    comes back clean).  ``repeat_offenders`` names workers whose streak
    reached the supervisor's demotion threshold.
    """

    def __init__(self, config: SanityConfig, world: int):
        self.cfg = config
        self.world = world
        self._norms: deque = deque(maxlen=config.window)
        self.offenses = np.zeros((world,), np.int64)

    def norm_hi(self) -> float:
        """The gradient-norm ceiling to feed the step (a step input, so
        adapting it changes no program; +inf until ``warmup`` healthy
        observations exist)."""
        if len(self._norms) < self.cfg.warmup:
            return float("inf")
        med = float(np.median(self._norms))
        return max(self.cfg.norm_floor, self.cfg.norm_factor * med)

    def observe(self, ok_mask, grad_norms, live_mask=None) -> None:
        ok = np.asarray(ok_mask, np.float64)
        norms = np.asarray(grad_norms, np.float64)
        live = (np.ones_like(ok) if live_mask is None
                else np.asarray(live_mask, np.float64))
        healthy = (ok > 0) & np.isfinite(norms)
        if healthy.any():
            self._norms.append(float(np.median(norms[healthy])))
        # offense: a worker the membership expected to contribute whose
        # push got masked this step; a clean step resets its streak
        bad = (live > 0) & (ok == 0)
        self.offenses[bad] += 1
        self.offenses[~bad & (live > 0)] = 0

    def repeat_offenders(self, demote_after: int) -> list[int]:
        return [int(r) for r in np.nonzero(
            self.offenses >= demote_after)[0]]

    def reset_rank(self, rank: int) -> None:
        """Forget a worker's streak (after demotion, or on rejoin)."""
        self.offenses[rank] = 0

    def reset_history(self) -> None:
        """Drop the norm window (after a rollback: the restored
        trajectory's norms are the baseline again)."""
        self._norms.clear()

    def reset_offenses(self) -> None:
        """Clear every worker's streak (after a rollback: the offenses
        belonged to the discarded trajectory)."""
        self.offenses[:] = 0
