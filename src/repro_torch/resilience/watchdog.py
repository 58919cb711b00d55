"""Exchange watchdog: deadline + retry with exponential backoff (§13); the
port of ``repro/resilience/watchdog.py``.

Wraps the dispatch of an exchange step (the supervisor's train step).
Transient failures — an injected chaos stall, a ``TransientExchangeError``
raised by the dispatch path — are retried up to ``retries`` times with
exponential backoff and seeded jitter; an exhausted budget surfaces as
``WatchdogExhausted`` carrying the implicated worker, which the supervisor
demotes before re-entering the step through the k-of-n path.

Emulation caveat: with the workers stacked on one card a collective
cannot literally hang, and the step updates the model in place — so
injected faults fire *before* dispatch (retry is always safe: the
arguments were never touched), while a measured wall-clock deadline
overrun on a step that already committed is *recorded* (``overruns``)
rather than retried: re-running a committed step would apply the update
twice.  A production transport would cancel the in-flight collective
instead.  PyTorch returns before the card finishes, so with a deadline
set the watchdog waits for the card (``torch.cuda.synchronize``) before
it reads the clock; without one it adds no sync.  The reference's
telemetry counters and events are not ported (ROADMAP.md queue A item
16).
"""
from __future__ import annotations

import random
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch


class ExchangeTimeout(RuntimeError):
    """An exchange missed its deadline (or a chaos stall emulating one).

    ``worker``: the implicated worker rank, when attributable (a seeded
    stall fault knows its victim; a generic overrun does not)."""

    def __init__(self, message: str = "exchange deadline exceeded",
                 worker: Optional[int] = None):
        super().__init__(message)
        self.worker = worker


class TransientExchangeError(RuntimeError):
    """A retryable dispatch failure (fault-injection hook)."""

    def __init__(self, message: str = "transient exchange failure",
                 worker: Optional[int] = None):
        super().__init__(message)
        self.worker = worker


class WatchdogExhausted(RuntimeError):
    """Retry budget spent; carries the last fault's implicated worker."""

    def __init__(self, message: str, worker: Optional[int] = None):
        super().__init__(message)
        self.worker = worker


@dataclass(frozen=True)
class WatchdogConfig:
    deadline_s: Optional[float] = None  # None: skip wall-clock timing
    retries: int = 3                    # attempts = retries + 1
    backoff_base_s: float = 0.05        # first retry delay
    backoff_cap_s: float = 2.0
    jitter: float = 0.5                 # delay *= 1 + jitter*U[0,1)
    seed: int = 0                       # jitter is seeded: runs replay


class ExchangeWatchdog:
    """Deadline/retry wrapper for exchange dispatch.

    ``inject_fault(exc, attempts=n)`` queues ``exc`` to be raised on the
    next ``n`` dispatch attempts (the chaos STALL fault class): fewer
    queued faults than the retry budget are absorbed by backoff; more
    exhaust it and escalate to the supervisor.
    """

    def __init__(self, config: Optional[WatchdogConfig] = None):
        self.cfg = config or WatchdogConfig()
        self._rng = random.Random(self.cfg.seed)
        self._faults: deque = deque()
        self.last_delays: tuple = ()    # backoff sleeps of the last run
        self.overruns: list = []        # (elapsed_s, deadline_s) records
        self.total_retries = 0

    def inject_fault(self, exc: Exception, attempts: int = 1) -> None:
        for _ in range(attempts):
            self._faults.append(exc)

    def pending_faults(self) -> int:
        return len(self._faults)

    def drop_faults(self, worker: Optional[int] = None) -> int:
        """Discard queued faults implicating ``worker`` (all when None).
        The supervisor calls this after demoting a stalled worker: once
        it is out of the collective its stalls cannot block the exchange
        any more, so replaying them against the re-entered step would
        punish the wrong rack.  Returns the number dropped."""
        if worker is None:
            n = len(self._faults)
            self._faults.clear()
            return n
        keep = deque(e for e in self._faults
                     if getattr(e, "worker", None) != worker)
        n = len(self._faults) - len(keep)
        self._faults = keep
        return n

    def run(self, fn, *args, **kwargs):
        cfg = self.cfg
        delays = []
        delay = cfg.backoff_base_s
        for attempt in range(cfg.retries + 1):
            try:
                if self._faults:
                    raise self._faults.popleft()
                t0 = time.monotonic()
                out = fn(*args, **kwargs)
                if cfg.deadline_s is not None:
                    _wait_for(out)
                    elapsed = time.monotonic() - t0
                    if elapsed > cfg.deadline_s:
                        # committed-but-slow: record, don't re-dispatch
                        # (updated in place; see module docstring)
                        self.overruns.append((elapsed, cfg.deadline_s))
                self.last_delays = tuple(delays)
                return out
            except (ExchangeTimeout, TransientExchangeError) as e:
                worker = getattr(e, "worker", None)
                if attempt == cfg.retries:
                    self.last_delays = tuple(delays)
                    raise WatchdogExhausted(
                        f"exchange failed {cfg.retries + 1} attempts "
                        f"(last: {e})", worker=worker) from e
                self.total_retries += 1
                d = delay * (1.0 + cfg.jitter * self._rng.random())
                delays.append(d)
                if d > 0:
                    time.sleep(d)
                delay = min(delay * 2.0, cfg.backoff_cap_s)


def _first_tensor(x):
    """The first tensor in a step's outputs (tuples, lists, dicts, a
    module's parameters), or None."""
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, torch.nn.Module):
        return next(x.parameters(), None)
    items = (x.values() if isinstance(x, dict)
             else x if isinstance(x, (tuple, list)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def _wait_for(out) -> None:
    """Wait until the card has finished the work behind ``out``: a CUDA
    sync on the device of its first tensor (CPU work has finished when it
    returns)."""
    t = _first_tensor(out)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)
