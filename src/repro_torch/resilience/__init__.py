"""Self-healing training (DESIGN.md §13): the detect→contain→recover loop.

* ``sanity``  — gradient health gate config + the host-side running-median
  norm tracker and offense counter behind the on-card NaN/Inf + norm
  outlier scan (``core/engine.py`` ``make_train_step(..., sanity=)``).
* ``watchdog`` — exchange deadline with retry, exponential backoff and
  seeded jitter around the step's dispatch.
* ``supervisor`` — the training supervisor closing the loop: masks
  poisoned pushes before the exchange, demotes repeat offenders through
  ``Membership.demote``, keeps durable verified checkpoints (last-k,
  CRC-manifested), and rolls the engine back to the latest valid snapshot
  on divergence.
"""
from .sanity import HealthTracker, SanityConfig
from .supervisor import SupervisorConfig, TrainSupervisor
from .watchdog import (ExchangeTimeout, ExchangeWatchdog,
                       TransientExchangeError, WatchdogConfig,
                       WatchdogExhausted)
