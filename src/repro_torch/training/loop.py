"""Training loop over a PHubEngine (``repro/training/loop.py`` without the
checkpoint, telemetry, membership and supervisor hooks, which are queued
in ROADMAP.md)."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class TrainState:
    params: object
    opt: object
    step: int = 0
    losses: list = field(default_factory=list)


def fit(engine, state: TrainState, data, *, steps: int,
        log_every: int = 10, log_fn: Callable[[str], None] = print,
        hooks: Optional[list[Callable[[TrainState, dict], None]]] = None
        ) -> TrainState:
    """Run ``steps`` PHub train steps from ``state``.

    data: SyntheticTokens-like (``torch_batch(step, device)``).  hooks:
    callables (state, metrics) invoked after every step.  The loss is read
    back to the host (a device sync) only at log boundaries, on the final
    step, and when hooks are installed."""
    step_fn = engine.make_train_step()
    t0 = time.perf_counter()
    tokens = 0
    last = state.step + steps - 1
    for i in range(state.step, state.step + steps):
        batch = data.torch_batch(i, engine.device)
        state.params, state.opt, metrics = step_fn(state.params, state.opt,
                                                   batch)
        state.step = i + 1
        tokens += batch["tokens"].numel()
        should_log = bool(log_every) and (i % log_every == 0 or i == last)
        if hooks or should_log or i == last:
            loss = float(metrics["loss"])                 # host sync
            state.losses.append(loss)
            for h in hooks or ():
                h(state, metrics)
            if should_log:
                log_fn(f"[fit] step {i:5d} loss {loss:.4f} "
                       f"({tokens / (time.perf_counter() - t0):,.0f} tok/s)")
    return state
