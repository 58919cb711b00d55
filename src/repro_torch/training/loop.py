"""Training loop over a PHubEngine (``repro/training/loop.py``): plain
steps, an elastic membership per step, periodic checkpoints, or the
self-healing ``TrainSupervisor``.  The reference's telemetry hooks (tracer
spans, the metrics registry) are ROADMAP.md queue A item 16."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..checkpoint import save_checkpoint


@dataclass
class TrainState:
    params: object
    opt: object
    step: int = 0
    losses: list = field(default_factory=list)


def fit(engine, state: TrainState, data, *, steps: int,
        log_every: int = 10, log_fn: Callable[[str], None] = print,
        checkpoint_dir: str = "", checkpoint_every: int = 0,
        hooks: Optional[list[Callable[[TrainState, dict], None]]] = None,
        membership_fn: Optional[Callable[[int], object]] = None,
        supervisor=None) -> TrainState:
    """Run ``steps`` PHub train steps from ``state``.

    data: SyntheticTokens-like (``torch_batch(step, device)``).  hooks:
    callables (state, metrics) invoked after every step.
    membership_fn: step -> elastic Membership or None; a change of its
    live set (a worker killed, straggling or rejoined, e.g. a
    ChaosSchedule folding events in) builds a step for the new live set,
    cached by its program key, so a recurring membership reuses its step.
    checkpoint_dir/checkpoint_every: a durable snapshot every that many
    steps.  supervisor: a ``resilience.TrainSupervisor`` (DESIGN.md §13);
    the loop then runs sanity-gated steps through it (exclusive with
    membership_fn and the checkpoint arguments: the supervisor owns
    membership and the snapshot cadence).

    The loss is read back to the host (a device sync) only at log
    boundaries, on the final step, and when hooks are installed; the
    supervised loop syncs its health metrics every step (that sync is the
    detector)."""
    if supervisor is not None:
        if membership_fn is not None or checkpoint_dir or checkpoint_every:
            raise ValueError(
                "fit(supervisor=...) owns membership and checkpointing; "
                "drop membership_fn/checkpoint_dir/checkpoint_every and "
                "configure them on SupervisorConfig instead")
        return _fit_supervised(engine, state, data, steps=steps,
                               log_every=log_every, log_fn=log_fn,
                               hooks=hooks, supervisor=supervisor)
    step_cache = {None: engine.make_train_step()}
    step_fn = step_cache[None]
    membership = None
    t0 = time.perf_counter()
    tokens = 0
    last = state.step + steps - 1
    for i in range(state.step, state.step + steps):
        if membership_fn is not None:
            # called exactly once per step (a stateful provider must not
            # see a step twice); the checkpoint below reuses this value
            membership = membership_fn(i)
            key = (None if membership is None or membership.all_live
                   else membership.program_key())
            if key not in step_cache:
                step_cache[key] = engine.make_train_step(
                    membership=membership)
            step_fn = step_cache[key]
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
        if (checkpoint_dir and checkpoint_every
                and state.step % checkpoint_every == 0):
            save_checkpoint(checkpoint_dir, state.step,
                            {"params": state.params.param_tree(),
                             "opt": state.opt}, membership=membership)
    return state


def _fit_supervised(engine, state: TrainState, data, *, steps: int,
                    log_every: int, log_fn, hooks, supervisor) -> TrainState:
    """The supervised loop body: a while-loop because rollback moves
    ``state.step`` backward.  Bounded by a progress guard sized from the
    supervisor's own rollback budget — a supervisor that keeps rolling
    back past ``max_rollbacks`` raises before the guard trips, so the
    guard only catches a supervisor that loops without progress."""
    end = state.step + steps
    t0 = time.perf_counter()
    tokens = 0
    budget = steps * (supervisor.cfg.max_rollbacks + 2) + 16
    iters = 0
    while state.step < end:
        iters += 1
        if iters > budget:
            raise RuntimeError(
                f"supervised fit exceeded its progress budget "
                f"({budget} iterations for {steps} steps) — the "
                f"supervisor is rolling back without making progress")
        i = state.step
        batch = data.torch_batch(i, engine.device)
        host = supervisor.run_step(state, batch)
        tokens += batch["tokens"].numel()
        for h in hooks or ():
            h(state, host)
        if bool(log_every) and (i % log_every == 0 or state.step >= end):
            log_fn(f"[fit] step {i:5d} loss {host['loss']:.4f} "
                   f"n_live {host['n_live']:g} "
                   f"({tokens / (time.perf_counter() - t0):,.0f} tok/s)")
    return state
