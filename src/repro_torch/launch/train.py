"""Training launcher for the PyTorch port.

Runs PHub's sharded_ps train step with W workers stacked on one device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 3 --batch 8 --seq 512 --workers 4
  ... --reduced --device cpu      # small same-family model on the CPU
  ... --supervise --chaos-faults --workers 4 --checkpoint-dir ckpt \
      --checkpoint-every 2          # the self-healing loop, seeded faults
  ... --chaos --workers 4           # seeded kill/slow/rejoin membership

Values the port does not implement (another strategy or architecture, a
batch that does not split over the workers) raise.
"""
from __future__ import annotations

import argparse


def resolve_mode_flags(supervise, elastic, chaos, chaos_faults):
    """Apply the launcher's flag implications and reject combinations
    that would silently discard a requested behaviour (the reference's
    ``resolve_mode_flags``).

    ``--chaos-faults`` implies ``--supervise`` (the supervisor absorbs the
    injected faults); ``--chaos`` implies ``--elastic`` (membership events
    need the elastic datapath).  The supervised loop hands worker
    membership to the TrainSupervisor, so a ``--chaos``/``--elastic``
    schedule under ``--supervise`` would never be consulted: that
    combination fails fast, naming both sides.  Returns ``(supervise,
    elastic)``; raises SystemExit on conflict."""
    supervise = supervise or chaos_faults
    elastic = elastic or chaos
    if supervise and elastic:
        sup_src = "--chaos-faults" if chaos_faults else "--supervise"
        el_src = "--chaos" if chaos else "--elastic"
        raise SystemExit(
            f"{sup_src} runs the self-healing TrainSupervisor, which owns "
            f"worker membership (DESIGN.md §13) — the {el_src} membership "
            f"schedule would be silently discarded before reaching the "
            f"supervised loop. Run {el_src} without {sup_src}, or use "
            f"--chaos-faults alone for supervised fault injection.")
    return supervise, elastic


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--strategy", default="sharded_ps")
    ap.add_argument("--chunk-kb", type=int, default=32)
    ap.add_argument("--wire-format", default="identity",
                    help="identity | bf16 | f16 | int8 (core/wire.py)")
    ap.add_argument("--workers", type=int, default=1,
                    help="workers stacked on the one device")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--keep-k", type=int, default=3,
                    help="good snapshots retained by the supervisor")
    ap.add_argument("--elastic", action="store_true",
                    help="live worker membership: kill/slow/rejoin events "
                         "mask pushes and the mean divides by the live "
                         "count (DESIGN.md §12)")
    ap.add_argument("--chaos", action="store_true",
                    help="a seeded schedule of worker kill/slow/rejoin "
                         "events (implies --elastic)")
    ap.add_argument("--chaos-seed", type=int, default=0)
    ap.add_argument("--chaos-every", type=int, default=5,
                    help="roughly one chaos event or fault per this many "
                         "steps")
    ap.add_argument("--supervise", action="store_true",
                    help="run under the self-healing TrainSupervisor: "
                         "gradient sanity masking, repeat-offender "
                         "demotion, durable verified checkpoints with "
                         "rollback, and the exchange watchdog "
                         "(DESIGN.md §13)")
    ap.add_argument("--chaos-faults", action="store_true",
                    help="a seeded FaultSchedule (NaN pushes, gradient "
                         "blow-ups, checkpoint corruption, stalls) for the "
                         "supervisor to absorb (implies --supervise)")
    args = ap.parse_args(argv)
    args.supervise, args.elastic = resolve_mode_flags(
        args.supervise, args.elastic, args.chaos, args.chaos_faults)

    from ..configs import TrainConfig, get_arch, reduced
    from ..core import PHubEngine, StackedComm
    from ..data import SyntheticTokens
    from ..training import TrainState, fit

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = TrainConfig(strategy=args.strategy, lr=args.lr,
                     chunk_size_bytes=args.chunk_kb * 1024,
                     wire_format=args.wire_format,
                     loss_chunk=min(1024, args.seq))
    engine = PHubEngine(cfg, tc, StackedComm(args.workers), device=args.device)
    params, opt = engine.init_state()
    data = SyntheticTokens(cfg, args.batch, args.seq, seed=tc.seed)
    print(f"[train] arch={cfg.arch_id} params={cfg.n_params() / 1e6:.1f}M "
          f"workers={args.workers} strategy={tc.strategy} "
          f"wire={tc.wire_format} "
          f"device={engine.device}")
    state = TrainState(params=params, opt=opt)
    del opt
    if args.supervise:
        return _train_supervised(engine, state, data, args)
    membership_fn = _membership_fn(args) if args.elastic else None
    state = fit(engine, state, data, steps=args.steps,
                log_every=args.log_every, membership_fn=membership_fn,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every)
    losses = state.losses
    print(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


def _membership_fn(args):
    """step -> Membership: the full rack, with a seeded ChaosSchedule's
    events folded in under --chaos."""
    from ..elastic import ChaosSchedule, Membership

    current = [Membership.full(args.workers)]
    sched = (ChaosSchedule.seeded(seed=args.chaos_seed, world=args.workers,
                                  steps=args.steps,
                                  event_every=args.chaos_every)
             if args.chaos else None)
    print(f"[train] elastic rack: world={args.workers}"
          + (f" chaos seed={args.chaos_seed}, {len(sched.events)} events"
             if sched else ""))

    def membership_at(step):
        if sched is not None:
            for ev in sched.events_at(step):
                print(f"[train] chaos step {step}: {ev.kind} worker "
                      f"{ev.worker}"
                      + (f" x{ev.factor:g}" if ev.kind == "slow" else ""))
            m2 = sched.apply(current[0], step)
            if m2 is not current[0]:
                current[0] = m2
                print(f"[train] membership epoch {m2.epoch}: "
                      f"{m2.n_live}/{m2.world} live")
        return current[0]
    return membership_at


def _train_supervised(engine, state, data, args):
    """Self-healing loop: the TrainSupervisor owns membership, durable
    checkpoints and rollback; --chaos-faults feeds it a seeded
    FaultSchedule to absorb unattended."""
    from ..elastic import FaultSchedule
    from ..resilience import (SanityConfig, SupervisorConfig,
                              TrainSupervisor, WatchdogConfig)
    from ..training import fit

    world = engine.comm.n_workers
    faults = None
    if args.chaos_faults:
        faults = FaultSchedule.seeded(seed=args.chaos_seed, world=world,
                                      steps=args.steps,
                                      fault_every=args.chaos_every)
        print(f"[train] fault schedule: seed={args.chaos_seed} "
              f"{len(faults.events)} events over {args.steps} steps")
    sup = TrainSupervisor(
        engine,
        SupervisorConfig(
            sanity=SanityConfig(allow_injection=args.chaos_faults),
            watchdog=WatchdogConfig(),
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=args.checkpoint_every,
            keep_k=args.keep_k),
        faults=faults)
    print(f"[train] supervised: world={world} keep_k={args.keep_k} "
          f"checkpoints="
          f"{args.checkpoint_dir or '(none: rollback disabled)'}")
    state = fit(engine, state, data, steps=args.steps,
                log_every=args.log_every, supervisor=sup)
    losses = state.losses
    print(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}; {sup.rollbacks} rollbacks, "
          f"{sup.event_kinds().count('demote')} demotions")
    return losses


if __name__ == "__main__":
    main()
