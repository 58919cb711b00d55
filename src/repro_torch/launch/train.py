"""Training launcher for the PyTorch port.

Runs PHub's train step (``--strategy`` sharded_ps, hierarchical,
allreduce or centralized_ps) with W workers stacked on one device
(``--workers W``), or one worker in each of N processes over
``torch.distributed`` (``--nproc N --backend gloo|nccl``, the counterpart
of the reference's ``--devices``; ``launch/dist.py``).  ``--pods P`` lays
the W (or N) workers out as P pods of W/P, the counterpart of the
reference's ``--mesh PxDx1``: the hierarchical strategy's racks, whose
cross-pod leg ``--wire-format-dcn`` may encode.  gloo ranks may share one
card (their collectives go through host memory); NCCL needs a card a
rank.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 3 --batch 8 --seq 512 --workers 4
  ... --reduced --device cpu      # small same-family model on the CPU
  ... --supervise --chaos-faults --workers 4 --checkpoint-dir ckpt \
      --checkpoint-every 2          # the self-healing loop, seeded faults
  ... --chaos --workers 4           # seeded kill/slow/rejoin membership
  ... --workers 4 --windows 5 --overlap   # windowed exchange, chunk-ready
  ... --nproc 2 --backend gloo      # one worker a process (gloo)
  ... --workers 4 --pods 2 --strategy hierarchical --wire-format-dcn int8
                                    # PHub's rack deployment, int8 DCN tier
  ... --tenants 2 --workers 2       # N jobs co-scheduled on one packed
                                    # rack domain (lr x (i+1), seed i)

Values the port does not implement (fsdp_stream, another architecture, a
batch that does not split over the workers) raise.
"""
from __future__ import annotations

import argparse
import time

# a collective of --nproc that takes longer is a hung group
COLLECTIVE_TIMEOUT_S = 1800.0


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


def check_tenants(args) -> None:
    """Refuse what a co-scheduled run cannot honour, naming the flag."""
    if args.tenants < 1:
        raise SystemExit(f"--tenants must be >= 1, got {args.tenants}")
    if args.tenants == 1:
        return
    if args.supervise:
        raise SystemExit("--supervise drives a solo engine; --tenants > 1 "
                         "is not supervised (run the jobs separately)")
    for flag, on in (("--elastic/--chaos", args.elastic),
                     ("--checkpoint-dir", args.checkpoint_dir)):
        if on:
            raise SystemExit(f"{flag} drives a solo engine; --tenants > 1 "
                             f"co-schedules jobs without it (run the jobs "
                             f"separately)")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--strategy", default="sharded_ps",
                    help="sharded_ps | hierarchical | allreduce | "
                         "centralized_ps")
    ap.add_argument("--chunk-kb", type=int, default=32)
    ap.add_argument("--windows", type=int, default=1,
                    help="pipeline windows per dtype group")
    ap.add_argument("--overlap", action="store_true",
                    help="chunk-ready dispatch: window rings launch "
                         "mid-backward (DESIGN.md §14)")
    ap.add_argument("--wire-format", default="identity",
                    help="identity | bf16 | f16 | int8 (core/wire.py)")
    ap.add_argument("--wire-format-dcn", default=None,
                    help="the hierarchical strategy's cross-pod wire: "
                         "identity | bf16 | f16 | int8")
    ap.add_argument("--workers", type=int, default=1,
                    help="workers stacked on the one device")
    ap.add_argument("--pods", type=int, default=1,
                    help="P pods of W/P workers (the reference's --mesh "
                         "PxDx1): hierarchical's racks")
    ap.add_argument("--nproc", type=int, default=1,
                    help="worker processes over torch.distributed, one "
                         "worker each (exclusive with --workers)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="the process group's backend (default gloo); "
                         "given with --nproc 1, one rank over it")
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
    ap.add_argument("--tenants", type=int, default=1,
                    help="co-schedule N jobs of this config (job i at lr x "
                         "(i+1), seed i) onto one shared rack chunk domain")
    args = ap.parse_args(argv)
    args.supervise, args.elastic = resolve_mode_flags(
        args.supervise, args.elastic, args.chaos, args.chaos_faults)
    check_tenants(args)
    if args.nproc > 1 or args.backend is not None:
        if args.workers != 1:
            raise SystemExit("--nproc runs one worker a process; drop "
                             "--workers (the stacked Comm)")
        from . import dist
        # one intra-op thread a CPU rank: the ranks are the parallelism
        results = dist.run(_train, args.nproc, args.backend or "gloo",
                           args.device, COLLECTIVE_TIMEOUT_S, args=(args,),
                           threads=1 if args.device == "cpu" else None,
                           pods=args.pods)
        return results[0]
    from ..core import StackedComm
    return _train(StackedComm(args.workers, args.pods), args.device, args)


def _train(comm, device, args):
    """Build the engine over ``comm`` on ``device`` and train; returns the
    losses (rank 0 prints).  Under ``--nproc`` each rank runs it."""
    from ..configs import TrainConfig, get_arch, reduced
    from ..core import PHubEngine, StackedComm
    from ..core.pipeline import effective_windows
    from ..data import SyntheticTokens
    from ..training import TrainState, fit

    say = print if comm.rank == 0 else (lambda *a, **k: None)
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    tc = TrainConfig(strategy=args.strategy, lr=args.lr,
                     chunk_size_bytes=args.chunk_kb * 1024,
                     wire_format=args.wire_format,
                     wire_format_dcn=args.wire_format_dcn,
                     pipeline_windows=args.windows,
                     overlap_backward=args.overlap,
                     loss_chunk=min(1024, args.seq))
    if args.tenants > 1:
        return _train_multitenant(comm, device, cfg, tc, args, say)
    engine = PHubEngine(cfg, tc, comm, device=device)
    params, opt = engine.init_state()
    data = SyntheticTokens(cfg, args.batch, args.seq, seed=tc.seed)
    windows = [effective_windows(g, tc.pipeline_windows)
               for g in engine.chunk_plan.groups]
    procs = ("" if isinstance(comm, StackedComm) else
             f" ({comm.n_workers} processes, {comm.backend})")
    say(f"[train] arch={cfg.arch_id} params={cfg.n_params() / 1e6:.1f}M "
        f"workers={comm.n_workers}{procs} pods={comm.pods} "
        f"strategy={tc.strategy} wire={tc.wire_format} "
        f"dcn={tc.wire_format_dcn or 'identity'} "
        f"windows={tc.pipeline_windows} "
        f"(effective {windows}) overlap={tc.overlap_backward} "
        f"device={engine.device}")
    state = TrainState(params=params, opt=opt)
    del opt
    if args.supervise:
        return _train_supervised(engine, state, data, args)
    membership_fn = (_membership_fn(args, comm.n_workers, say)
                     if args.elastic else None)
    state = fit(engine, state, data, steps=args.steps,
                log_every=args.log_every, membership_fn=membership_fn,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every)
    losses = state.losses
    say(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    return losses


def _train_multitenant(comm, device, cfg, tc, args, say=print):
    """The co-scheduled loop: N jobs of one config (job i at lr x (i+1),
    seed i, its own data), attached in one ``attach_services`` and stepped
    together by ``co_step``.  Returns {job: losses}."""
    import dataclasses

    import torch

    from ..core import PHubConnectionManager
    from ..data import SyntheticTokens

    cm = PHubConnectionManager()
    handles, models, data = [], {}, {}
    for i in range(args.tenants):
        ns = f"job{i}"
        tci = dataclasses.replace(tc, lr=args.lr * (i + 1), seed=i)
        h = cm.create_service(ns, cfg, tci, comm, device=device)
        models[ns] = cm.init_service(h)[0]
        data[ns] = SyntheticTokens(cfg, args.batch, args.seq, seed=i)
        handles.append(h)
    cm.attach_services(handles)       # one re-pack for the whole fleet
    dom = cm.packed_domain
    say(f"[train] arch={cfg.arch_id} params={cfg.n_params() / 1e6:.1f}M "
        f"tenants={args.tenants} workers={comm.n_workers} pods={comm.pods} "
        f"strategy={tc.strategy} wire={tc.wire_format} "
        f"windows={tc.pipeline_windows} device={device}; packed domain: "
        + ", ".join(f"{k}: {g.padded:,} ({g.n_shards} shards of "
                    f"{g.chunks_per_shard} chunks; chunks a shard "
                    f"{dom.shard_loads(k)})" for k, g in dom.groups.items()))
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    losses = {h.namespace: [] for h in handles}
    sync()
    t0 = time.perf_counter()
    for step in range(args.steps):
        batches = {ns: d.torch_batch(step, device) for ns, d in data.items()}
        models, metrics = cm.co_step(handles, models, batches)
        for ns, m in metrics.items():
            losses[ns].append(float(m["loss"]))
        if args.log_every and step % args.log_every == 0:
            say(f"[train] step {step:4d} " + " ".join(
                f"{ns}={losses[ns][-1]:.4f}" for ns in losses))
    sync()
    dt = time.perf_counter() - t0
    tput = args.tenants * args.batch * args.seq * args.steps / dt
    say(f"[train] done: {tput:,.0f} aggregate tok/s over {args.tenants} "
        f"tenants")
    for ns, acct in cm.accounting().items():
        cum = acct["cumulative"]
        say(f"[train] {ns}: steps={cum['steps']} "
            f"model_mb={acct['model_bytes'] / 1e6:.1f} "
            f"share={acct['domain_share']:.2f} "
            f"pushed_mb={cum['push_bytes'] / 1e6:.1f}")
    return losses


def _membership_fn(args, world, say=print):
    """step -> Membership: the full rack, with a seeded ChaosSchedule's
    events folded in under --chaos."""
    from ..elastic import ChaosSchedule, Membership

    current = [Membership.full(world)]
    sched = (ChaosSchedule.seeded(seed=args.chaos_seed, world=world,
                                  steps=args.steps,
                                  event_every=args.chaos_every)
             if args.chaos else None)
    say(f"[train] elastic rack: world={world}"
          + (f" chaos seed={args.chaos_seed}, {len(sched.events)} events"
             if sched else ""))

    def membership_at(step):
        if sched is not None:
            for ev in sched.events_at(step):
                say(f"[train] chaos step {step}: {ev.kind} worker "
                      f"{ev.worker}"
                      + (f" x{ev.factor:g}" if ev.kind == "slow" else ""))
            m2 = sched.apply(current[0], step)
            if m2 is not current[0]:
                current[0] = m2
                say(f"[train] membership epoch {m2.epoch}: "
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
