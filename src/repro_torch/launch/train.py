"""Training launcher for the PyTorch port.

Runs PHub's train step (``--strategy`` sharded_ps, hierarchical,
allreduce, centralized_ps or fsdp_stream) with W workers stacked on one device
(``--workers W``), or one worker in each of N processes over
``torch.distributed`` (``--nproc N --backend gloo|nccl``, the counterpart
of the reference's ``--devices``; ``launch/dist.py``).  ``--pods P`` lays
the W (or N) workers out as P pods of W/P, the counterpart of the
reference's ``--mesh PxDx1``: the hierarchical strategy's racks, whose
cross-pod leg ``--wire-format-dcn`` may encode.  gloo ranks may share one
card (their collectives go through host memory); NCCL needs a card a
rank.

``--arch`` takes any of the reference's ten architectures
(``configs/registry.py``); as the reference's launcher, it trains a
frontend architecture (internvl2-2b, musicgen-medium) on its tokens alone,
with no prefix of frontend embeddings (``data.PrefixedTokens`` adds one).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 3 --batch 8 --seq 512 --workers 4
  ... --reduced --device cpu      # small same-family model on the CPU
  ... --supervise --chaos-faults --workers 4 --checkpoint-dir ckpt \
      --checkpoint-every 2          # the self-healing loop, seeded faults
  ... --chaos --workers 4           # seeded kill/slow/rejoin membership
  ... --workers 4 --windows 5 --overlap   # windowed exchange, chunk-ready
  ... --nproc 2 --backend gloo      # one worker a process (gloo)
  ... --workers 4 --strategy fsdp_stream   # one gradient a leaf, no rows
  ... --workers 4 --pods 2 --strategy hierarchical --wire-format-dcn int8
                                    # PHub's rack deployment, int8 DCN tier
  ... --tenants 2 --workers 2       # N jobs co-scheduled on one packed
                                    # rack domain (lr x (i+1), seed i)
  ... --workers 4 --telemetry --calibrate --telemetry-out out
                                    # spans, metrics, the probes and the
                                    # attribution table (below)
  ... --workers 4 --auto-tune       # the exchange autotuner's lint-green
                                    # winner (launch/tune.py)

``--telemetry`` (stacked workers only) traces the run (``telemetry/``):
before the loop it times two probes on copies of the model and the
optimizer state, the zero-compute step (``probe/exchange``: the exchange
alone, paper §4.4) and one full train step (``probe/step``), each rep
ending in a device synchronization; it prints the attribution table
(``telemetry/attribution.py``) and writes ``trace.json``,
``metrics.jsonl`` and ``report.txt`` under ``--telemetry-out`` (default
``results/torch/telemetry``, ``paths.py``).
``--calibrate`` (implies ``--telemetry``) first solves the cost model's
constants on this card (``tuning/calibrate.py``, ``CARD_PROBE_ELEMS`` a
worker row), anchors their level to the zero-compute probe and saves
``calibration_{W}w.json`` there; without it the table's model comes from
such a file of this card, if one is there, and otherwise the table keeps
the measured exchange as one row.  The training run's own state and
losses are the same with the flags on or off, and the launcher restores
the null telemetry pair before it returns.

``--auto-tune`` (stacked workers) consults the autotuner's cache
(``--tune-cache-dir``, default ``results/torch/tuning``) for this request
(the baseline flags' exchange config, ``--workers``, the model, this
device), tuning on a miss on this device's saved calibration
(``launch/tune.py --calibrate`` makes one), refuses to train unless the
winner is lint-green, and trains with the winner's strategy, windows,
wires, chunk size and ``--pods``, as if those flags had been given.

Values the port does not implement (fsdp_stream or ``--auto-tune`` over
``--nproc``: ROADMAP.md queue A item 4b; another architecture, a batch that does not split over
the workers) raise.  Under fsdp_stream ``--telemetry`` keeps no
zero-compute probe (the strategy has no chunk domain), as the reference's
launcher.
"""
from __future__ import annotations

import argparse
import os
import time

from ..paths import TELEMETRY_DIR

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
                         "centralized_ps | fsdp_stream")
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
    ap.add_argument("--telemetry", action="store_true",
                    help="per-phase step tracing + metrics registry: runs "
                         "the two probes, prints the attribution table and "
                         "writes trace.json / metrics.jsonl / report.txt")
    ap.add_argument("--telemetry-out", default=TELEMETRY_DIR,
                    help="artifact directory for --telemetry (default "
                         "results/torch/telemetry)")
    ap.add_argument("--calibrate", action="store_true",
                    help="solve the cost model's constants (bw_ici, "
                         "allreduce_factor, bw_codec) on this card from "
                         "probe steps before attribution (implies "
                         "--telemetry)")
    ap.add_argument("--auto-tune", action="store_true",
                    help="pick strategy/windows/wires/chunk/pods with the "
                         "exchange autotuner: consult its cache, tune on a "
                         "miss, and refuse to train unless the winner is "
                         "lint-green.  Overrides --strategy/--windows/"
                         "--wire-format/--wire-format-dcn/--chunk-kb/--pods")
    ap.add_argument("--tune-top-k", type=int, default=3,
                    help="candidates the autotuner times on a cache miss")
    ap.add_argument("--tune-steps", type=int, default=5,
                    help="timed reps per autotuner candidate")
    ap.add_argument("--tune-cache-dir", default="",
                    help="the autotuner's cache (default "
                         "results/torch/tuning)")
    args = ap.parse_args(argv)
    args.supervise, args.elastic = resolve_mode_flags(
        args.supervise, args.elastic, args.chaos, args.chaos_faults)
    args.telemetry = args.telemetry or args.calibrate
    args.argv = list(argv) if argv is not None else None
    check_tenants(args)
    if args.nproc > 1 or args.backend is not None:
        if args.auto_tune:
            raise NotImplementedError(
                "--auto-tune over a process group is not ported yet "
                "(ROADMAP.md queue A item 4b): tune stacked workers "
                "(--workers)")
        if args.strategy == "fsdp_stream":
            raise NotImplementedError(
                f"the fsdp_stream strategy over a process group ("
                f"{args.backend or 'gloo'}, {args.nproc} ranks) is not "
                f"ported yet (ROADMAP.md queue A item 4b)")
        if args.telemetry:
            raise SystemExit("--telemetry traces this process: run it with "
                             "stacked workers (--workers), not --nproc")
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
    from .. import telemetry
    from ..core import StackedComm
    comm = (_auto_tuned(args) if args.auto_tune
            else StackedComm(args.workers, args.pods))
    try:
        return _train(comm, args.device, args)
    finally:
        if args.telemetry:
            telemetry.disable()


def _model_config(args):
    from ..configs import get_arch, reduced
    cfg = get_arch(args.arch)
    return reduced(cfg) if args.reduced else cfg


def _train_config(args):
    """The run's TrainConfig from the flags."""
    from ..configs import TrainConfig
    return TrainConfig(strategy=args.strategy, lr=args.lr,
                       chunk_size_bytes=args.chunk_kb * 1024,
                       wire_format=args.wire_format,
                       wire_format_dcn=args.wire_format_dcn,
                       pipeline_windows=args.windows,
                       overlap_backward=args.overlap,
                       loss_chunk=min(1024, args.seq))


def _auto_tuned(args):
    """Consult the exchange autotuner's cache for (the flags' exchange
    config, --workers, the model, this device), tuning on a miss on this
    device's saved calibration, set the flags of the lint-green winner's
    config (``Candidate.tc_kwargs()``, ``--pods``) and return its layout
    (``tuning.cost.context_for``).  Refuses to train on anything that did
    not pass the rack lint."""
    from ..models import param_specs
    from ..tuning import DEFAULT_CACHE_DIR, Candidate, autotune, context_for
    from .tune import saved_topology

    cfg = _model_config(args)
    W = args.workers
    cache_dir = args.tune_cache_dir or DEFAULT_CACHE_DIR
    report = autotune(
        param_specs(cfg), _train_config(args), W,
        topo=lambda: saved_topology(W, args.device, cache_dir),
        top_k=args.tune_top_k, steps=args.tune_steps, cache_dir=cache_dir,
        arch=args.arch, d_model=cfg.d_model if args.reduced else 0,
        device=args.device)
    if not report["lint"].get("ok"):
        raise SystemExit(
            "[train] --auto-tune: the tuned winner is not lint-green; "
            "refusing to train on an unvetted config "
            f"(errors: {report['lint'].get('errors')})")
    cand = Candidate.from_dict(report["candidate"])
    kw = cand.tc_kwargs()
    args.strategy, args.windows = kw["strategy"], kw["pipeline_windows"]
    args.wire_format, args.wire_format_dcn = (kw["wire_format"],
                                              kw["wire_format_dcn"])
    args.chunk_kb = kw["chunk_size_bytes"] // 1024
    args.pods = cand.pods
    src = ("cache hit" if report["cache_hit"] else
           f"tuned, {report['timed_candidates']} candidates timed")
    print(f"[train] auto-tune ({src}): {cand.strategy} "
          f"W={cand.pipeline_windows} wire={cand.wire_format}/"
          f"{cand.wire_format_dcn or '-'} "
          f"chunk={cand.chunk_size_bytes // 1024}KB "
          f"mesh={cand.pods}x{cand.data} key={report['key']}")
    return context_for(cand)


def _train(comm, device, args):
    """Build the engine over ``comm`` on ``device`` and train; returns the
    losses (rank 0 prints).  Under ``--nproc`` each rank runs it."""
    from ..core import PHubEngine, StackedComm
    from ..core.pipeline import effective_windows
    from ..data import SyntheticTokens
    from ..training import TrainState, fit

    say = print if comm.rank == 0 else (lambda *a, **k: None)
    cfg = _model_config(args)
    tc = _train_config(args)
    if args.telemetry:
        _enable_telemetry(cfg, tc, comm, device, args)
    if args.tenants > 1:
        losses = _train_multitenant(comm, device, cfg, tc, args, say)
        _finish_telemetry(args)
        return losses
    engine = PHubEngine(cfg, tc, comm, device=device)
    params, opt = engine.init_state()
    data = SyntheticTokens(cfg, args.batch, args.seq, seed=tc.seed)
    windows = ([effective_windows(g, tc.pipeline_windows)
                for g in engine.chunk_plan.groups]
               if engine.chunk_plan is not None else [])
    procs = ("" if isinstance(comm, StackedComm) else
             f" ({comm.n_workers} processes, {comm.backend})")
    say(f"[train] arch={cfg.arch_id} params={cfg.n_params() / 1e6:.1f}M "
        f"workers={comm.n_workers}{procs} pods={comm.pods} "
        f"strategy={tc.strategy} wire={tc.wire_format} "
        f"dcn={tc.wire_format_dcn or 'identity'} "
        f"windows={tc.pipeline_windows} "
        f"(effective {windows}) overlap={tc.overlap_backward} "
        f"device={engine.device}")
    probe = (_run_probes(engine, params, opt, data, args)
             if args.telemetry else None)
    state = TrainState(params=params, opt=opt)
    del opt
    if args.supervise:
        losses = _train_supervised(engine, state, data, args)
        _finish_telemetry(args, probe)
        return losses
    membership_fn = (_membership_fn(args, comm.n_workers, say)
                     if args.elastic else None)
    state = fit(engine, state, data, steps=args.steps,
                log_every=args.log_every, membership_fn=membership_fn,
                checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.checkpoint_every)
    losses = state.losses
    say(f"[train] done: first loss {losses[0]:.4f} -> last {losses[-1]:.4f}")
    _finish_telemetry(args, probe)
    return losses


def _device_name(device) -> str:
    import torch
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _enable_telemetry(cfg, tc, comm, device, args) -> None:
    """Install the telemetry pair, seeded from the run's seed, with the
    run's identity in the trace's metadata."""
    import platform
    import sys

    import torch

    from .. import telemetry
    telemetry.enable(seed=tc.seed, meta={
        "argv": args.argv if args.argv is not None else sys.argv[1:],
        "torch": torch.__version__, "python": platform.python_version(),
        "card": _device_name(device), "devices": comm.n_workers,
        "pods": comm.pods, "arch": cfg.arch_id, "strategy": tc.strategy,
        "windows": tc.pipeline_windows, "wire": tc.wire_format,
        "tenants": args.tenants})


def _run_probes(engine, model, opt, data, args, reps: int = 3) -> dict:
    """The two probes (the reference's ``_run_probes``): the zero-compute
    step (paper §4.4: the step *is* the exchange, so it measures pure PS
    throughput) and one full train step, each warmed once and timed
    ``reps`` times, every rep ending in a device synchronization, on
    copies of ``model`` and ``opt`` (the run's own state is untouched);
    medians.  The split is joined against the cost model's decomposition
    into the bottleneck table.  With ``--calibrate`` the model's constants
    are first solved on this card and then anchored to the zero-compute
    probe; without it they come from a saved calibration of this card in
    ``--telemetry-out``, or the table has no model."""
    import copy
    import dataclasses
    import statistics

    import torch

    from .. import telemetry
    from ..tuning.calibrate import (CARD_PROBE_ELEMS, MIN_TOLERANCE,
                                    card_base_topology, load_calibration,
                                    run_probe_programs, save_calibration,
                                    solve_topology)

    tracer = telemetry.get_tracer()
    dev = engine.device
    card = _device_name(dev)
    W = engine.comm.n_workers
    path = os.path.join(args.telemetry_out, f"calibration_{W}w.json")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def clone(tree):
        return {k: clone(v) if isinstance(v, dict) else v.clone()
                for k, v in tree.items()}

    def copies():
        return copy.deepcopy(model), clone(opt)

    calib = None
    if args.calibrate:
        probe = run_probe_programs(engine.comm, elems=CARD_PROBE_ELEMS,
                                   device=dev)
        calib = solve_topology(probe, card_base_topology(engine.comm))
        calib["card"] = card
        topo, tol = calib["topology"], calib["tolerance"]
        c = calib["constants"]
        print(f"[telemetry] calibrated on {card} ({probe['devices']} "
              f"stacked workers, {probe['elems']:,} elements a row): "
              f"bw_ici={c['bw_ici']:.4g} allreduce_factor="
              f"{c['allreduce_factor']:.3f} bw_codec={c['bw_codec']:.4g} "
              f"tol={tol:.3f} (lat_ici = lat_dcn = 0)")
    else:
        topo, tol = load_calibration(path, card=card)
        if topo is None:
            tol = MIN_TOLERANCE
            print(f"[telemetry] no calibration of {card} at {path}: the "
                  f"table keeps the measured exchange as one row "
                  f"(--calibrate solves one)")

    exchange_s = None
    try:
        zstep = engine.make_zero_compute_step()
    except ValueError:
        zstep = None                 # flat residency or fsdp_stream: none
    if zstep is not None:
        m, o = copies()
        m, o = zstep(m, o)
        sync()                       # warm
        for r in range(reps):
            with tracer.span("probe/exchange", rep=r):
                m, o = zstep(m, o)
                sync()
        del m, o
        exchange_s = statistics.median(
            rec.dur for rec in tracer.records if rec.name == "probe/exchange")

    if calib is not None:
        # anchor the level to the engine's own zero-compute probe (paper
        # §4.4): the probe programs fix the decomposition (all-reduce
        # against the ring, the codec's share), this fixes the level the
        # engine's exchange reaches
        pred0 = telemetry.predicted_phases(engine, topo)
        if exchange_s and pred0 and pred0["comm_s"] > 0:
            s = exchange_s / pred0["comm_s"]
            topo = dataclasses.replace(
                topo, bw_ici=topo.ici_bandwidth / s,
                bw_dcn=topo.dcn_bandwidth / s,
                bw_codec=(topo.bw_codec / s if topo.bw_codec else None))
            calib["topology"] = topo
            calib["anchor_scale"] = s
            calib["constants"] = {
                "bw_ici": topo.bw_ici, "bw_codec": topo.bw_codec,
                "allreduce_factor": topo.allreduce_factor}
            print(f"[telemetry] anchored to the zero-compute probe (scale "
                  f"{s:.4g}x): bw_ici={topo.bw_ici:.4g} "
                  f"bw_codec={topo.bw_codec:.4g}")
        print(f"[telemetry] calibration -> {save_calibration(calib, path)}")

    step_fn = engine.make_train_step()
    m, o = copies()
    batch = data.torch_batch(0, dev)
    m, o, _ = step_fn(m, o, batch)
    sync()                           # warm
    for r in range(reps):
        with tracer.span("probe/step", rep=r):
            m, o, _ = step_fn(m, o, batch)
            sync()
    del m, o
    step_s = statistics.median(
        rec.dur for rec in tracer.records if rec.name == "probe/step")

    predicted = (telemetry.predicted_phases(engine, topo)
                 if topo is not None else None)
    rows = telemetry.attribute_step(step_s, exchange_s, predicted)
    agreement = telemetry.model_agreement(exchange_s, predicted, tol)
    table = telemetry.format_table(
        rows, step_s, title=f"[telemetry] where did the step go on {card}")
    print(table)
    if agreement["checked"]:
        lo, hi = agreement["band"]
        print(f"[telemetry] exchange vs model: measured "
              f"{agreement['measured_s'] * 1e3:.3f} ms vs predicted "
              f"{agreement['predicted_s'] * 1e3:.3f} ms (ratio "
              f"{agreement['ratio']:.3f}, band [{lo:.3f}, {hi:.3f}]"
              + ("" if agreement["ok"] else " — OUTSIDE TOLERANCE") + ")")
    # in the trace's metadata, so launch/trace.py --check-model can check
    # the agreement again from the artifact alone
    tracer.meta["attribution"] = {
        "step_s": step_s, "exchange_s": exchange_s, "rel_tol": tol,
        "predicted": predicted, "agreement": agreement, "rows": rows,
        "topology": dataclasses.asdict(topo) if topo is not None else None,
        "calibrated": calib is not None}
    return {"rows": rows, "table": table, "agreement": agreement,
            "step_s": step_s, "exchange_s": exchange_s}


def _finish_telemetry(args, probe=None) -> None:
    """Write the run's telemetry artifacts (trace.json, metrics.jsonl,
    report.txt) under --telemetry-out; nothing when telemetry is off."""
    from .. import telemetry
    if not telemetry.enabled():
        return
    tracer, registry = telemetry.get_tracer(), telemetry.get_registry()
    out = args.telemetry_out
    os.makedirs(out, exist_ok=True)
    tracer.write(os.path.join(out, "trace.json"))
    registry.dump_jsonl(os.path.join(out, "metrics.jsonl"))
    lines = [f"telemetry report  trace_id={tracer.trace_id} "
             f"seed={tracer.seed}"]
    totals = telemetry.phase_totals(
        [r for r in tracer.records if r.step >= 0])
    n_steps = len(tracer.step_totals())
    if n_steps:
        lines.append(f"  {n_steps} steps; per-phase mean over the run:")
        for ph, s in sorted(totals.items(), key=lambda kv: -kv[1]):
            lines.append(f"    {ph:<18} {s / n_steps * 1e3:>10.3f} ms/step")
    if probe:
        lines.append(probe["table"])
        ag = probe["agreement"]
        if ag.get("checked"):
            lines.append(f"  model agreement: ratio {ag['ratio']:.3f} "
                         f"in [{ag['band'][0]:.3f}, {ag['band'][1]:.3f}] "
                         f"-> {'ok' if ag['ok'] else 'OUTSIDE TOLERANCE'}")
    ev = registry.events()
    lines.append(f"  {len(ev)} structured events; instruments: "
                 f"{', '.join(sorted(registry.snapshot())) or '(none)'}")
    with open(os.path.join(out, "report.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[telemetry] artifacts: {out}/{{trace.json, metrics.jsonl, "
          f"report.txt}}  (read with: python -m repro_torch.launch.trace "
          f"{out}/trace.json)")


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
    from .. import telemetry
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    tracer, registry = telemetry.get_tracer(), telemetry.get_registry()
    losses = {h.namespace: [] for h in handles}
    sync()
    t0 = time.perf_counter()
    for step in range(args.steps):
        registry.current_step = step
        with tracer.step(step, tenants=args.tenants):
            with tracer.span("data"):
                batches = {ns: d.torch_batch(step, device)
                           for ns, d in data.items()}
            # co_step runs under exchange/co_step, a child of this step
            models, metrics = cm.co_step(handles, models, batches)
            with tracer.span("sync"):
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
