"""Exchange autotuner entry point (``repro/launch/tune.py``, DESIGN.md
§16).

Searches (strategy x pipeline_windows x wire_format x wire_format_dcn x
chunk_size_bytes x (pods, data)) for the model's gradient tree at the
requested worker count: the cost model's ranking over the whole space,
real timed steps for the top-k and the incumbent (each candidate's
``PHubClient.push_pull`` on ``StackedComm(pods * data, pods)``, on the
card), and the rack lint's gate (R1/R3/R5) on the measured winner before
it is cached.  A second invocation with the same request hits the cache
and spends zero timed steps; ``launch/train.py --auto-tune`` consults the
same cache.

The ranking's topology comes from one of three places: ``--calibrate``
runs ``tuning/calibrate.py``'s probes on this device at the requested
worker count and saves the record beside the cache
(``calibration_{W}w.json``; on one card the cross-pod tier is the same
memory as the in-pod one, so ``bw_dcn`` is set to the measured
``bw_ici``); otherwise this device's saved calibration
for W is loaded from there; otherwise, on a cache miss, it exits with a
message naming ``--calibrate``.  There are no constants of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.tune --devices 4 \
      --arch llama3.2-1b --d-model 0 --calibrate [--top-k 3] [--steps 5]
  ... --device cpu --devices 2 --d-model 64 --calibrate   # on the CPU
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os


def model_grads_like(arch: str, d_model: int = 0):
    """(cfg, the arch's gradient tree as meta tensors): the reduced
    variant when ``d_model`` is set; nothing is allocated."""
    from ..configs import get_arch, reduced
    from ..models import param_specs
    cfg = get_arch(arch)
    if d_model:
        cfg = reduced(cfg, d_model=d_model)
    return cfg, param_specs(cfg)


def calibration_path(cache_dir: str, n_workers: int) -> str:
    return os.path.join(cache_dir, f"calibration_{n_workers}w.json")


def calibrate_topology(n_workers: int, device, cache_dir: str, say=print):
    """Run the calibration probes on ``StackedComm(n_workers)`` on
    ``device`` (``tuning.calibrate.CARD_PROBE_ELEMS`` a row), solve the
    topology from the card's base and save the record, with the device's
    name, beside the cache.  Returns the RackTopology."""
    from ..core import StackedComm
    from ..tuning.cache import device_name
    from ..tuning.calibrate import (CARD_PROBE_ELEMS, card_base_topology,
                                    run_probe_programs, save_calibration,
                                    solve_topology)
    comm = StackedComm(n_workers)
    probe = run_probe_programs(comm, elems=CARD_PROBE_ELEMS, device=device)
    calib = solve_topology(probe, card_base_topology(comm))
    # one card: a candidate's pods are rows of the same memory as its
    # in-pod workers, and the probes measure that one tier; the base's
    # bw_core is a placeholder at the HBM figure, under which cross-pod
    # bytes would be priced as nearly free
    calib["topology"] = dataclasses.replace(
        calib["topology"], bw_dcn=calib["topology"].bw_ici)
    calib["card"] = device_name(device)
    c = calib["constants"]
    say(f"[tune] calibrated on {calib['card']}: bw_ici "
        f"{c['bw_ici'] / 1e9:.1f}GB/s bw_codec {c['bw_codec'] / 1e9:.1f}GB/s "
        f"allreduce_factor {c['allreduce_factor']:.2f} (tolerance "
        f"{calib['tolerance']:.0%})")
    path = save_calibration(calib, calibration_path(cache_dir, n_workers))
    say(f"[tune] calibration -> {path}")
    return calib["topology"]


def saved_topology(n_workers: int, device, cache_dir: str):
    """This device's saved calibration for ``n_workers`` beside the cache;
    exits naming ``--calibrate`` when there is none."""
    from ..tuning.cache import device_name
    from ..tuning.calibrate import load_calibration
    path = calibration_path(cache_dir, n_workers)
    name = device_name(device)
    topo, _ = load_calibration(path, card=name)
    if topo is None:
        raise SystemExit(
            f"[tune] no calibration of {name} for {n_workers} workers at "
            f"{path}: run with --calibrate to measure one (the port ranks "
            f"on no constants of its own)")
    return topo


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8,
                    help="worker count to tune for (workers stacked on the "
                         "device)")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--d-model", type=int, default=256,
                    help="reduced d_model (0 = the full architecture)")
    ap.add_argument("--strategy", default="sharded_ps",
                    help="baseline strategy for the request cache key")
    ap.add_argument("--top-k", type=int, default=3,
                    help="analytically-ranked candidates that get real "
                         "timed steps")
    ap.add_argument("--steps", type=int, default=5,
                    help="timed reps per candidate")
    ap.add_argument("--time-all", action="store_true",
                    help="time every candidate (exhaustive sweep)")
    ap.add_argument("--force", action="store_true",
                    help="ignore the cache and re-tune")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the rack-lint gate (NOT cached as trusted)")
    ap.add_argument("--cache-dir", default="",
                    help="the winner cache (default results/torch/tuning)")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure this device's topology with the "
                         "calibration probes first and save it beside the "
                         "cache (else the saved one is used)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="", help="write the report JSON here")
    args = ap.parse_args(argv)

    from ..configs import TrainConfig
    from ..tuning import DEFAULT_CACHE_DIR, autotune

    cache_dir = args.cache_dir or DEFAULT_CACHE_DIR
    W = args.devices
    if args.calibrate:
        topo = calibrate_topology(W, args.device, cache_dir)
    else:
        def topo():
            return saved_topology(W, args.device, cache_dir)

    _, grads_like = model_grads_like(args.arch, args.d_model)
    tc = TrainConfig(strategy=args.strategy)
    report = autotune(
        grads_like, tc, W, topo=topo, top_k=args.top_k, steps=args.steps,
        cache_dir=cache_dir, force=args.force, time_all=args.time_all,
        lint=not args.no_lint, arch=args.arch, d_model=args.d_model,
        device=args.device)

    cand = report["candidate"]
    src = "cache" if report["cache_hit"] else \
        f"{report['timed_candidates']} timed candidates"
    print(f"[tune] winner ({src}): {cand['strategy']} "
          f"W={cand['pipeline_windows']} wire={cand['wire_format']}/"
          f"{cand['wire_format_dcn'] or '-'} "
          f"chunk={cand['chunk_size_bytes'] // 1024}KB "
          f"mesh={cand['pods']}x{cand['data']} "
          f"measured {report['measured_us']:.0f}us "
          f"(predicted {report['predicted']['seconds'] * 1e6:.0f}us)")
    print(f"[tune] key={report['key']} cache={report['cache_path']} "
          f"lint={'OK' if report['lint'].get('ok') else 'SKIPPED/REJECTED'}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, sort_keys=True)
        print(f"[tune] report -> {args.out}")
    return report


if __name__ == "__main__":
    main()
