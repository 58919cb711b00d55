"""The exchange autotuner (``repro/tuning/tuner.py``, DESIGN.md §16).

``autotune`` turns a gradient tree and a worker count into a lint-green
exchange config in three stages, each strictly cheaper than the next is
expensive:

  1. *Analytic ranking* -- every valid point of the search space
     (tuning/space.py) is priced with the two-tier cost model
     (tuning/cost.py) on a measured topology.  Pure arithmetic, no
     device.
  2. *Measured validation* -- only the analytic top-k (and always the
     incumbent, the caller's own config) get real timed steps: the
     candidate's ``PHubClient.push_pull`` on its ``StackedComm(pods *
     data, pods)``, on the caller's device (``time_candidate``).
  3. *Lint gating* -- the measured winner must pass the rack lint's R1,
     R3 and R5 (``analysis/rules.py``) before it is cached or returned; a
     rejected winner falls through to the next-fastest measured
     candidate, and if every timed candidate is rejected, or none times,
     the tune *fails* rather than returning an unvetted config.

Winners are cached keyed by the request (tuning/cache.py); a cache hit
spends zero timed steps.

The differences from the reference: a candidate is timed and linted in
this process, on the caller's device, one after another (the reference
runs each in a subprocess with its own forced host devices; one card has
no such thing), each candidate's client, gradient rows, slots and drawn
tensors released before the next is built; the ranking's topology has no
default (``topo``: a ``RackTopology``, or a function that returns one,
called on a cache miss only).
"""
from __future__ import annotations

import statistics
import time

import torch

from .cache import (DEFAULT_CACHE_DIR, cache_key, cache_path, device_name,
                    load_cached, store_winner)
from .cost import rank_candidates
from .space import Candidate, enumerate_space, valid


def _draw(tree: dict, lead: tuple, gen, device) -> dict:
    """Standard normal leaves shaped ``lead + leaf.shape`` in the leaf's
    dtype, drawn in the reference's (sorted-key) order."""
    return {k: (_draw(v, lead, gen, device) if isinstance(v, dict) else
                torch.randn(lead + tuple(v.shape), generator=gen,
                            device=device).to(v.dtype))
            for k, v in sorted(tree.items())}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_candidate(like: dict, c: Candidate, *, steps: int = 5,
                   warmup: int = 2, device="cuda") -> float:
    """Median µs a step of the candidate's real program (the reference's
    ``tuner_candidate``): ``PHubClient(tc, context_for(c))``
    registered over ``like`` (a nested dict of meta tensors), gradients
    (W, *shape) and parameters drawn from ``torch.Generator`` seed 0 on
    ``device``, ``push_pull`` ``warmup`` then ``steps`` times, each ending
    in a device synchronization.  Everything it allocated is released
    before it returns."""
    from ..configs import TrainConfig
    from ..core import PHubClient
    from .cost import context_for

    device = torch.device(device)
    tc = TrainConfig(**c.tc_kwargs())
    client = PHubClient(tc, context_for(c), device=device).register(like)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    grads = _draw(like, (c.n_workers,), gen, device)
    params = _draw(like, (), gen, device)
    opt = client.init_state()
    try:
        for _ in range(warmup):
            params, opt = client.push_pull(grads, params, opt)
            _sync(device)
        ts = []
        for _ in range(steps):
            t0 = time.perf_counter()
            params, opt = client.push_pull(grads, params, opt)
            _sync(device)
            ts.append(time.perf_counter() - t0)
    finally:
        client.release_buffers()
        del client, grads, params, opt
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return statistics.median(ts) * 1e6


def lint_candidate(c: Candidate, *, arch: str = None, d_model: int = None,
                   device="cuda") -> dict:
    """The rack lint's verdict (R1/R3/R5) for the candidate: one recorded
    zero-compute step of its engine on ``device`` (``analysis.
    lint_tuned_config``; no arch lints the reduced llama3.2-1b, d_model 0
    the full width).  ``ok`` False means rejected; a lint that raises is
    a rejection too."""
    from ..analysis import lint_tuned_config
    cand = c.to_dict()
    if arch:
        cand["arch"] = arch
    if d_model:
        cand["d_model"] = d_model
    try:
        verdict, _ = lint_tuned_config(cand, device=device)
    except Exception as e:                          # fail closed
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        return {"ok": False, "candidate": cand,
                "errors": [{"message": f"lint crashed: {e!r}"}]}
    return verdict


def _incumbent(tc, n_devices: int):
    """The caller's baseline config as a Candidate on one pod, or None
    when it needs a layout one pod cannot express (a hierarchical
    baseline)."""
    c = Candidate(strategy=tc.strategy,
                  pipeline_windows=tc.pipeline_windows,
                  wire_format=tc.wire_format or "identity",
                  wire_format_dcn=tc.wire_format_dcn,
                  chunk_size_bytes=tc.chunk_size_bytes,
                  pods=1, data=n_devices)
    return c if valid(c, n_devices) else None


def autotune(grads_like, tc, n_devices: int, *, topo=None, top_k: int = 3,
             steps: int = 5, warmup: int = 2, cache_dir: str = None,
             force: bool = False, time_all: bool = False, lint: bool = True,
             arch: str = None, d_model: int = None, device="cuda",
             timer=None, linter=None, candidates=None, log=print) -> dict:
    """Search -> rank -> time -> lint-gate -> cache.  Returns a report:

      key, cache_path, cache_hit, timed_candidates, candidate (the
      winner's dict), predicted (cost-model row), measured_us, lint
      (verdict), devices, device (what the timings ran on), steps,
      leaderboard ([{candidate, predicted_s, us}] measured order),
      rejected ([{candidate, lint}] lint-rejected faster candidates).

    ``grads_like``: a nested dict of (meta) tensors; ``topo``: the
    ``RackTopology`` to rank on, or a function returning one (called on a
    miss only), required on a miss.  ``timer``/``linter`` default to
    ``time_candidate`` / ``lint_candidate`` on ``device``; tests inject
    fakes.  ``time_all`` times every ranked candidate instead of the
    analytic top-k; ``candidates`` overrides the enumerated space.
    ``lint=False`` skips the gate: the fastest timed candidate wins, and
    its entry is stored with ``lint.ok`` False, so it is never trusted."""
    from ..telemetry import get_registry
    cache_dir = cache_dir or DEFAULT_CACHE_DIR
    dev_name = device_name(device)
    key = cache_key(tc, n_devices, grads_like, dev_name)
    if not force:
        entry = load_cached(key, cache_dir)
        if entry is not None:
            get_registry().counter("tuner.cache_hit").inc(key=key)
            return {**entry, "key": key, "cache_hit": True,
                    "timed_candidates": 0,
                    "cache_path": cache_path(key, cache_dir)}
    get_registry().counter("tuner.cache_miss").inc(key=key)

    timer = timer or (lambda c: time_candidate(
        grads_like, c, steps=steps, warmup=warmup, device=device))
    linter = linter or (lambda c: lint_candidate(
        c, arch=arch, d_model=d_model, device=device))
    if callable(topo):
        topo = topo()

    ranked = rank_candidates(
        grads_like,
        candidates if candidates is not None else
        enumerate_space(n_devices), topo)
    if not ranked:
        raise ValueError(f"no valid candidates for {n_devices} devices")
    to_time = list(ranked if time_all else ranked[:top_k])
    # always time the incumbent -- the config the caller would run without
    # the tuner.  If the cost model misprices it out of the top-k (the
    # classic autotuner failure: a modeling gap crowning a config slower
    # than the default), the measured comparison still catches it.
    incumbent = _incumbent(tc, n_devices)
    if incumbent is not None and \
            all(c != incumbent for c, _ in to_time):
        match = [cp for cp in ranked if cp[0] == incumbent]
        to_time.extend(match or rank_candidates(grads_like, [incumbent],
                                                topo))
    log(f"[tune] {len(ranked)} candidates ranked, timing "
        f"{len(to_time)} (top_k={'all' if time_all else top_k})")

    timed = []
    for c, pred in to_time:
        try:
            us = timer(c)
        except RuntimeError as e:
            log(f"[tune] timing failed for {c}: {e}")
            if torch.device(device).type == "cuda":
                torch.cuda.empty_cache()
            continue
        log(f"[tune] {c.strategy} W={c.pipeline_windows} "
            f"wire={c.wire_format}/{c.wire_format_dcn or '-'} "
            f"chunk={c.chunk_size_bytes // 1024}KB mesh={c.pods}x{c.data}"
            f": predicted {pred['seconds'] * 1e6:.0f}us measured {us:.0f}us")
        timed.append((c, pred, us))
    if not timed:
        raise RuntimeError("every candidate failed to time")
    timed.sort(key=lambda t: t[2])

    rejected = []
    winner = None
    for c, pred, us in timed:
        verdict = linter(c) if lint else {"ok": True, "skipped": True}
        if verdict.get("ok"):
            winner = (c, pred, us, verdict)
            break
        log(f"[tune] lint REJECTED {c}: "
            f"{len(verdict.get('errors', []))} errors")
        rejected.append({"candidate": c.to_dict(), "lint": verdict})
    if winner is None:
        raise RuntimeError(
            f"all {len(timed)} timed candidates were lint-rejected; "
            "refusing to return an unvetted config")

    c, pred, us, verdict = winner
    if not lint:
        # an unlinted winner is stored as untrusted: the next request
        # misses and tunes again
        verdict = {"ok": False, "skipped": True, "errors": []}
    entry = {
        "candidate": c.to_dict(),
        "predicted": pred,
        "measured_us": us,
        "lint": verdict,
        "devices": n_devices,
        "device": dev_name,
        "steps": steps,
        "leaderboard": [{"candidate": cc.to_dict(),
                         "predicted_s": pp["seconds"], "us": uu}
                        for cc, pp, uu in timed],
        "rejected": rejected,
    }
    path = store_winner(key, entry, cache_dir)
    return {**entry, "key": key, "cache_hit": False,
            "timed_candidates": len(timed), "cache_path": path}
