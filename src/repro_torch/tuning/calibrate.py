"""A rack's ``RackTopology`` calibrated from probe steps
(``repro/tuning/calibrate.py``).

The cost model (``core/cost_model.py::predicted_step_seconds``) prices an
exchange by its link bytes over a bandwidth, its launches times a latency
and its codec bytes over a codec rate.  This module measures those rates:
three probe steps over one synthetic chunk domain, each a standalone
``PHubClient.push_pull`` of a ``(W, elems)`` f32 push
(``run_probe_programs``):

  ring       the identity exchange under ``sharded_ps``: its time is link
             bytes (and launches), which solves ``bw_ici``;
  allreduce  the same payload under ``allreduce``: its time against the
             ring's solves ``allreduce_factor`` (how many passes over the
             buffer the all-reduce really costs);
  int8       the int8-encoded ring over the same payload: its time less
             the now-known link term is codec work, which solves
             ``bw_codec`` (raw bytes/s through quantize and dequantize).

The solver (``solve_topology``) is arithmetic over the cost model's
coefficients (bytes, launches and codec bytes are linear in the unknowns)
and needs no device.  Its result carries a stated tolerance: the relative
band within which the calibrated model's exchange predictions are
trusted, at least ``MIN_TOLERANCE`` and widened by the probes' own
rep-to-rep spread and residuals; ``launch/trace.py --check-model``
enforces that band.

The differences from the reference: the probes run on the port's
``PHubClient`` over any ``Comm`` (on one card a ``StackedComm``: the
workers are rows of one tensor, so the "ICI" these probes measure is the
card's memory carrying the exchange's kernels, not a network); the
``base`` topology is required (the reference falls back to its tuner's
default, constants fit to a CPU host: the port has none,
``card_base_topology`` builds the launcher's base from the card's own
HBM figure); and there is no subprocess probe (the reference's exists
for its forced host devices).
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from types import SimpleNamespace

import torch

from ..core import cost_model
from ..core.cost_model import RackTopology

# trust band floor, the reference's: predictions within [1/(1+tol), 1+tol]
# of measurement
MIN_TOLERANCE = 0.35

PROBE_FLAVORS = ("ring", "allreduce", "int8")

# the probes' elements a worker row on the card: (W, 2^26) f32 is 1 GiB of
# pushes at W = 4, so each probe step moves gigabytes and lasts over a
# millisecond on an H100 (a smaller probe times launches, not bandwidth)
CARD_PROBE_ELEMS = 1 << 26

# NVIDIA H100 SXM data sheet: HBM3 at 3.35 TB/s
H100_HBM_BYTES_PER_S = 3.35e12


def _probe_tc(flavor: str, chunk_kb: int):
    from ..configs import TrainConfig
    if flavor == "ring":
        return TrainConfig(strategy="sharded_ps",
                           chunk_size_bytes=chunk_kb * 1024)
    if flavor == "allreduce":
        return TrainConfig(strategy="allreduce",
                           chunk_size_bytes=chunk_kb * 1024)
    if flavor == "int8":
        return TrainConfig(strategy="sharded_ps", wire_format="int8",
                           chunk_size_bytes=chunk_kb * 1024)
    raise ValueError(f"unknown probe flavor {flavor!r}")


def card_base_topology(comm) -> RackTopology:
    """The base ``solve_topology`` starts from on one card: the comm's W
    workers as ``pods`` racks of W/P, every bandwidth at the card's HBM
    rate (placeholders the solver replaces), and no launch latency
    (``lat_ici = lat_dcn = 0``: the probes are bandwidth-sized, and a
    latency fit would need a size sweep)."""
    P, hbm = comm.pods, H100_HBM_BYTES_PER_S
    return RackTopology(n_workers_per_rack=comm.n_workers // P, n_racks=P,
                        bw_worker=hbm, bw_pbox=hbm, bw_core=hbm,
                        lat_ici=0.0, lat_dcn=0.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_probe_programs(comm, *, elems: int = CARD_PROBE_ELEMS,
                       chunk_kb: int = 32, reps: int = 5, warmup: int = 2,
                       device="cuda") -> dict:
    """Time the three probe flavors on ``comm`` (a ``StackedComm``: its W
    workers' pushes are one ``(W, elems)`` tensor on ``device``).  Each
    rep is one ``push_pull`` between two synchronizations of the card.
    The pushes and the parameters are drawn on the device from seed 0.
    Returns the record ``solve_topology`` consumes, the reference's
    schema::

      {"devices": W, "elems": E, "chunk_kb": K,
       "flavors": {flavor: {"us": median, "us_reps": [...],
                            "groups": [{padded, shard_len, chunk_elems,
                                        n_shards, dtype}, ...]}}}
    """
    from ..core import PHubClient
    from ..core.chunking import dtype_name

    device = torch.device(device)
    W, E = comm.n_workers, int(elems)
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    grads = torch.randn((W, E), generator=gen, device=device)
    params = torch.randn((E,), generator=gen, device=device)
    like = {"w": torch.empty((E,), device="meta")}
    out = {"devices": W, "elems": E, "chunk_kb": int(chunk_kb),
           "flavors": {}}
    for flavor in PROBE_FLAVORS:
        client = PHubClient(_probe_tc(flavor, chunk_kb), comm,
                            device=device).register(like)
        pv, opt = {"w": params.clone()}, client.init_state()
        push = {"w": grads}
        for _ in range(warmup):
            pv, opt = client.push_pull(push, pv, opt)
        _sync(device)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            pv, opt = client.push_pull(push, pv, opt)
            _sync(device)
            ts.append(time.perf_counter() - t0)
        ts.sort()
        out["flavors"][flavor] = {
            "us": ts[len(ts) // 2] * 1e6,
            "us_reps": [t * 1e6 for t in ts],
            "groups": [{"padded": g.padded, "shard_len": g.shard_len,
                        "chunk_elems": g.chunk_elems,
                        "n_shards": g.n_shards, "dtype": dtype_name(g.dtype)}
                       for g in client.plan.groups]}
        del client, pv, opt
    return out


def _groups(meas: dict) -> list:
    """Duck-typed chunk groups from a probe record's geometry dicts (the
    cost model reads padded / shard_len / chunk_elems / n_shards / dtype
    and the derived chunks_per_shard)."""
    out = []
    for g in meas["groups"]:
        ns = SimpleNamespace(**g)
        ns.dtype = getattr(torch, g["dtype"])
        ns.chunks_per_shard = ns.shard_len // ns.chunk_elems
        out.append(ns)
    return out


def _flavor_wire(flavor: str):
    if flavor == "int8":
        from ..core.wire import WireFormat
        return WireFormat("int8")
    return None


def _predict(flavor: str, meas: dict, n_devices: int,
             topo: RackTopology) -> dict:
    tc = _probe_tc(flavor, 32)
    return cost_model.predicted_step_seconds(
        _groups(meas), strategy=tc.strategy, topo=topo,
        wire=_flavor_wire(flavor), windows=1, n_workers=n_devices,
        pod_size=1)


def _coeffs(flavor: str, meas: dict, n_devices: int,
            base: RackTopology) -> dict:
    """Linear coefficients of the flavor's predicted time in the unknowns:
    ICI runtime bytes, sequential launches, raw codec bytes
    (``predicted_step_seconds`` reports bytes *unscaled* by
    ``allreduce_factor``: the factor is solved for, not assumed)."""
    pred = _predict(flavor, meas, n_devices, base)
    return {"bytes": pred["bytes"]["ici"],
            "launches": pred["launches"]["ici"],
            "codec_bytes": pred["codec_bytes"]}


def solve_topology(probe: dict, base: RackTopology) -> dict:
    """Probe measurements -> calibrated ``RackTopology`` (pure arithmetic).

    Sequential elimination, one flavor's timing a step: ``bw_ici`` from
    the identity ring, ``allreduce_factor`` from the all-reduce flavor of
    the same payload, ``bw_codec`` from the int8 ring's residual after the
    link term.  The latencies stay at ``base``'s (required: the port has
    no default topology).

    Returns ``{"topology", "constants", "tolerance", "residuals", "probe",
    "base"}``; ``tolerance`` is the stated relative trust band (module
    docstring)."""
    if base is None:
        raise ValueError(
            "solve_topology needs an explicit base RackTopology: the port "
            "carries no default topology (card_base_topology builds one "
            "from the card's HBM figure)")
    n = probe["devices"]
    eps = 1e-9
    f = probe["flavors"]

    c_ring = _coeffs("ring", f["ring"], n, base)
    t_ring = f["ring"]["us"] / 1e6
    link_s = max(t_ring - c_ring["launches"] * base.lat_ici, eps)
    # clamp: a latency-dominated probe (tiny payload) pins link_s at the
    # floor and would report absurd bandwidth; the residuals and the
    # tolerance then show the misfit instead of the constants hiding it
    bw_ici = min(max(c_ring["bytes"] / link_s, 1e5), 1e13)

    c_ar = _coeffs("allreduce", f["allreduce"], n, base)
    t_ar = f["allreduce"]["us"] / 1e6
    ar_link_s = max(t_ar - c_ar["launches"] * base.lat_ici, eps)
    factor = ar_link_s * bw_ici / max(c_ar["bytes"], eps)
    factor = min(max(factor, 1.0), 4.0)

    c_i8 = _coeffs("int8", f["int8"], n, base)
    t_i8 = f["int8"]["us"] / 1e6
    codec_s = (t_i8 - c_i8["bytes"] / bw_ici
               - c_i8["launches"] * base.lat_ici)
    # a residual at or below zero means the codec is free at this probe
    # size: keep it priced but effectively free rather than None
    bw_codec = (c_i8["codec_bytes"] / codec_s if codec_s > eps
                else 1e15)
    bw_codec = min(max(bw_codec, 1e5), 1e15)

    topo = dataclasses.replace(base, bw_ici=bw_ici, bw_codec=bw_codec,
                               allreduce_factor=factor)

    # residual check: each probe predicted again with the calibrated topology
    residuals = {}
    spread = 0.0
    for flavor in PROBE_FLAVORS:
        pred = _predict(flavor, f[flavor], n, topo)
        meas_s = f[flavor]["us"] / 1e6
        residuals[flavor] = {
            "measured_s": meas_s, "predicted_s": pred["seconds"],
            "rel_err": abs(meas_s - pred["seconds"]) / max(meas_s, eps)}
        reps = f[flavor].get("us_reps") or [f[flavor]["us"]]
        med = sorted(reps)[len(reps) // 2]
        if med > 0:
            spread = max(spread, (max(reps) - min(reps)) / med)
    tolerance = max(MIN_TOLERANCE,
                    2.0 * spread,
                    3.0 * max(r["rel_err"] for r in residuals.values()))

    return {"topology": topo,
            "constants": {"bw_ici": bw_ici, "bw_codec": bw_codec,
                          "allreduce_factor": factor},
            "tolerance": round(tolerance, 4),
            "residuals": residuals,
            "probe": probe,
            "base": base}


def calibrate(comm, *, base: RackTopology, elems: int = CARD_PROBE_ELEMS,
              chunk_kb: int = 32, reps: int = 5, device="cuda",
              runner=None) -> dict:
    """Measure and solve.  ``runner`` (injectable) returns a probe record;
    the default times the probes on ``comm`` on ``device``."""
    runner = runner or (lambda: run_probe_programs(
        comm, elems=elems, chunk_kb=chunk_kb, reps=reps, device=device))
    return solve_topology(runner(), base)


def calibration_record(result: dict) -> dict:
    """JSON-able record (topologies as plain dicts): the reference's keys,
    plus the ``base`` the solver started from (its latencies are the
    record's) and the ``card`` it was measured on, when the caller set
    ``result["card"]``."""
    rec = {"constants": result["constants"],
           "tolerance": result["tolerance"],
           "residuals": result["residuals"],
           "topology": dataclasses.asdict(result["topology"]),
           "anchor_scale": result.get("anchor_scale"),
           "devices": result["probe"]["devices"],
           "elems": result["probe"]["elems"]}
    if result.get("base") is not None:
        rec["base"] = dataclasses.asdict(result["base"])
    if result.get("card") is not None:
        rec["card"] = result["card"]
    return rec


def save_calibration(result: dict, path: str) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fh:
        json.dump(calibration_record(result), fh, indent=1, sort_keys=True)
    return path


def load_calibration(path: str, card: str | None = None):
    """``(RackTopology, tolerance)`` from a saved record, or ``(None,
    None)`` when it is absent or unreadable, or when ``card`` is given and
    the record was measured on another card."""
    try:
        with open(path) as fh:
            rec = json.load(fh)
        if card is not None and rec.get("card") != card:
            return None, None
        return RackTopology(**rec["topology"]), float(rec["tolerance"])
    except (OSError, ValueError, KeyError, TypeError):
        return None, None
