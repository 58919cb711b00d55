"""Cost-model attribution: "where did the step go"
(``repro/telemetry/attribution.py``).

PHub's method is characterization first (paper §2, Table 2 / Fig. 5):
decompose a training step into compute, gradient exchange, aggregation
and optimization before touching the design.  This module is that table
for a live engine: it joins *measured* phase wall times (the probe pair
``probe/step`` / ``probe/exchange``) against the cost model's
decomposition (``core/cost_model.py::predicted_step_seconds`` by tier) in
the paper's style.

The split works at two granularities:

  host-visible   compute vs exchange comes from the two probes: the
                 zero-compute step *is* the exchange (paper §4.4
                 ZeroComputeEngine), so ``compute ~ step - exchange``.
  model-scaled   inside the exchange the host cannot see the tiers or the
                 codec of one step apart: the measured exchange total is
                 apportioned over the cost model's ici/dcn/codec terms,
                 keeping their predicted ratios.  Each row reports both the
                 attributed (scaled) seconds and the raw prediction, so a
                 gap between model and measurement stays visible.

The one difference from the reference: ``predicted_phases`` needs the
caller's ``RackTopology``.  The reference falls back to its tuner's
default topology, constants fit to a CPU host; the port carries no
default topology, so an attribution on the card uses constants measured
on the card (``tuning/calibrate.py``) or none at all.
"""
from __future__ import annotations


def predicted_phases(engine, topo, compute_s: float = 0.0) -> dict:
    """``cost_model.predicted_step_seconds`` for one engine's exchange over
    the caller's ``topo``: the join key of the attribution table.  Returns
    the predicted dict plus the (strategy, windows, wire) identity it was
    computed for; None when the engine has no chunk domain (fsdp_stream),
    as the reference's.  ``topo`` None raises: the port has no default
    topology."""
    from ..core import cost_model
    if engine.chunk_plan is None:
        return None
    if topo is None:
        raise ValueError(
            "predicted_phases needs an explicit RackTopology: the port "
            "carries no default topology (the reference's is fit to a CPU "
            "host); calibrate one on this card (tuning/calibrate.py, "
            "launch/train.py --calibrate) or attribute without a model")
    pred = cost_model.predicted_step_seconds(
        engine.chunk_plan.groups, strategy=engine.tc.strategy, topo=topo,
        wire=engine.wire, wire_dcn=engine.wire_dcn,
        windows=engine.tc.pipeline_windows,
        n_workers=engine.comm.n_workers, pod_size=engine.comm.pods,
        compute_s=compute_s)
    return {"strategy": engine.tc.strategy,
            "windows": engine.tc.pipeline_windows,
            "wire": engine.tc.wire_format,
            "wire_dcn": engine.tc.wire_format_dcn,
            "n_workers": engine.comm.n_workers,
            "pod_size": engine.comm.pods, **pred}


def attribute_step(step_s: float, exchange_s: float, predicted: dict,
                   host_phases: dict = None) -> list[dict]:
    """The bottleneck table's rows.

    ``step_s``: measured full-step seconds (``probe/step``);
    ``exchange_s``: measured exchange-only seconds (``probe/exchange``),
    or None when no zero-compute probe ran (the exchange rows then carry
    the raw model prediction, flagged ``measured: False``);
    ``predicted``: ``predicted_phases`` output; ``host_phases``: extra
    measured host-side phases ({name: seconds} — checkpoint, data, ...)
    appended as their own rows.

    Rows: ``{"phase", "seconds", "fraction", "predicted_s", "measured"}``
    — ``seconds`` is attributed wall time (model ratios scaled to the
    measured exchange when available), ``fraction`` is of ``step_s``.
    """
    rows = []
    comm_pred = float(predicted["comm_s"]) if predicted else 0.0
    exch = exchange_s if exchange_s is not None else comm_pred
    measured_exch = exchange_s is not None

    tiers = []
    if predicted:
        tiers = [("exchange/ici", predicted["ici_s"]),
                 ("exchange/dcn", predicted["dcn_s"]),
                 ("exchange/codec", predicted["codec_s"])]
    scale = (exch / comm_pred) if (predicted and comm_pred > 0) else 0.0
    for name, pred_s in tiers:
        if pred_s <= 0.0:
            continue
        rows.append({"phase": name,
                     "seconds": pred_s * scale if measured_exch else pred_s,
                     "predicted_s": pred_s, "measured": False})
    if not rows and exch > 0.0:
        # no tier carried predicted time (degenerate 1-worker domain, or
        # no cost model at all) — keep the measured total visible
        rows.append({"phase": "exchange", "seconds": exch,
                     "predicted_s": comm_pred, "measured": measured_exch})

    host = dict(host_phases or {})
    host_s = sum(host.values())
    compute = max(step_s - exch - host_s, 0.0)
    rows.insert(0, {"phase": "compute", "seconds": compute,
                    "predicted_s": None, "measured": True})
    for name, s in sorted(host.items()):
        rows.append({"phase": name, "seconds": s, "predicted_s": None,
                     "measured": True})
    total = max(step_s, 1e-12)
    for r in rows:
        r["fraction"] = r["seconds"] / total
    return rows


def phase_fractions(rows) -> dict:
    """``{phase: fraction-of-step}``, rounded to 4 places."""
    return {r["phase"]: round(r["fraction"], 4) for r in rows}


def model_agreement(exchange_s: float, predicted: dict,
                    rel_tol: float) -> dict:
    """Measured exchange total vs ``predicted_step_seconds`` comm time,
    within the calibrated model's stated tolerance: the ratio must lie
    in ``[1/(1+rel_tol), 1+rel_tol]``."""
    comm = float(predicted["comm_s"]) if predicted else 0.0
    if exchange_s is None or comm <= 0.0:
        return {"checked": False, "ok": True}
    ratio = exchange_s / comm
    lo, hi = 1.0 / (1.0 + rel_tol), 1.0 + rel_tol
    return {"checked": True, "ok": lo <= ratio <= hi, "ratio": ratio,
            "measured_s": exchange_s, "predicted_s": comm,
            "rel_tol": rel_tol, "band": [lo, hi]}


def format_table(rows, step_s: float = None, title: str = None) -> str:
    """Plain-text bottleneck table (the paper's Table 2 / Fig. 5 style:
    phases down, time and share across)."""
    lines = [title or "where did the step go"]
    if step_s is not None:
        lines[0] += f"  (step {step_s * 1e3:.2f} ms)"
    lines.append(f"  {'phase':<18} {'ms':>10} {'share':>7} "
                 f"{'model ms':>10}")
    for r in rows:
        pred = ("-" if r.get("predicted_s") is None
                else f"{r['predicted_s'] * 1e3:.3f}")
        tag = "" if r.get("measured", True) else "  (model-scaled)"
        lines.append(f"  {r['phase']:<18} {r['seconds'] * 1e3:>10.3f} "
                     f"{r['fraction']:>6.1%} {pred:>10}{tag}")
    return "\n".join(lines)
