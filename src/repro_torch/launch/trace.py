"""Read a telemetry trace back into the per-step breakdown
(``repro/launch/trace.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.trace \
      results/torch/telemetry/trace.json
  ... trace.json --check-model     # enforce the cost-model agreement

Reading a trace
---------------
A trace is Chrome-trace JSON (load it in Perfetto / chrome://tracing for
the visual timeline).  Every complete event (``ph: "X"``) is one
host-side span; its ``args`` carry ``step`` (the training step it
belongs to, -1 outside any step), ``depth`` (nesting level) and
``parent`` (the enclosing span's name), so the breakdown below is
rebuilt from the JSON alone — no live process needed.

The span taxonomy (see telemetry/tracer.py): ``step`` is the per-step
root; ``data`` / ``dispatch`` / ``sync`` / ``checkpoint`` are the loop's
host phases; ``exchange/*`` is the push_pull / co_step dispatch;
``probe/exchange`` and ``probe/step`` are the two probes
``train.py --telemetry`` runs before the loop: the zero-compute exchange
(pure PS throughput, paper §4.4) and one full step, each ending in a
device synchronization.  The ``dispatch`` phase is the host's enqueue
only: a small dispatch number with a large step time means the card
finishes the work under the next sync, not that the step was cheap.

The trace format is the reference's, so either package's reader reads
either package's traces.

``--check-model`` re-verifies the cost-model agreement from the trace's
embedded metadata: the measured ``probe/exchange`` median must lie
within the calibrated tolerance band of the model's predicted exchange
time (``cost_model.predicted_step_seconds``).  Exit status 1 on
disagreement or a malformed trace, 0 otherwise.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys

from ..telemetry.tracer import SpanRecord, step_phases

# a step's direct children may overrun the step span itself by at most
# this fraction before validation flags the trace as malformed
COVERAGE_SLACK = 0.05


def load_trace(path: str):
    """Rebuild ``(records, metadata)`` from an exported Chrome trace."""
    with open(path) as f:
        doc = json.load(f)
    records = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = dict(ev.get("args", {}))
        records.append(SpanRecord(
            name=ev["name"], t0=ev["ts"] / 1e6, dur=ev["dur"] / 1e6,
            depth=int(args.pop("depth", 0)),
            step=int(args.pop("step", -1)),
            parent=args.pop("parent", ""), args=args))
    records.sort(key=lambda r: r.t0)
    return records, doc.get("metadata", {})


def validate(records) -> list[str]:
    """Structural checks over the rebuilt spans; returns issue strings
    (empty = clean).  Validates nesting consistency (depth vs parent),
    that stepped spans fall inside their step span's interval, and that
    no step's direct children overbook the step itself."""
    issues = []
    steps = {}
    for r in records:
        if r.name == "step":
            steps[r.args.get("step", r.step)] = r
        if (r.depth == 0) != (r.parent == ""):
            issues.append(f"span {r.name!r}: depth {r.depth} inconsistent "
                          f"with parent {r.parent!r}")
    eps = 1e-6
    for r in records:
        if r.name == "step" or r.step < 0:
            continue
        st = steps.get(r.step)
        if st is None:
            issues.append(f"span {r.name!r} claims step {r.step} but no "
                          f"step span exists for it")
        elif not (st.t0 - eps <= r.t0
                  and r.t0 + r.dur <= st.t0 + st.dur + eps):
            issues.append(f"span {r.name!r} (step {r.step}) lies outside "
                          f"its step span's interval")
    for i, phases in step_phases(records).items():
        if i < 0:
            continue
        st = steps.get(i)
        if st and sum(phases.values()) > st.dur * (1 + COVERAGE_SLACK):
            issues.append(f"step {i}: direct children sum to "
                          f"{sum(phases.values()) * 1e3:.3f} ms > step "
                          f"span {st.dur * 1e3:.3f} ms")
    return issues


def render_breakdown(records, meta=None) -> str:
    """The plain-text per-step breakdown + run summary."""
    per_step = step_phases(records)
    stepped = {i: p for i, p in per_step.items() if i >= 0}
    phases = sorted({ph for p in stepped.values() for ph in p})
    lines = []
    if meta:
        lines.append(f"trace {meta.get('trace_id', '?')}  "
                     f"seed={meta.get('seed', '?')} "
                     f"devices={meta.get('devices', '?')} "
                     f"strategy={meta.get('strategy', '?')}")
    totals = {r.args.get("step", r.step): r.dur for r in records
              if r.name == "step"}
    if stepped:
        hdr = "  ".join(f"{ph:>12}" for ph in phases)
        lines.append(f"{'step':>6}  {hdr}  {'total ms':>10}")
        for i in sorted(stepped):
            row = "  ".join(f"{stepped[i].get(ph, 0.0) * 1e3:>12.3f}"
                            for ph in phases)
            lines.append(f"{i:>6}  {row}  "
                         f"{totals.get(i, 0.0) * 1e3:>10.3f}")
        n = len(stepped)
        mean = "  ".join(
            f"{sum(p.get(ph, 0.0) for p in stepped.values()) / n * 1e3:>12.3f}"
            for ph in phases)
        lines.append(f"{'mean':>6}  {mean}  "
                     f"{sum(totals.values()) / max(len(totals), 1) * 1e3:>10.3f}")
    probes = {}
    for r in records:
        if r.phase == "probe":
            probes.setdefault(r.name, []).append(r.dur)
    for name in sorted(probes):
        ds = probes[name]
        lines.append(f"{name}: median {statistics.median(ds) * 1e3:.3f} ms "
                     f"over {len(ds)} reps")
    return "\n".join(lines) if lines else "(no spans)"


def check_model(records, meta) -> dict:
    """Re-verify the cost-model agreement from the trace itself: the
    measured ``probe/exchange`` median vs the embedded prediction within
    the embedded tolerance (the band ``launch/train.py`` calibrated and
    stamped into the metadata)."""
    from ..telemetry import model_agreement
    att = meta.get("attribution")
    if not att:
        return {"checked": False, "ok": False,
                "reason": "trace carries no attribution metadata (was it "
                          "recorded with --telemetry probes?)"}
    durs = [r.dur for r in records if r.name == "probe/exchange"]
    if not durs:
        return {"checked": False, "ok": False,
                "reason": "no probe/exchange spans in the trace"}
    measured = statistics.median(durs)
    return model_agreement(measured, att.get("predicted"),
                           float(att.get("rel_tol", 0.0)))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="per-step breakdown + cost-model attribution from an "
                    "exported telemetry trace",
        epilog=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace", help="trace.json written by --telemetry")
    ap.add_argument("--check-model", action="store_true",
                    help="exit 1 unless the measured exchange agrees with "
                         "the embedded cost-model prediction within the "
                         "embedded (calibrated) tolerance")
    args = ap.parse_args(argv)

    records, meta = load_trace(args.trace)
    issues = validate(records)
    print(render_breakdown(records, meta))

    att = meta.get("attribution")
    if att and att.get("rows"):
        from ..telemetry import format_table
        print(format_table(att["rows"], att.get("step_s"),
                           title="where did the step go"))
    for msg in issues:
        print(f"[trace] MALFORMED: {msg}", file=sys.stderr)

    ok = not issues
    if args.check_model:
        ag = check_model(records, meta)
        if not ag.get("checked"):
            print(f"[trace] model check impossible: {ag.get('reason')}",
                  file=sys.stderr)
            ok = False
        else:
            lo, hi = ag["band"]
            verdict = "ok" if ag["ok"] else "OUTSIDE TOLERANCE"
            print(f"[trace] model agreement: measured "
                  f"{ag['measured_s'] * 1e3:.3f} ms vs predicted "
                  f"{ag['predicted_s'] * 1e3:.3f} ms — ratio "
                  f"{ag['ratio']:.3f} in [{lo:.2f}, {hi:.2f}] -> {verdict}")
            ok = ok and ag["ok"]
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
