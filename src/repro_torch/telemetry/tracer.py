"""Span tracing for the rack (``repro/telemetry/tracer.py``).

A ``Tracer`` records nestable host-side wall-time spans
(``time.perf_counter``) around the dispatch and synchronization points of
the training and serving stack.  A span never synchronizes the card:
PyTorch queues CUDA work and returns, so a span around a step's dispatch
measures the host's enqueue, and device completion shows up under the
next span that reads a value back (``sync``).  Spans are cheap: one
``perf_counter`` pair and a list append per span; the disabled path
(``NULL_TRACER``) is a shared no-op context manager with no allocation
per call.

Span names are slash paths (``"exchange/push_pull"``, ``"probe/step"``)
whose first component is the *phase*, the unit the per-step breakdown
and the cost-model attribution table aggregate over.  The span taxonomy
the stack emits:

  step          one training step (``Tracer.step(i)``; everything below
                nests inside it)
  data          host-side batch staging (``training/loop.fit``)
  dispatch      the step call: host enqueue, not device completion
                (fit's plain loop adds no per-step sync)
  engine/*      ``engine/dispatch``: every step function an engine or
                client hands out, nested under the caller's span
  sync          host materialization (the loss where the loop reads it;
                the supervised loop's every-step health read)
  exchange/*    push_pull / co_step (client, connection manager)
  checkpoint    durable snapshot writes
  rollback      checkpoint restore after divergence
  digest        the supervisor's health-metric digestion
  probe/*       the probes ``launch/train.py --telemetry`` runs before
                the loop: ``probe/exchange`` (the zero-compute step: pure
                exchange) and ``probe/step`` (one full step), each ending
                in a device synchronization; the measured split the
                attribution table joins against
                ``cost_model.predicted_step_seconds``
  prefill,
  decode/*      serving (``launch/serve.py``)

The tracer is *seeded*: the trace id is a pure function of the seed
(splitmix64), so two runs of the same seeded workload export traces of
one identity (the timestamps differ).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field


@dataclass
class SpanRecord:
    """One completed span, relative to the tracer's epoch (seconds)."""
    name: str
    t0: float
    dur: float
    depth: int
    step: int                       # -1 outside any step span
    parent: str                     # "" at top level
    args: dict = field(default_factory=dict)

    @property
    def phase(self) -> str:
        return self.name.split("/", 1)[0]


class _Span:
    """Re-entrant-free span context manager (one per ``span()`` call)."""
    __slots__ = ("_tr", "name", "args", "_t0")

    def __init__(self, tr: "Tracer", name: str, args: dict):
        self._tr = tr
        self.name = name
        self.args = args

    def __enter__(self):
        tr = self._tr
        tr._stack.append(self.name)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        tr = self._tr
        tr._stack.pop()
        tr.records.append(SpanRecord(
            name=self.name, t0=self._t0 - tr.epoch, dur=t1 - self._t0,
            depth=len(tr._stack), step=tr.current_step,
            parent=tr._stack[-1] if tr._stack else "",
            args=self.args))
        return False


class _StepSpan(_Span):
    """A ``step`` span: sets ``current_step`` for everything nested."""
    __slots__ = ("_prev",)

    def __enter__(self):
        self._prev = self._tr.current_step
        self._tr.current_step = self.args["step"]
        return super().__enter__()

    def __exit__(self, exc_type, exc, tb):
        out = super().__exit__(exc_type, exc, tb)
        self._tr.current_step = self._prev
        return out


class _NullSpan:
    """Shared no-op context manager — the telemetry-off fast path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class NullTracer:
    """Disabled tracer: every call is a no-op on a shared singleton."""
    enabled = False
    current_step = -1
    records: tuple = ()

    def span(self, name, **args):
        return _NULL_SPAN

    def step(self, i, **args):
        return _NULL_SPAN

    def mark(self, name, **args):
        return None


NULL_TRACER = NullTracer()


class Tracer:
    """Seeded, nestable span tracer with Chrome-trace export."""
    enabled = True

    def __init__(self, seed: int = 0, meta: dict = None):
        self.seed = int(seed)
        # deterministic identity: same seed -> same trace id (splitmix64)
        z = (self.seed + 0x9E3779B97F4A7C15) & (2**64 - 1)
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & (2**64 - 1)
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & (2**64 - 1)
        self.trace_id = f"{(z ^ (z >> 31)) & (2**64 - 1):016x}"
        self.meta = dict(meta or {})
        self.epoch = time.perf_counter()
        self.current_step = -1
        self.records: list[SpanRecord] = []
        self.marks: list[tuple] = []        # (name, t, step, args)
        self._stack: list[str] = []

    # ------------------------------------------------------------- spans

    def span(self, name: str, **args) -> _Span:
        """Context manager timing one nested span."""
        return _Span(self, name, args)

    def step(self, i: int, **args) -> _Span:
        """The per-step root span; nested spans inherit step index ``i``."""
        return _StepSpan(self, "step", {"step": int(i), **args})

    def mark(self, name: str, **args) -> None:
        """Instant event (Chrome-trace ``ph: "i"``)."""
        self.marks.append((name, time.perf_counter() - self.epoch,
                           self.current_step, args))

    # ------------------------------------------------------------ export

    def to_chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON object (``ph: "X"`` complete
        events, microsecond timestamps).  Span nesting is carried both
        by ts/dur containment and explicitly in ``args`` (step, depth,
        parent), so ``launch/trace.py`` can rebuild the per-step
        breakdown from the JSON alone."""
        events = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                   "args": {"name": "phub-rack"}}]
        for r in self.records:
            events.append({
                "name": r.name, "cat": r.phase, "ph": "X",
                "ts": round(r.t0 * 1e6, 3), "dur": round(r.dur * 1e6, 3),
                "pid": 0, "tid": 0,
                "args": {"step": r.step, "depth": r.depth,
                         "parent": r.parent, **r.args}})
        for name, t, step, args in self.marks:
            events.append({"name": name, "cat": name.split("/", 1)[0],
                           "ph": "i", "ts": round(t * 1e6, 3), "s": "t",
                           "pid": 0, "tid": 0,
                           "args": {"step": step, **args}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": {"trace_id": self.trace_id, "seed": self.seed,
                             **self.meta}}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)
        return path

    # ------------------------------------------------------------ report

    def step_phases(self) -> dict:
        """``{step: {phase: seconds}}`` over the *direct children* of
        each step span (deeper nesting is detail, not a phase — counting
        it would double-book the step).  Spans outside any step land
        under step ``-1`` (the probes, serving, setup)."""
        return step_phases(self.records)

    def step_totals(self) -> dict:
        """``{step: seconds}`` — each step span's own duration."""
        return {r.args["step"]: r.dur for r in self.records
                if r.name == "step"}


def step_phases(records) -> dict:
    """See ``Tracer.step_phases`` — also used by launch/trace.py on
    records rebuilt from an exported JSON trace."""
    out: dict = {}
    for r in records:
        if r.name == "step":
            continue
        if r.step >= 0 and r.parent != "step":
            continue                     # nested detail under a phase
        if r.step < 0 and r.parent:
            continue                     # nested detail outside steps
        out.setdefault(r.step, {})
        out[r.step][r.phase] = out[r.step].get(r.phase, 0.0) + r.dur
    return out


def phase_totals(records) -> dict:
    """``{phase: seconds}`` summed across steps (direct children only)."""
    totals: dict = {}
    for phases in step_phases(records).values():
        for ph, s in phases.items():
            totals[ph] = totals.get(ph, 0.0) + s
    return totals
