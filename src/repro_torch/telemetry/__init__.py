"""Rack telemetry: low-overhead tracing and metrics
(``repro/telemetry/__init__.py``).

One process-global pair, a span ``Tracer`` and a ``MetricsRegistry``,
installed by ``enable()`` and read by every instrumented call site through
``get_tracer()`` / ``get_registry()``.  Disabled (the default) both return
shared null singletons whose methods are no-ops: the telemetry-off path
costs one attribute load a site and launches nothing on the card.

    from repro_torch import telemetry
    telemetry.enable(seed=0)
    try:
        ...train...
        telemetry.get_tracer().write("trace.json")
        telemetry.get_registry().dump_jsonl("metrics.jsonl")
    finally:
        telemetry.disable()

``launch/train.py --telemetry`` wires this up end to end and writes the
artifacts under ``--telemetry-out``; ``launch/trace.py`` reads them back
into the per-step breakdown and the attribution table.  Unlike the
reference's launchers, the port's restore the null pair before they
return, so a caller (a test, a script) never inherits an enabled
pair.
"""
from __future__ import annotations

from .attribution import (attribute_step, format_table, model_agreement,
                          phase_fractions, predicted_phases)
from .metrics import (NULL_REGISTRY, Counter, Gauge, Histogram,
                      MetricsRegistry, NullRegistry)
from .tracer import (NULL_TRACER, NullTracer, SpanRecord, Tracer,
                     phase_totals, step_phases)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "SpanRecord",
    "MetricsRegistry", "NullRegistry", "NULL_REGISTRY",
    "Counter", "Gauge", "Histogram",
    "attribute_step", "format_table", "model_agreement",
    "phase_fractions", "predicted_phases", "phase_totals", "step_phases",
    "enable", "disable", "enabled", "get_tracer", "get_registry",
]

_tracer = NULL_TRACER
_registry = NULL_REGISTRY


def get_tracer():
    """The installed ``Tracer``, or ``NULL_TRACER`` when disabled."""
    return _tracer


def get_registry():
    """The installed ``MetricsRegistry``, or ``NULL_REGISTRY``."""
    return _registry


def enabled() -> bool:
    return _tracer is not NULL_TRACER


def enable(seed: int = 0, meta: dict = None, sink=None):
    """Install a fresh tracer + registry pair; returns ``(tracer,
    registry)``.  A second call replaces the pair: callers flush the old
    one first."""
    global _tracer, _registry
    _tracer = Tracer(seed=seed, meta=meta)
    _registry = MetricsRegistry(sink=sink)
    return _tracer, _registry


def disable():
    """Restore the null pair; returns the previous pair, which keeps its
    records."""
    global _tracer, _registry
    tr, reg = _tracer, _registry
    _tracer, _registry = NULL_TRACER, NULL_REGISTRY
    return tr, reg
