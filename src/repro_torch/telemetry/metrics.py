"""Typed metrics registry with structured JSONL emission
(``repro/telemetry/metrics.py``).

Three instrument kinds, all label-aware:

  Counter    monotone accumulation (exchange bytes by tenant and basis,
             watchdog retries, supervisor demotions and rollbacks)
  Gauge      last-write-wins level (membership epoch)
  Histogram  streaming distribution summary (serving latencies)

plus structured *events*: a (name, step, payload) record kept in memory
(queryable from tests via ``events(name=...)``) and appended to the JSONL
stream (membership transitions, rebalances, the supervisor's incidents,
watchdog retries).

One line per emission, one schema for everything::

  {"kind": "counter"|"gauge"|"histogram"|"event", "name": ...,
   "labels": {...}, "value": ... | "payload": {...}, "step": ...,
   "t": seconds-since-registry-epoch}

The disabled path (``NULL_REGISTRY``) hands out shared no-op instruments:
an uninstrumented run pays one attribute load and one no-op call a site.
"""
from __future__ import annotations

import json
import time


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


class Counter:
    __slots__ = ("name", "registry", "_values")
    kind = "counter"

    def __init__(self, name: str, registry: "MetricsRegistry"):
        self.name = name
        self.registry = registry
        self._values: dict = {}

    def inc(self, value: float = 1.0, **labels) -> float:
        k = _label_key(labels)
        v = self._values.get(k, 0.0) + value
        self._values[k] = v
        self.registry._emit({"kind": "counter", "name": self.name,
                             "labels": labels, "value": v, "delta": value})
        return v

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def snapshot(self) -> dict:
        return {json.dumps(dict(k), sort_keys=True): v
                for k, v in self._values.items()}


class Gauge:
    __slots__ = ("name", "registry", "_values")
    kind = "gauge"

    def __init__(self, name: str, registry: "MetricsRegistry"):
        self.name = name
        self.registry = registry
        self._values: dict = {}

    def set(self, value: float, **labels) -> float:
        self._values[_label_key(labels)] = value
        self.registry._emit({"kind": "gauge", "name": self.name,
                             "labels": labels, "value": value})
        return value

    def value(self, **labels):
        return self._values.get(_label_key(labels))

    def snapshot(self) -> dict:
        return {json.dumps(dict(k), sort_keys=True): v
                for k, v in self._values.items()}


class Histogram:
    """Streaming summary: count/sum/min/max plus fixed bucket counts."""
    __slots__ = ("name", "registry", "buckets", "_stats")
    kind = "histogram"
    DEFAULT_BUCKETS = (1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0)

    def __init__(self, name: str, registry: "MetricsRegistry",
                 buckets=None):
        self.name = name
        self.registry = registry
        self.buckets = tuple(buckets or self.DEFAULT_BUCKETS)
        self._stats: dict = {}

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        st = self._stats.get(k)
        if st is None:
            st = {"count": 0, "sum": 0.0, "min": value, "max": value,
                  "bucket_counts": [0] * (len(self.buckets) + 1)}
            self._stats[k] = st
        st["count"] += 1
        st["sum"] += value
        st["min"] = min(st["min"], value)
        st["max"] = max(st["max"], value)
        for i, edge in enumerate(self.buckets):
            if value <= edge:
                st["bucket_counts"][i] += 1
                break
        else:
            st["bucket_counts"][-1] += 1
        self.registry._emit({"kind": "histogram", "name": self.name,
                             "labels": labels, "value": value})

    def summary(self, **labels) -> dict:
        st = self._stats.get(_label_key(labels))
        if st is None:
            return {"count": 0, "sum": 0.0}
        mean = st["sum"] / max(st["count"], 1)
        return {**st, "mean": mean, "buckets": self.buckets}

    def snapshot(self) -> dict:
        return {json.dumps(dict(k), sort_keys=True): dict(v)
                for k, v in self._stats.items()}


class _NullInstrument:
    """Shared do-nothing instrument for the disabled registry."""
    __slots__ = ()
    name = ""

    def inc(self, value: float = 1.0, **labels) -> float:
        return 0.0

    def set(self, value: float, **labels) -> float:
        return value

    def observe(self, value: float, **labels) -> None:
        return None

    def value(self, **labels) -> float:
        return 0.0

    def summary(self, **labels) -> dict:
        return {"count": 0, "sum": 0.0}


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled registry: shared no-op instruments, no storage."""
    enabled = False

    def counter(self, name: str):
        return _NULL_INSTRUMENT

    def gauge(self, name: str):
        return _NULL_INSTRUMENT

    def histogram(self, name: str, buckets=None):
        return _NULL_INSTRUMENT

    def event(self, name: str, step: int = None, **payload) -> None:
        return None

    def events(self, name: str = None) -> list:
        return []

    def snapshot(self) -> dict:
        return {}


NULL_REGISTRY = NullRegistry()


class MetricsRegistry:
    """Instrument factory + event store + JSONL sink.

    ``sink``: an optional open file-like object; every emission is
    written as one JSON line immediately (so a crashed run still has its
    metrics).  Without a sink the registry accumulates in memory and
    ``dump_jsonl`` replays the full emission log.
    """
    enabled = True

    def __init__(self, sink=None):
        self.epoch = time.perf_counter()
        self._instruments: dict = {}
        self._events: list[dict] = []
        self._log: list[dict] = []
        self._sink = sink
        self.current_step = -1          # launchers may sync this to steps

    # -------------------------------------------------------- factories

    def _get(self, name: str, cls, **kwargs):
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(name, self, **kwargs)
            self._instruments[name] = inst
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} is a {inst.kind}, not a "
                            f"{cls.kind}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, buckets=None) -> Histogram:
        h = self._instruments.get(name)
        if h is None:
            return self._get(name, Histogram, buckets=buckets)
        if not isinstance(h, Histogram):
            raise TypeError(f"metric {name!r} is a {h.kind}, not a "
                            f"histogram")
        return h

    # ----------------------------------------------------------- events

    def event(self, name: str, step: int = None, **payload) -> dict:
        """Structured incident record (demote, rollback, stall, ...)."""
        rec = {"name": name, "step": self.current_step if step is None
               else step, "payload": payload}
        self._events.append(rec)
        self._emit({"kind": "event", **rec})
        return rec

    def events(self, name: str = None) -> list[dict]:
        if name is None:
            return list(self._events)
        return [e for e in self._events if e["name"] == name]

    # --------------------------------------------------------- emission

    def _emit(self, line: dict) -> None:
        line = {**line, "t": round(time.perf_counter() - self.epoch, 6)}
        if "step" not in line:
            line["step"] = self.current_step
        self._log.append(line)
        if self._sink is not None:
            self._sink.write(json.dumps(line, sort_keys=True,
                                        default=_jsonable) + "\n")

    def dump_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for line in self._log:
                f.write(json.dumps(line, sort_keys=True,
                                   default=_jsonable) + "\n")
        return path

    def snapshot(self) -> dict:
        """All instruments' current values, by name — the end-of-run
        summary the launchers print and embed in provenance records."""
        return {name: {"kind": inst.kind, **({"values": inst.snapshot()})}
                for name, inst in sorted(self._instruments.items())}


def _jsonable(o):
    """Best-effort coercion for numpy and 0-dim tensor scalars riding
    event payloads."""
    for attr in ("item", "tolist"):
        fn = getattr(o, attr, None)
        if fn is not None:
            return fn()
    return str(o)
