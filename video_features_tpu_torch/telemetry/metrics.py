"""Thread-safe in-process metrics registry: counters, gauges, histograms
(port of ``video_features_tpu/telemetry/metrics.py``).

Where the stage profiler (``utils/profiling.py``) says where one run's wall
time went, the registry accumulates *series*: labelled counters (failures
by category, retries, quarantine skips, cache hits), gauges (videos/s,
uptime, fan-out queue depth) and fixed-bucket histograms (decode / h2d /
forward / write latencies, per-video wall time, processed fps). They go
into the run manifest and render as a Prometheus textfile
(:func:`prometheus_text`).

In order: one dict lookup and one small lock per update (the stage hook
fires per decoded frame); no dependencies (the text exposition format is a
few lines to emit); and :meth:`MetricsRegistry.to_dict` is plain JSON that
round-trips through the manifest, so a finished (or dead) run's metrics
re-render from its artifacts alone.
"""
from __future__ import annotations

import bisect
import threading
from typing import Dict, List, Optional, Sequence, Tuple

#: default latency buckets (seconds) — spans decode-of-one-frame (~ms)
#: through a whole long-video forward (~minutes)
LATENCY_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

#: frames-per-second buckets for decode/processing-rate histograms
FPS_BUCKETS: Tuple[float, ...] = (
    1.0, 2.0, 5.0, 10.0, 15.0, 24.0, 30.0, 60.0, 120.0, 240.0, 480.0)

LabelItems = Tuple[Tuple[str, str], ...]


class _Metric:
    kind = "?"

    def __init__(self, name: str, labels: LabelItems) -> None:
        self.name = name
        self.labels = labels
        self._lock = threading.Lock()


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, labels: LabelItems) -> None:
        super().__init__(name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: inc({n}) must be >= 0")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, labels: LabelItems) -> None:
        super().__init__(name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative on export, like Prometheus):
    ``observe(v)`` lands in the first bucket with ``v <= le``; the
    implicit ``+Inf`` bucket catches the rest."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelItems,
                 buckets: Sequence[float] = LATENCY_BUCKETS) -> None:
        super().__init__(name, labels)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name}: need at least one bucket")
        self.buckets = bs
        self._counts = [0] * (len(bs) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    def snapshot(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            s, c = self._sum, self._count
        return {"buckets": [{"le": le, "count": n}
                            for le, n in zip(self.buckets, counts)],
                "inf_count": counts[-1], "sum": s, "count": c}


class MetricsRegistry:
    """Get-or-create registry keyed by (name, labels); name collisions
    across metric kinds are programming errors and raise."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, LabelItems], _Metric] = {}
        self._kinds: Dict[str, str] = {}

    def _get(self, cls, name: str, labels: dict, **kwargs) -> _Metric:
        items: LabelItems = tuple(sorted(
            (str(k), str(v)) for k, v in labels.items()))
        key = (name, items)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                seen = self._kinds.get(name)
                if seen is not None and seen != cls.kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {seen}, "
                        f"requested {cls.kind}")
                m = self._metrics[key] = cls(name, items, **kwargs)
                self._kinds[name] = cls.kind
            elif not isinstance(m, cls):
                raise ValueError(f"metric {name!r} is a {m.kind}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Optional[Sequence[float]] = None,
                  **labels) -> Histogram:
        if buckets is None:
            return self._get(Histogram, name, labels)
        return self._get(Histogram, name, labels, buckets=buckets)

    def to_dict(self) -> dict:
        """JSON-safe dump of every series — the manifest's ``metrics``
        field, and the input of :func:`prometheus_text`."""
        with self._lock:
            metrics = list(self._metrics.values())
        out: List[dict] = []
        for m in sorted(metrics, key=lambda m: (m.name, m.labels)):
            entry = {"name": m.name, "kind": m.kind,
                     "labels": dict(m.labels)}
            if isinstance(m, Histogram):
                entry.update(m.snapshot())
            else:
                entry["value"] = m.value
            out.append(entry)
        return {"series": out}


def _fmt_labels(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(items.items()))
    return "{" + body + "}"


def prometheus_text(dump: dict) -> str:
    """Render a :meth:`MetricsRegistry.to_dict` dump in the Prometheus
    text exposition format (suitable for the node-exporter textfile
    collector). Pure function of the dump so the report tool can export
    metrics from a dead run's manifest."""
    by_name: Dict[str, List[dict]] = {}
    for s in dump.get("series", []):
        by_name.setdefault(s["name"], []).append(s)
    lines: List[str] = []
    for name in sorted(by_name):
        series = by_name[name]
        kind = series[0].get("kind", "untyped")
        lines.append(f"# TYPE {name} {kind}")
        for s in series:
            labels = s.get("labels", {})
            if kind == "histogram":
                cum = 0
                for b in s.get("buckets", []):
                    cum += b["count"]
                    lines.append("%s_bucket%s %d" % (
                        name, _fmt_labels(labels, {"le": repr(b["le"])}),
                        cum))
                cum += s.get("inf_count", 0)
                lines.append("%s_bucket%s %d" % (
                    name, _fmt_labels(labels, {"le": "+Inf"}), cum))
                lines.append("%s_sum%s %s" % (
                    name, _fmt_labels(labels), repr(s.get("sum", 0.0))))
                lines.append("%s_count%s %d" % (
                    name, _fmt_labels(labels), s.get("count", 0)))
            else:
                lines.append("%s%s %s" % (
                    name, _fmt_labels(labels), repr(s.get("value", 0.0))))
    return "\n".join(lines) + ("\n" if lines else "")
