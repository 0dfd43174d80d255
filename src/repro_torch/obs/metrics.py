"""Metrics registry: typed metric families over serving telemetry.

Counterpart of ``repro/obs/metrics.py``, rendering the port's
``serving.telemetry.Telemetry`` (the same recording surface as JAX's).
``serving.telemetry.Telemetry`` stays the recording surface — plain
dict/deque bookkeeping with zero synchronization on the dispatch path —
and ``MetricsRegistry`` is the *export* surface on top of it: it renders
the counters, per-bucket stats, per-device fault-domain stats and
observation series as typed metric families with labels, in Prometheus
text exposition format (``prometheus_text``) or JSON (``to_json``).
Rendering walks the telemetry's state on demand; nothing is added to
the record path.

The registry also carries its own standalone instruments for callers
outside the Telemetry object::

    reg = MetricsRegistry(telemetry=tel)
    reg.counter("trace_exports", "trace files written").inc()
    reg.gauge("mesh_alive").set(3, mesh="vision")
    reg.histogram("build_s", buckets=(0.1, 1, 10)).observe(0.4)
    print(reg.prometheus_text())

Label mapping for telemetry state:

  * counters            ``{ns}_<name>_total``                (no labels)
  * bucket stats        ``{ns}_bucket_*`` with labels
                        ``bucket`` / ``resolution`` / ``precision``
                        (key positions beyond three become ``key3``...)
  * quantile series     ``{ns}_bucket_wait_ms{...,quantile="0.5"}`` and
                        p95/p99 — the telemetry ring windows rendered
                        as summary quantiles
  * device stats        ``{ns}_device_*`` with label ``device``
  * named series        ``{ns}_series_<name>{quantile=...}`` +
                        ``_count``

Counter names are sanitized to the Prometheus grammar
(``[a-zA-Z_:][a-zA-Z0-9_:]*``); label values are escaped per the text
exposition rules (backslash, double-quote, newline).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serving.telemetry import Telemetry, percentile

__all__ = ["MetricsRegistry", "MetricFamily", "Counter", "Gauge",
           "Histogram", "escape_label"]

QUANTILES = (("0.5", 0.5), ("0.95", 0.95), ("0.99", 0.99))


def _sanitize(name: str) -> str:
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return out if not out[:1].isdigit() else "_" + out


def escape_label(value) -> str:
    """Escape a label value per the Prometheus text exposition format."""
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _fmt(v: float) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v) if v != int(v) else str(int(v))


@dataclasses.dataclass
class MetricFamily:
    """One named family: samples are (labels, value) pairs."""
    name: str
    type: str            # "counter" | "gauge" | "summary" | "histogram"
    help: str = ""
    samples: List[Tuple[Dict[str, object], float]] = \
        dataclasses.field(default_factory=list)

    def add(self, value, **labels) -> "MetricFamily":
        self.samples.append((labels, float(value)))
        return self


class Counter:
    """Monotonic standalone counter with optional labels."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[tuple, float] = {}

    def inc(self, n: float = 1, **labels) -> None:
        assert n >= 0, f"counter {self.name} decremented by {n}"
        key = tuple(sorted(labels.items()))
        self._values[key] = self._values.get(key, 0.0) + n

    def value(self, **labels) -> float:
        return self._values.get(tuple(sorted(labels.items())), 0.0)

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, "counter", self.help)
        for key, v in sorted(self._values.items()):
            fam.add(v, **dict(key))
        return fam


class Gauge:
    """Point-in-time standalone gauge with optional labels."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self._values: Dict[tuple, float] = {}

    def set(self, v: float, **labels) -> None:
        self._values[tuple(sorted(labels.items()))] = float(v)

    def value(self, **labels) -> Optional[float]:
        return self._values.get(tuple(sorted(labels.items())))

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, "gauge", self.help)
        for key, v in sorted(self._values.items()):
            fam.add(v, **dict(key))
        return fam


class Histogram:
    """Cumulative-bucket histogram (Prometheus ``le`` semantics)."""

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = (0.005, 0.05, 0.5, 5.0, 50.0)):
        self.name, self.help = name, help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts: Dict[tuple, List[int]] = {}
        self._sums: Dict[tuple, float] = {}

    def observe(self, v: float, **labels) -> None:
        key = tuple(sorted(labels.items()))
        counts = self._counts.setdefault(key, [0] * (len(self.buckets) + 1))
        for i, le in enumerate(self.buckets):
            if v <= le:
                counts[i] += 1
        counts[-1] += 1                       # +Inf
        self._sums[key] = self._sums.get(key, 0.0) + float(v)

    def family(self) -> MetricFamily:
        fam = MetricFamily(self.name, "histogram", self.help)
        for key, counts in sorted(self._counts.items()):
            labels = dict(key)
            for le, c in zip(self.buckets, counts):
                fam.add(c, **dict(labels, le=_fmt(le)))
            fam.add(counts[-1], **dict(labels, le="+Inf"))
            fam.samples.append(
                ({"__suffix__": "_sum", **labels}, self._sums[key]))
            fam.samples.append(
                ({"__suffix__": "_count", **labels}, float(counts[-1])))
        return fam


def _bucket_labels(key: tuple) -> Dict[str, object]:
    names = ("bucket", "resolution", "precision", "epilogues")
    out = {}
    for i, part in enumerate(key):
        out[names[i] if i < len(names) else f"key{i}"] = part
    return out


class MetricsRegistry:
    """Telemetry view + standalone instruments -> metric families."""

    def __init__(self, telemetry: Telemetry | None = None,
                 namespace: str = "repro"):
        self.telemetry = telemetry
        self.namespace = _sanitize(namespace)
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    # -- standalone instruments ------------------------------------------
    def _name(self, name: str) -> str:
        return f"{self.namespace}_{_sanitize(name)}"

    def counter(self, name: str, help: str = "") -> Counter:
        return self._counters.setdefault(
            self._name(name), Counter(self._name(name), help))

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._gauges.setdefault(
            self._name(name), Gauge(self._name(name), help))

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = (0.005, 0.05, 0.5, 5.0, 50.0)
                  ) -> Histogram:
        return self._histograms.setdefault(
            self._name(name), Histogram(self._name(name), help, buckets))

    # -- telemetry adaptation --------------------------------------------
    def _telemetry_families(self) -> List[MetricFamily]:
        tel = self.telemetry
        if tel is None:
            return []
        ns = self.namespace
        fams: List[MetricFamily] = []
        for name, v in sorted(tel.counters.items()):
            fams.append(MetricFamily(
                f"{ns}_{_sanitize(name)}_total", "counter",
                f"telemetry counter {name!r}").add(v))
        bucket_ints = (("dispatches", "dispatches of this executor key"),
                       ("samples", "real requests served"),
                       ("padded", "zero-padded batch slots"),
                       ("errors", "failed dispatch/finalize attempts"))
        for field, help in bucket_ints:
            fam = MetricFamily(f"{ns}_bucket_{field}_total", "counter", help)
            for key, b in sorted(tel.buckets.items(),
                                 key=lambda kv: str(kv[0])):
                fam.add(getattr(b, field), **_bucket_labels(key))
            if fam.samples:
                fams.append(fam)
        occ = MetricFamily(f"{ns}_bucket_occupancy", "gauge",
                           "fraction of dispatched slots holding real "
                           "samples")
        for key, b in sorted(tel.buckets.items(), key=lambda kv: str(kv[0])):
            occ.add(b.occupancy, **_bucket_labels(key))
        if occ.samples:
            fams.append(occ)
        for field, unit in (("wait_ms", "queue wait"),
                            ("latency_ms", "submit->complete latency"),
                            ("queue_depth", "queue depth at dispatch")):
            fam = MetricFamily(f"{ns}_bucket_{field}", "summary",
                               f"{unit} over the telemetry ring window")
            for key, b in sorted(tel.buckets.items(),
                                 key=lambda kv: str(kv[0])):
                series = getattr(b, field)
                labels = _bucket_labels(key)
                for qname, q in QUANTILES:
                    fam.add(percentile(series, q),
                            **dict(labels, quantile=qname))
                fam.samples.append(
                    ({"__suffix__": "_count", **labels},
                     float(len(series))))
            if fam.samples:
                fams.append(fam)
        dev_fields = (("dispatches", "counter"), ("samples", "counter"),
                      ("padded", "counter"), ("errors", "counter"),
                      ("occupancy", "gauge"), ("lost", "gauge"))
        for field, mtype in dev_fields:
            suffix = "_total" if mtype == "counter" else ""
            fam = MetricFamily(f"{ns}_device_{field}{suffix}", mtype,
                               f"per-device fault-domain {field}")
            for did, d in sorted(tel.devices.items()):
                fam.add(float(getattr(d, field)), device=did)
            if fam.samples:
                fams.append(fam)
        for name, series in sorted(tel.series.items()):
            fam = MetricFamily(f"{ns}_series_{_sanitize(name)}", "summary",
                               f"telemetry series {name!r}")
            for qname, q in QUANTILES:
                fam.add(percentile(series, q), quantile=qname)
            fam.samples.append(({"__suffix__": "_count"},
                                float(len(series))))
            fams.append(fam)
        return fams

    # -- export ----------------------------------------------------------
    def collect(self) -> List[MetricFamily]:
        fams = self._telemetry_families()
        for group in (self._counters, self._gauges, self._histograms):
            for inst in group.values():
                fams.append(inst.family())
        return fams

    def prometheus_text(self) -> str:
        """Prometheus text exposition format (one scrape body)."""
        lines: List[str] = []
        for fam in self.collect():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.type}")
            for labels, value in fam.samples:
                labels = dict(labels)
                suffix = labels.pop("__suffix__", "")
                if fam.type == "histogram" and not suffix:
                    suffix = "_bucket"
                label_s = ",".join(
                    f'{k}="{escape_label(v)}"'
                    for k, v in sorted(labels.items()))
                lines.append(
                    f"{fam.name}{suffix}"
                    f"{'{' + label_s + '}' if label_s else ''} "
                    f"{_fmt(value)}")
        return "\n".join(lines) + "\n"

    def to_json(self) -> dict:
        """JSON-serializable dump of every family (benchmark ledgers)."""
        return {
            "namespace": self.namespace,
            "families": [
                {"name": fam.name, "type": fam.type, "help": fam.help,
                 "samples": [{"labels": {k: v for k, v in labels.items()},
                              "value": value if math.isfinite(value)
                              else None}
                             for labels, value in fam.samples]}
                for fam in self.collect()],
        }
