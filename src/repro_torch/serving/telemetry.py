"""Serving telemetry: per-bucket counters + runtime-wide series.

One ``Telemetry`` instance is threaded through the serving runtime —
the executor cache counts compile/plan cache behavior into it, the
micro-batching scheduler records per-dispatch bucket occupancy, pad
waste, queue depth and request latency, and the LM ``ServingEngine``
reports slot occupancy through the same object.  ``snapshot()`` returns
plain dicts (machine-readable, benchmark-friendly); ``table()`` renders
the per-bucket view as a pretty table.

This is deliberately dependency-free bookkeeping (no jax): recording a
dispatch must never add host/device synchronization to the serving hot
path.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Dict, Tuple

__all__ = ["Telemetry", "BucketStats", "DeviceStats", "percentile",
           "MAX_SAMPLES"]

# Observation series are bounded ring buffers: a long-lived serving
# process records one wait + one latency sample per request (and one
# occupancy sample per LM decode step), so unbounded lists would grow
# forever.  Percentiles over the most recent window are what an
# operator wants anyway; integer counters are exact for all time.
MAX_SAMPLES = 4096


def _ring():
    return collections.deque(maxlen=MAX_SAMPLES)


def percentile(xs, q: float) -> float:
    """Linear-interpolated percentile of a sample list; nan when empty."""
    if not xs:
        return float("nan")
    s = sorted(float(x) for x in xs)
    if len(s) == 1:
        return s[0]
    idx = (len(s) - 1) * q
    lo, hi = math.floor(idx), math.ceil(idx)
    frac = idx - lo
    return s[lo] * (1.0 - frac) + s[hi] * frac


@dataclasses.dataclass
class BucketStats:
    """Counters for one executor bucket (batch, resolution, precision)."""
    dispatches: int = 0
    samples: int = 0          # real requests served
    padded: int = 0           # slots filled with zero-padding
    errors: int = 0           # failed dispatch/finalize attempts
    queue_depth: collections.deque = dataclasses.field(default_factory=_ring)
    wait_ms: collections.deque = dataclasses.field(default_factory=_ring)
    latency_ms: collections.deque = dataclasses.field(default_factory=_ring)

    @property
    def occupancy(self) -> float:
        """Fraction of dispatched slots holding real samples."""
        total = self.samples + self.padded
        return self.samples / total if total else 1.0

    def snapshot(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "samples": self.samples,
            "padded": self.padded,
            "errors": self.errors,
            "error_rate": (self.errors / (self.dispatches + self.errors)
                           if self.dispatches + self.errors else 0.0),
            "occupancy": self.occupancy,
            "queue_depth_p50": percentile(self.queue_depth, 0.5),
            "wait_ms_p50": percentile(self.wait_ms, 0.5),
            "wait_ms_p95": percentile(self.wait_ms, 0.95),
            "wait_ms_p99": percentile(self.wait_ms, 0.99),
            "latency_ms_p50": percentile(self.latency_ms, 0.5),
            "latency_ms_p95": percentile(self.latency_ms, 0.95),
            "latency_ms_p99": percentile(self.latency_ms, 0.99),
        }


@dataclasses.dataclass
class DeviceStats:
    """Counters for one mesh device (one fault domain).

    ``samples``/``padded`` are the rows of each sharded dispatch that
    landed on this device, so per-device occupancy surfaces skew (a
    ragged tail pads the *last* devices of the shard first).  ``errors``
    counts launch failures attributed to this domain; ``lost`` flips to
    True when the health registry declares it dead.
    """
    dispatches: int = 0
    samples: int = 0
    padded: int = 0
    errors: int = 0
    lost: bool = False

    @property
    def occupancy(self) -> float:
        total = self.samples + self.padded
        return self.samples / total if total else 1.0

    def snapshot(self) -> dict:
        return {
            "dispatches": self.dispatches,
            "samples": self.samples,
            "padded": self.padded,
            "errors": self.errors,
            "lost": self.lost,
            "occupancy": self.occupancy,
        }


class Telemetry:
    """Shared counters: generic names, observation series, bucket stats."""

    def __init__(self):
        self.counters: Dict[str, int] = {}
        self.series: Dict[str, collections.deque] = {}
        self.buckets: Dict[Tuple, BucketStats] = {}
        self.devices: Dict[int, DeviceStats] = {}

    # -- generic ---------------------------------------------------------
    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def observe(self, name: str, value: float) -> None:
        self.series.setdefault(name, _ring()).append(float(value))

    # -- per-bucket ------------------------------------------------------
    def bucket(self, key) -> BucketStats:
        key = tuple(key)
        if key not in self.buckets:
            self.buckets[key] = BucketStats()
        return self.buckets[key]

    def record_dispatch(self, key, n_real: int, bucket_size: int, *,
                        queue_depth: int | None = None,
                        wait_ms=()) -> None:
        b = self.bucket(key)
        b.dispatches += 1
        b.samples += n_real
        b.padded += max(0, bucket_size - n_real)
        if queue_depth is not None:
            b.queue_depth.append(int(queue_depth))
        b.wait_ms.extend(float(w) for w in wait_ms)

    def record_latency(self, key, latencies_ms) -> None:
        self.bucket(key).latency_ms.extend(float(x) for x in latencies_ms)

    def record_error(self, key) -> None:
        """One failed dispatch/finalize attempt against this bucket."""
        self.bucket(key).errors += 1

    # -- per-device (fault domains) --------------------------------------
    def device(self, device_id: int) -> DeviceStats:
        did = int(device_id)
        if did not in self.devices:
            self.devices[did] = DeviceStats()
        return self.devices[did]

    def record_device_dispatch(self, device_ids, n_real: int,
                               bucket_size: int) -> None:
        """Attribute one sharded dispatch's rows to its devices.

        Rows are laid out contiguously: device ``i`` of the shard holds
        rows ``[i*lb, (i+1)*lb)``, so real samples fill the leading
        devices and padding lands on the trailing ones.
        """
        ids = tuple(device_ids)
        lb = bucket_size // len(ids)
        for i, did in enumerate(ids):
            real = min(max(n_real - i * lb, 0), lb)
            d = self.device(did)
            d.dispatches += 1
            d.samples += real
            d.padded += lb - real

    def record_device_error(self, device_id: int, *,
                            lost: bool = False) -> None:
        """One launch failure attributed to this fault domain."""
        d = self.device(device_id)
        d.errors += 1
        if lost:
            d.lost = True

    # -- aggregate views -------------------------------------------------
    def total(self, field: str) -> int:
        """Sum an integer BucketStats field over every bucket."""
        return sum(getattr(b, field) for b in self.buckets.values())

    @property
    def occupancy(self) -> float:
        total = self.total("samples") + self.total("padded")
        return self.total("samples") / total if total else 1.0

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "series": {
                name: {"n": len(v), "p50": percentile(v, 0.5),
                       "p95": percentile(v, 0.95),
                       "p99": percentile(v, 0.99)}
                for name, v in self.series.items()},
            "buckets": {"/".join(str(k) for k in key): b.snapshot()
                        for key, b in sorted(self.buckets.items(),
                                             key=lambda kv: str(kv[0]))},
            "devices": {did: d.snapshot()
                        for did, d in sorted(self.devices.items())},
            "occupancy": self.occupancy,
            "padded_total": self.total("padded"),
            "samples_total": self.total("samples"),
        }

    def table(self) -> str:
        """Per-bucket pretty table (benchmark / EXPERIMENTS.md output).

        Empty observation series render as ``-`` (``percentile`` of an
        empty ring is NaN by contract — the *renderer* translates, the
        snapshot keeps NaN for machine consumers to detect)."""
        def cell(v: float, width: int, align: str = ">") -> str:
            return (f"{'-':{align}{width}}" if math.isnan(v)
                    else f"{v:{align}{width}.1f}")

        head = (f"{'bucket':<22} {'disp':>5} {'samples':>8} {'pad':>5} "
                f"{'occ':>6} {'q p50':>6} {'wait p50/p95/p99 ms':>20} "
                f"{'lat p50/p95/p99 ms':>20}")
        lines = [head, "-" * len(head)]
        for key, b in sorted(self.buckets.items(), key=lambda kv: str(kv[0])):
            s = b.snapshot()
            name = "x".join(str(k) for k in key)
            lines.append(
                f"{name:<22} {b.dispatches:>5} {b.samples:>8} "
                f"{b.padded:>5} {b.occupancy:>5.0%} "
                f"{cell(s['queue_depth_p50'], 6)} "
                f"{cell(s['wait_ms_p50'], 7)}/"
                f"{cell(s['wait_ms_p95'], 1, '<')}/"
                f"{cell(s['wait_ms_p99'], 1, '<')} "
                f"{cell(s['latency_ms_p50'], 7)}/"
                f"{cell(s['latency_ms_p95'], 1, '<')}/"
                f"{cell(s['latency_ms_p99'], 1, '<')}")
        lines.append(
            f"{'TOTAL':<22} {self.total('dispatches'):>5} "
            f"{self.total('samples'):>8} {self.total('padded'):>5} "
            f"{self.occupancy:>5.0%}")
        if self.devices:
            lines.append(f"{'device':<10} {'disp':>5} {'samples':>8} "
                         f"{'pad':>5} {'occ':>6} {'errs':>5} state")
            for did, d in sorted(self.devices.items()):
                lines.append(
                    f"dev{did:<7} {d.dispatches:>5} {d.samples:>8} "
                    f"{d.padded:>5} {d.occupancy:>5.0%} {d.errors:>5} "
                    f"{'LOST' if d.lost else 'alive'}")
        if self.counters:
            lines.append("counters: " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.counters.items())))
        return "\n".join(lines)
