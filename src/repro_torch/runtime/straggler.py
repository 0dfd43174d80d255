"""Straggler detection from per-host step times, counterpart of
``repro/runtime/straggler.py`` (plain Python).

The slowest host sets a synchronous step's time, so the first-line
mitigation is detection and eviction: keep a rolling per-host step-time
window, flag hosts whose median exceeds a robust threshold (median +
k * MAD over hosts) and report the slowest k.  The single-device
``Trainer`` feeds it its own step times; tests feed it simulated hosts.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class StragglerReport:
    step: int
    slowest: list          # [(host, seconds), ...] descending
    flagged: list          # hosts exceeding the robust threshold
    median: float
    threshold: float


class StragglerMonitor:
    def __init__(self, *, window: int = 32, k_mad: float = 4.0,
                 top_k: int = 3, min_samples: int = 8):
        self.window = window
        self.k_mad = k_mad
        self.top_k = top_k
        self.min_samples = min_samples
        self._times: dict = collections.defaultdict(
            lambda: collections.deque(maxlen=window))
        self._step = 0

    def record(self, host: str, seconds: float):
        self._times[host].append(seconds)

    def record_step(self, host_times: dict):
        """host -> seconds for one synchronous step."""
        self._step += 1
        for h, t in host_times.items():
            self.record(h, t)

    @staticmethod
    def _median(xs):
        s = sorted(xs)
        n = len(s)
        return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])

    def report(self) -> Optional[StragglerReport]:
        per_host = {h: self._median(ts) for h, ts in self._times.items()
                    if len(ts) >= self.min_samples}
        if not per_host:
            return None
        med = self._median(list(per_host.values()))
        mad = self._median([abs(t - med) for t in per_host.values()])
        thresh = med + self.k_mad * max(mad, 1e-4 * med, 1e-9)
        slowest = sorted(per_host.items(), key=lambda kv: -kv[1])
        flagged = [h for h, t in per_host.items() if t > thresh]
        return StragglerReport(self._step, slowest[: self.top_k], flagged,
                               med, thresh)

    def should_evict(self) -> list:
        rep = self.report()
        return rep.flagged if rep else []
