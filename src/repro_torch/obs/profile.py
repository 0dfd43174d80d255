"""Per-site profiled execution: measured device time vs the cycle model.

Counterpart of ``repro/obs/profile.py``.  The fusion planner and the
delivered-HBM accounting trust the analytic cycle model
(``core.accelerator_model.site_breakdown``); this module checks it
against measured time: ``core.program.execute(..., profile=)`` calls
``begin(site)`` and ``end(site, out)`` at every site boundary, and
``drift_report`` sets each site's measured time beside the model's
predicted cycles in a typed :class:`DriftReport`.

Where JAX blocks on every site's output (``jax.block_until_ready``) and
reads the host clock, the port's default timer on the card is a pair of
CUDA events per site, recorded on the current stream: nothing waits at
a site boundary, and the events are read once the forward has ended
(``SiteProfiler.flush``).  On the CPU, and wherever ``clock`` or
``sync`` is given, the window is the host clock's around ``sync(out)``,
as in JAX.

Profiled execution is offline, not the serving path: it runs eagerly,
one launch per site (super-site groups are off under ``profile``), and
the predicted milliseconds are the paper's FPGA's (200 MHz), so the
absolute drift ratio compares two machines; the signal is the per-site
relative profile, and that every ratio is finite.

    prof = profile_execute(program, params, x, plan=plan)
    report = drift_report(program, prof, plan=plan)
    print(report.table())
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Dict, List, Optional

import torch

from repro_torch.core.accelerator_model import HwConfig, site_breakdown

__all__ = ["DRIFT_SCHEMA", "SiteProfiler", "DriftReport",
           "profile_execute", "drift_report"]

DRIFT_SCHEMA = 1


def _identity(out):
    return out


class SiteProfiler:
    """Per-site timer for ``execute(..., profile=)``.

    ``device`` picks the default timer: on a CUDA device, a pair of CUDA
    events per site on the current stream (``begin`` records the start,
    ``end`` the stop; neither waits); elsewhere, or when ``clock`` (zero
    -arg seconds) or ``sync`` (called on the site's output before the
    clock is read; default: none on the CPU, ``torch.cuda.synchronize``
    on a CUDA device) is given, the host clock around ``sync(out)``, as
    JAX's profiler.  ``records`` maps site names to their windows in
    seconds; reading it (or ``flush``) first waits for the events still
    outstanding.
    """

    def __init__(self, *, clock=None, sync=None, device=None):
        dev = torch.device(device) if device is not None else None
        cuda = dev is not None and dev.type == "cuda"
        self.events = cuda and clock is None and sync is None
        self.clock = clock if clock is not None else time.perf_counter
        if sync is None:
            sync = (lambda out: (torch.cuda.synchronize(dev), out)[1]) \
                if cuda else _identity
        self.sync = sync
        self._records: Dict[str, List[float]] = {}
        self._pending: list = []     # (name, start event, stop event)
        self._t0 = None

    def begin(self, site) -> None:
        if self.events:
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = self.clock()

    def end(self, site, out):
        if self._t0 is None:
            raise RuntimeError(f"end({site.name}) without begin")
        if self.events:
            stop = torch.cuda.Event(enable_timing=True)
            stop.record()
            self._pending.append((site.name, self._t0, stop))
        else:
            out = self.sync(out)
            self._records.setdefault(site.name, []).append(
                float(self.clock() - self._t0))
        self._t0 = None
        return out

    def flush(self) -> None:
        """Wait for the outstanding events and file their windows."""
        if not self._pending:
            return
        self._pending[-1][2].synchronize()
        for name, start, stop in self._pending:
            self._records.setdefault(name, []).append(
                start.elapsed_time(stop) / 1e3)
        self._pending = []

    @property
    def records(self) -> Dict[str, List[float]]:
        self.flush()
        return self._records

    def measured_ms(self, name: str) -> float:
        """Median recorded window for one site, in milliseconds."""
        return statistics.median(self.records[name]) * 1e3

    @property
    def repeats(self) -> int:
        return min((len(v) for v in self.records.values()), default=0)


def profile_execute(program, params, x, *, plan=None, repeats: int = 3,
                    warmup: int = 1, profiler: SiteProfiler | None = None
                    ) -> SiteProfiler:
    """Run the program ``repeats`` times under a ``SiteProfiler`` (by
    default CUDA events on a card, the host clock on the CPU: ``x``'s
    device decides).  Eager: ``warmup`` unrecorded passes absorb
    first-touch costs (kernel builds, constants, allocations) first.
    Every event is read before this returns.

    An eager forward enqueues its launches more slowly than the card
    runs them, so an event window would time the host.  With events,
    each profiled pass is queued behind a sleep kernel as long as twice
    the longest enqueue so far, warm-up or profiled (at most a second):
    the card then runs the sites back to back and each window is device
    time.  (1.5x the warm-up pass alone fell short once, on a slow host:
    the profiled pass enqueues its events too.)"""
    from repro_torch.core.program import execute

    prof = profiler if profiler is not None \
        else SiteProfiler(device=x.device)
    host_s = 0.0
    with torch.inference_mode():
        for _ in range(int(warmup)):
            if prof.events:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
            execute(program, params, x, plan=plan)
            host_s = max(host_s, time.perf_counter() - t0)
        for _ in range(int(repeats)):
            if prof.events:
                torch.cuda.synchronize(x.device)
                torch.cuda._sleep(int(2e9 * min(1.0, 2.0 * host_s + 1e-3)))
            t0 = time.perf_counter()
            execute(program, params, x, plan=plan, profile=prof)
            host_s = max(host_s, time.perf_counter() - t0)
    prof.flush()
    return prof


@dataclasses.dataclass
class DriftReport:
    """Measured-vs-predicted reconciliation for one profiled program.

    One row per site: measured time (median over repeats), predicted
    cycles/ms from the analytic model under the same plan,
    and ``drift = measured_ms / predicted_ms``.  A site the model
    assigns zero cycles (the parameter-free global-average-pool) is
    charged its memory-bound boundary traffic instead, so every ratio
    is finite.
    """
    precision: str
    repeats: int
    hw: HwConfig
    rows: List[dict]

    @property
    def measured_ms(self) -> float:
        return sum(r["measured_ms"] for r in self.rows)

    @property
    def predicted_ms(self) -> float:
        return sum(r["predicted_ms"] for r in self.rows)

    @property
    def drift(self) -> float:
        """Aggregate measured/predicted ratio."""
        return self.measured_ms / self.predicted_ms

    def row(self, name: str) -> dict:
        for r in self.rows:
            if r["site"] == name:
                return r
        raise KeyError(name)

    def finite(self) -> bool:
        import math
        return all(math.isfinite(r["drift"]) and r["predicted_ms"] > 0
                   for r in self.rows)

    def to_dict(self) -> dict:
        return {
            "schema": DRIFT_SCHEMA,
            "precision": self.precision,
            "repeats": self.repeats,
            "freq_mhz": self.hw.freq_hz / 1e6,
            "measured_ms": self.measured_ms,
            "predicted_ms": self.predicted_ms,
            "drift": self.drift,
            "rows": [dict(r) for r in self.rows],
        }

    def table(self) -> str:
        head = (f"{'site':<16} {'kind':<8} {'route':<10} "
                f"{'measured ms':>12} {'predicted ms':>13} {'drift':>9} "
                f"{'meas %':>7} {'pred %':>7}")
        lines = [head, "-" * len(head)]
        tm, tp = self.measured_ms, self.predicted_ms
        for r in self.rows:
            route = "fused" if r["fused"] else "ref"
            lines.append(
                f"{r['site']:<16} {r['kind']:<8} "
                f"{route + '/' + r['precision']:<10} "
                f"{r['measured_ms']:>12.3f} {r['predicted_ms']:>13.4f} "
                f"{r['drift']:>8.0f}x "
                f"{r['measured_ms'] / tm:>6.1%} "
                f"{r['predicted_ms'] / tp:>6.1%}")
        lines.append(f"{'TOTAL':<36} {tm:>12.3f} {tp:>13.4f} "
                     f"{self.drift:>8.0f}x")
        return "\n".join(lines)


def _boundary_cycles(site, hw: HwConfig) -> float:
    """Memory-bound floor for a site with no scheduled MACs: its fp32
    input + output boundary traffic at the DRAM bandwidth."""
    import math
    n_in = math.prod(site.in_shape)
    n_out = math.prod(site.out_shape)
    return 4.0 * (n_in + n_out) / hw.bytes_per_cycle


def drift_report(program, profiler: SiteProfiler, *, plan=None,
                 hw: HwConfig | None = None,
                 precision: str | None = None) -> DriftReport:
    """Reconcile a profiled run against the analytic cycle model.

    ``plan`` must be the plan the profiled run executed (or None for
    the reference interpreter); ``precision`` is the model's default
    for sites outside the plan — inferred from the plan when omitted.
    Raises ``KeyError`` if the profiler is missing any program site:
    partial profiles do not reconcile.
    """
    hw = hw if hw is not None else HwConfig()
    if precision is None:
        decisions = plan.decisions.values() if plan is not None else ()
        precision = "int8" if any(d.precision == "int8" and d.fused
                                  for d in decisions) else "fp"
    predicted = {r["site"]: r for r in site_breakdown(
        program, hw, plan=plan, include_head=True,
        default_precision=precision)}
    rows: List[dict] = []
    for site in program.sites:
        meas = profiler.measured_ms(site.name)     # KeyError if missing
        p = predicted.get(site.name)
        cycles = p["cycles"] if p is not None else 0.0
        if cycles <= 0.0:
            cycles = _boundary_cycles(site, hw)
        pred_ms = cycles / hw.freq_hz * 1e3
        d = plan.get(site.name) if plan is not None else None
        rows.append({
            "site": site.name, "kind": site.kind, "stage": site.stage,
            "fused": bool(d.fused) if d is not None else False,
            "precision": d.precision if d is not None else precision,
            "measured_ms": meas,
            "predicted_cycles": float(cycles),
            "predicted_ms": pred_ms,
            "drift": meas / pred_ms,
        })
    return DriftReport(precision=precision, repeats=profiler.repeats,
                       hw=hw, rows=rows)
