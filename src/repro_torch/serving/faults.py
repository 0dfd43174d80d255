"""Failure injection for the serving runtime.

Counterpart of ``repro/serving/faults.py``.  A ``FaultPlan`` is a
deterministic schedule of typed faults at named injection points,
threaded through ``ExecutorCache`` / ``Executor`` /
``MicroBatchScheduler``, so the retry/backoff path, the executor
degradation ladder, the fp pin on int8 numerics blow-ups and load
shedding can each be reproduced on demand.

Injection points (``FAULT_POINTS``) and what firing one does:

    "executor.compile"    raises ``ExecutorError`` inside the executor
                          build (lower -> plan -> CUDA graph capture)
    "autotune"            raises ``PlanError`` inside ``kernels.
                          autotune.autotune`` (install the hook with
                          ``FaultPlan.install()`` or ``with plan:``);
                          ``plan_program`` names the site, which the
                          ladder demotes
    "kernel.launch"       raises ``KernelLaunchError`` at executor
                          dispatch, naming an offending fused site
    "epilogue.numerics"   returns the executor's output with NaN in it
                          (no raise: the failure is silent, like a real
                          int8 epilogue blow-up; the scheduler's
                          finalize-time guard must catch it)
    "queue.overload"      raises ``CapacityExceeded`` at admission
    "device.dropout"      raises ``DeviceLostError`` at a sharded
                          executor's dispatch (``ExecutorCache(devices=)``),
                          before its replay, blaming one mesh domain
                          (``FaultSpec.device``, default the shard's
                          first); the health registry shrinks the mesh
                          around it (``serving.sharding``)

Every error ``fire`` raises, and every tensor ``corrupt`` returns,
carries ``injected = True``: on the card only injected faults move the
degradation ladder (``common.errors``).

Faults are budgeted: each ``FaultSpec`` fires ``times`` times and then
disarms, so transient and persistent failures are modeled by the budget,
and a chaos replay shows that it injected every class (``fired``) and
that it stops (``exhausted``).  ``FaultPlan(tracer=)`` turns every
consumed firing into a zero-duration ``fault.injected`` mark on the
``faults`` track of an ``obs.trace.Tracer``, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

from repro_torch.common.errors import (
    CapacityExceeded, DeviceLostError, ExecutorError, KernelLaunchError,
    PlanError)

__all__ = ["FAULT_POINTS", "FaultSpec", "FaultPlan"]

FAULT_POINTS = ("executor.compile", "autotune", "kernel.launch",
                "epilogue.numerics", "queue.overload", "device.dropout")

_ERROR_FOR_POINT = {
    "executor.compile": ExecutorError,
    "autotune": PlanError,
    "kernel.launch": KernelLaunchError,
    "queue.overload": CapacityExceeded,
    "device.dropout": DeviceLostError,
}


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: fire ``times`` times at ``point``.

    ``match`` filters on the injection context (e.g. ``{"resolution":
    64}`` or ``{"precision": "int8"}``); ``None`` matches every firing of
    the point.  ``site`` names the offending IR site carried on a
    ``kernel.launch`` error (default: the executor's first fused site).
    ``device`` names the device id a ``device.dropout`` blames.
    """
    point: str
    times: int = 1
    match: Optional[Mapping] = None
    site: Optional[str] = None
    device: Optional[int] = None
    note: str = ""

    def __post_init__(self):
        if self.point not in FAULT_POINTS:
            raise ValueError(f"unknown fault point {self.point!r}; "
                             f"known: {FAULT_POINTS}")

    def matches(self, ctx: Mapping) -> bool:
        return self.match is None or all(
            ctx.get(k) == v for k, v in self.match.items())


class FaultPlan:
    """A deterministic fault schedule and its firing record.

    Pass one to ``ExecutorCache(faults=...)`` / ``MicroBatchScheduler
    (faults=...)``.  An idle plan (no specs, or every budget spent) never
    alters behavior: every ``fire`` is a no-op.
    """

    def __init__(self, *specs: FaultSpec, tracer=None):
        self.specs = list(specs)
        self.fired: dict[str, int] = {}
        # optional obs.trace.Tracer: every consumed firing becomes a
        # zero-duration "fault.injected" mark on the "faults" track
        self.tracer = tracer

    # -- schedule state --------------------------------------------------
    def armed(self, point: str, **ctx) -> Optional[FaultSpec]:
        """The first spec at ``point`` with budget left that matches."""
        for spec in self.specs:
            if spec.point == point and spec.times > 0 and spec.matches(ctx):
                return spec
        return None

    @property
    def exhausted(self) -> bool:
        """Every scheduled fault has fired its full budget."""
        return all(s.times == 0 for s in self.specs)

    def _consume(self, spec: FaultSpec, **ctx) -> None:
        spec.times -= 1
        self.fired[spec.point] = self.fired.get(spec.point, 0) + 1
        if self.tracer is not None:
            safe = {k: (list(v) if isinstance(v, tuple) else v)
                    for k, v in ctx.items()
                    if isinstance(v, (bool, int, float, str, tuple))}
            self.tracer.end(self.tracer.begin(
                "fault.injected", track="faults", point=spec.point,
                site=spec.site, note=spec.note, **safe))

    # -- injection -------------------------------------------------------
    def fire(self, point: str, **ctx) -> None:
        """Raise the point's typed error if a matching spec is armed."""
        spec = self.armed(point, **ctx)
        if spec is None:
            return
        self._consume(spec, **ctx)
        msg = (f"injected fault at {point} (ctx={ctx})"
               + (f": {spec.note}" if spec.note else ""))
        if point == "kernel.launch":
            sites = ctx.get("sites") or ()
            site = spec.site if spec.site is not None else \
                (sites[0] if sites else None)
            err = KernelLaunchError(msg, site=site)
        elif point == "device.dropout":
            devices = ctx.get("devices") or ()
            device = spec.device if spec.device is not None else \
                (devices[0] if devices else None)
            err = DeviceLostError(msg, device=device)
        else:
            err = _ERROR_FOR_POINT[point](msg, site=spec.site)
        err.injected = True
        raise err

    def corrupt(self, point: str, out, **ctx):
        """Silent-corruption points: a new tensor, ``out`` with NaN in
        its first column, if a matching spec is armed, else ``out``
        itself.  ``out`` is never written: under a CUDA graph it may be
        a buffer the next replay reuses.  The new tensor carries
        ``injected = True``, so the NaN it delivers counts as a drill
        (``ReproError.injected``)."""
        spec = self.armed(point, **ctx)
        if spec is None:
            return out
        self._consume(spec, **ctx)
        bad = out.clone()
        bad[..., 0] = float("nan")
        bad.injected = True
        return bad

    # -- autotuner hook --------------------------------------------------
    def install(self) -> "FaultPlan":
        """Hook the autotuner so "autotune" faults fire inside every
        consultation (a sweep or a cache lookup)."""
        from repro_torch.kernels import autotune
        autotune.set_fault_hook(
            lambda kind, key: self.fire("autotune", kind=kind))
        return self

    def uninstall(self) -> None:
        from repro_torch.kernels import autotune
        autotune.set_fault_hook(None)

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
