"""Typed exception hierarchy for the reproduction's runtime.

Every failure the serving stack is prepared to survive has a type here,
so fault handling is dispatch on class, never string-matching on
messages.  The hierarchy mirrors the pipeline stages a request crosses:

    ReproError
      LoweringError      cfg -> Program failed (also a ValueError, so
                         pre-existing callers catching ValueError on bad
                         geometry keep working)
      PlanError          fusion planning / autotune failed; carries the
                         offending ``site`` when known
      ExecutorError      build (lower -> plan -> jit) or launch of a
                         compiled executor failed; ``transient`` — the
                         scheduler retries it with backoff
        KernelLaunchError  a fused Pallas launch failed; carries the
                           offending ``site`` so the degradation ladder
                           can replan exactly that site as demoted
        NumericsError      NaN/Inf detected in an executor's output
                           (int8 epilogue blow-up); NOT transient —
                           retrying the same executor reproduces it, so
                           the ladder pins the bucket to fp instead
      DeadlineExceeded   the request's hard deadline passed while it was
                         queued — shed, never occupies a batch slot
                         (also the watchdog's verdict on a hung batch)
      CapacityExceeded   admission-queue bound hit — shed at submit

Per-device fault domains (``serving.sharding``) add two leaves under
``ExecutorError``: ``DeviceLostError`` blames one mesh device for a
failed launch (transient — the mesh shrinks and the request retries on
the survivors, the degradation ladder does NOT move), and
``MeshExhausted`` is the terminal no-devices-left state (persistent —
requests fail immediately instead of burning their retry budget).

``injected`` is True on an error that a ``serving.faults.FaultPlan``
raised (a fault drill).  On the card only such an error moves the
degradation ladder: a real failure there is retried on the same
executor and ends "failed" with its typed error, so nothing falls back
to the reference path's plain PyTorch unnoticed.

``transient`` steers the scheduler's retry policy: transient errors get
a same-level retry with exponential backoff before the degradation
ladder moves; persistent ones degrade immediately.  ``site`` / ``key``
carry the blame context (an IR site name, an executor cache key) for
telemetry and for site-targeted demotion.
"""
from __future__ import annotations

__all__ = ["ReproError", "LoweringError", "PlanError", "ExecutorError",
           "KernelLaunchError", "NumericsError", "DeviceLostError",
           "MeshExhausted", "DeadlineExceeded", "CapacityExceeded",
           "ArtifactError"]


class ReproError(Exception):
    """Base of every typed runtime error."""
    transient = False   # True -> a same-level retry may succeed
    injected = False    # True -> a FaultPlan raised it

    def __init__(self, message: str = "", *, site: str | None = None,
                 key=None):
        super().__init__(message)
        self.site = site     # offending IR site name, when known
        self.key = key       # offending executor key, when known


class LoweringError(ReproError, ValueError):
    """cfg -> Program lowering failed (bad geometry / config)."""


class PlanError(ReproError):
    """Fusion planning (including the autotune sweep) failed."""
    transient = True


class ExecutorError(ReproError):
    """Building or running a compiled executor failed."""
    transient = True


class KernelLaunchError(ExecutorError):
    """A fused kernel launch failed; ``site`` names the launch."""


class NumericsError(ExecutorError):
    """Non-finite values detected in an executor's output."""
    transient = False


class DeviceLostError(KernelLaunchError):
    """A launch failed and the blame lands on one mesh device.

    ``device`` is the lost device's id.  Transient: the health registry
    marks the device dead, the mesh shrinks around it, and the request
    retries on the survivors — the degradation ladder does not move.
    """

    def __init__(self, message: str = "", *, device: int | None = None,
                 **kw):
        super().__init__(message, **kw)
        self.device = device


class MeshExhausted(ExecutorError):
    """Every device in the fault domain is dead — nothing left to shrink
    to.  Persistent: requests fail immediately rather than burning their
    retry budget against an empty mesh."""
    transient = False


class ArtifactError(ReproError, ValueError):
    """A serialized search artifact (schedule artifact, traffic trace)
    was rejected: schema version, config hash, precision or trace
    fingerprint does not match what the consumer expects.  Persistent —
    adopting a mismatched schedule would silently serve stale tiles, so
    the caller must fall back to online planning instead of retrying."""


class DeadlineExceeded(ReproError):
    """The request's hard deadline passed before it could be served."""


class CapacityExceeded(ReproError):
    """Admission rejected: the queue bound (or overload guard) was hit."""
