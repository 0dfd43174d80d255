"""Continuous micro-batching scheduler over the executor cache.

Counterpart of ``repro/serving/scheduler.py``.  Requests (one image
each, possibly mixed resolutions and deadlines) flow through one
admission queue per resolution.  Batch formation groups same-resolution
requests into the largest ready bucket, and a ragged tail is flushed to
the smallest bucket that fits it when its deadline comes due or at
drain.

``step()`` hands padded batches to the executors and returns without
waiting on the device.  ``finalize()`` is where the host first waits:
it copies each outstanding batch's logits to the host, scatters them
onto their requests and stamps completion latency into telemetry.

Every submitted request ends in one state: "completed"; "shed" (its
hard ``timeout_ms`` expired while queued: ``DeadlineExceeded``, swept
out before batch formation); or "failed" (the dispatch raised a typed
error).  Retries with backoff, the degradation ladder, the watchdog,
the result cache, the async host loop and tracing are later slices.

Wall-clock is injectable (``clock=``) so deadline behavior replays
deterministically on a ``ManualClock``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import List, Optional

import numpy as np

from repro_torch.common.device import to_device
from repro_torch.common.errors import (
    DeadlineExceeded, ExecutorError, ReproError)
from repro_torch.serving.executors import ExecutorCache
from repro_torch.serving.telemetry import Telemetry

__all__ = ["Request", "BucketedPolicy", "FixedMicrobatchPolicy",
           "ManualClock", "MicroBatchScheduler"]


@dataclasses.dataclass
class Request:
    """One classification request: an (H, W, 3) image.

    ``deadline_ms`` (after arrival) is the soft target that triggers a
    tail flush; ``timeout_ms`` is the hard SLA, after which the request
    is shed instead of taking a batch slot.
    """
    rid: int
    image: object
    deadline_ms: Optional[float] = None
    timeout_ms: Optional[float] = None
    arrival: float = 0.0                 # stamped by submit()
    logits: Optional[np.ndarray] = None  # filled by finalize()
    status: str = "pending"              # pending | completed | shed | failed
    error: Optional[ReproError] = None

    @property
    def resolution(self) -> int:
        return int(np.shape(self.image)[0])


class ManualClock:
    """Deterministic clock for trace replay and deadline tests."""

    def __init__(self, now: float = 0.0):
        self.now = float(now)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now

    def advance_to(self, t: float) -> float:
        self.now = max(self.now, float(t))
        return self.now


class BucketedPolicy:
    """Group into the largest ready bucket; flush the ragged tail to the
    smallest bucket >= tail only when due (deadline or drain)."""

    def form(self, qlen: int, buckets, due: bool) -> List[int]:
        sizes = []
        big = buckets[-1]
        while qlen >= big:
            sizes.append(big)
            qlen -= big
        if due and qlen:
            sizes.append(next(b for b in buckets if b >= qlen))
        return sizes


class FixedMicrobatchPolicy:
    """Every dispatch is the full microbatch, the tail padded up to it
    (the A/B baseline)."""

    def __init__(self, microbatch: int):
        self.microbatch = int(microbatch)

    def form(self, qlen: int, buckets, due: bool) -> List[int]:
        sizes = [self.microbatch] * (qlen // self.microbatch)
        if due and qlen % self.microbatch:
            sizes.append(self.microbatch)
        return sizes


class MicroBatchScheduler:
    """Admission queues + batch formation + asynchronous dispatch over
    an ``ExecutorCache``::

        sched = MicroBatchScheduler(cache, params)
        for req in arriving:   sched.submit(req); sched.step()
        sched.step(drain=True)
        sched.finalize()       # req.logits populated

    or one-shot: ``sched.serve(requests) -> (n, num_classes)``.
    """

    def __init__(self, cache: ExecutorCache, params, *, policy=None,
                 telemetry: Telemetry | None = None, clock=None):
        self.cache = cache
        self.params = params
        self.policy = policy if policy is not None else BucketedPolicy()
        self.telemetry = (telemetry if telemetry is not None
                          else cache.telemetry)
        self.clock = clock if clock is not None else time.monotonic
        self._queues: dict[int, collections.deque] = {}
        self._pending: list = []   # (device_out, requests, key, t_disp)

    # -- terminal states -------------------------------------------------
    def _shed(self, req: Request, err: ReproError) -> None:
        req.status, req.error = "shed", err
        self.telemetry.count("shed")
        self.telemetry.count("shed_deadline")

    def _fail(self, reqs: List[Request], key, err: ReproError) -> None:
        self.telemetry.count("dispatch_failures")
        self.telemetry.record_error(key)
        for r in reqs:
            r.status, r.error = "failed", err
        self.telemetry.count("failed", len(reqs))

    # -- admission -------------------------------------------------------
    def submit(self, req: Request) -> bool:
        req.arrival = self.clock()
        self.telemetry.count("submitted")
        self._queues.setdefault(req.resolution,
                                collections.deque()).append(req)
        return True

    def queue_depth(self, resolution: int | None = None) -> int:
        if resolution is not None:
            return len(self._queues.get(resolution, ()))
        return sum(len(q) for q in self._queues.values())

    def outstanding(self) -> int:
        """Requests not yet terminal: queued + in flight."""
        return self.queue_depth() + sum(len(e[1]) for e in self._pending)

    # -- batch formation + dispatch -------------------------------------
    def _due(self, q) -> bool:
        now = self.clock()
        return any(r.deadline_ms is not None
                   and now >= r.arrival + r.deadline_ms / 1e3 for r in q)

    def _sweep_expired(self) -> int:
        """Shed every queued request whose hard deadline passed, before
        batch formation, so none occupies a slot."""
        now = self.clock()
        shed = 0
        for res, q in self._queues.items():
            keep = collections.deque()
            for r in q:
                if r.timeout_ms is not None \
                        and now > r.arrival + r.timeout_ms / 1e3:
                    self._shed(r, DeadlineExceeded(
                        f"request {r.rid} expired after "
                        f"{r.timeout_ms:g} ms in queue"))
                    shed += 1
                else:
                    keep.append(r)
            self._queues[res] = keep
        return shed

    def step(self, *, drain: bool = False) -> int:
        """Form and dispatch every ready batch; returns the number of
        requests dispatched.  ``drain=True`` treats all queues as due."""
        self._sweep_expired()
        dispatched = 0
        for res, q in list(self._queues.items()):
            due = drain or self._due(q)
            for size in self.policy.form(len(q), self.cache.buckets, due):
                take = min(size, len(q))
                if take == 0:
                    break
                reqs = [q.popleft() for _ in range(take)]
                self._dispatch(res, reqs, size)
                dispatched += take
        return dispatched

    def _dispatch(self, resolution: int, reqs: List[Request],
                  bucket: int) -> None:
        now = self.clock()
        key = (bucket, resolution, self.cache.precision)
        imgs = np.zeros((bucket, resolution, resolution, 3), np.float32)
        for i, r in enumerate(reqs):
            imgs[i] = np.asarray(r.image, np.float32)
        try:
            ex = self.cache.get(bucket, resolution)
            out = ex(self.params, to_device(imgs, self.cache.device))
        except ReproError as e:
            self._fail(reqs, key, e)
            return
        self.telemetry.record_dispatch(
            key, len(reqs), bucket,
            queue_depth=len(self._queues.get(resolution, ())),
            wait_ms=[(now - r.arrival) * 1e3 for r in reqs])
        self._pending.append((out, reqs, key, now))

    # -- completion ------------------------------------------------------
    def finalize(self) -> int:
        """Wait for outstanding dispatches (in dispatch order), scatter
        logits onto requests, stamp completion latency.  Returns the
        number of requests completed."""
        done = 0
        pending, self._pending = self._pending, []
        for out, reqs, key, _t in pending:
            try:
                arr = out.float().cpu().numpy()   # waits on this batch
            except RuntimeError as e:
                self._fail(reqs, key, ExecutorError(
                    f"materializing executor {key} output failed: {e}",
                    key=key))
                continue
            t = self.clock()
            for i, r in enumerate(reqs):
                r.logits = arr[i]
                r.status = "completed"
            self.telemetry.record_latency(
                key, [(t - r.arrival) * 1e3 for r in reqs])
            done += len(reqs)
        self.telemetry.count("completed", done)
        return done

    # -- one-shot --------------------------------------------------------
    def serve(self, requests: List[Request]) -> np.ndarray:
        """Submit, drain, finalize; logits stacked in request order.
        Raises the typed error of the first request not completed."""
        for r in requests:
            self.submit(r)
        while self.outstanding():
            self.step(drain=True)
            self.finalize()
        bad = next((r for r in requests if r.status != "completed"), None)
        if bad is not None:
            raise bad.error
        return np.stack([r.logits for r in requests])
