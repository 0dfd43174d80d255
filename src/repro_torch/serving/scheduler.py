"""Continuous micro-batching scheduler over the executor cache.

Counterpart of ``repro/serving/scheduler.py``.  Requests (one image
each, possibly mixed resolutions and deadlines) flow through one
admission queue per resolution.  Batch formation groups same-resolution
requests into the largest ready bucket, and a ragged tail is flushed to
the smallest bucket that fits it when its deadline comes due or at
drain.

``step()`` hands padded batches to the executors and returns without
waiting on the device: on the card each batch is staged in pinned host
memory and copied into its executor's static input on the stream that
replays the executor's CUDA graph.  ``finalize()`` is where the host
first waits: it copies each outstanding batch's logits to the host,
scatters them onto their requests and stamps completion latency into
telemetry.  Each in-flight entry holds its executor, so a graph outlives
every replay still running on it, whatever the cache evicts meanwhile.

Wall-clock is injectable (``clock=``) so deadline behavior replays
deterministically on a ``ManualClock``.

## Fault tolerance

Every submitted request terminates in exactly ONE of three states
(``Request.status``), with ``Request.error`` typed
(``repro_torch.common.errors``) for the two failure outcomes:

    "completed"  logits delivered;
    "shed"       never served: admission bound hit (CapacityExceeded)
                 or the hard per-request deadline (``timeout_ms``)
                 expired while queued (DeadlineExceeded); an expired
                 request is swept out before batch formation, so it never
                 occupies a slot;
    "failed"     served ``max_retries`` times and every attempt raised.

``deadline_ms`` is the soft target that triggers a tail flush.  Failed
dispatches (executor build or capture errors, fused-launch faults,
negative-cache hits) retry with exponential backoff; from the second
failure on the executor cache's degradation ladder moves (the blamed
site demoted, then the reference interpreter), and a ``NumericsError``
(finalize finds NaN/Inf in delivered logits) pins the bucket's plan to
fp at once.  On the card the ladder moves only for a fault that a
``FaultPlan`` injected (``ReproError.injected``): a real failure there
would replan onto the reference path's plain PyTorch, so it retries the
same executor and ends "failed" with its typed error (counted in
``real_failures``).  All of it shows in ``Telemetry``: ``shed`` /
``retries`` / ``failed`` / ``degraded`` / ``pinned_fp`` counters and
per-bucket error counts.

Two failure classes bypass the ladder, as in JAX (``serving.sharding``):
a ``DeviceLostError`` shrinks the executor cache's mesh instead (the
rebuild on the survivors is the recovery, so they keep their fused
plans) and the requests retry, and once the mesh is exhausted every
affected request fails at once with ``MeshExhausted`` rather than
burning its retry budget against an empty mesh.  On the card only an
injected device loss shrinks the mesh, as only an injected fault moves
the ladder.  Each sharded dispatch records its rows per mesh domain
(``Telemetry.record_device_dispatch``).

## Tracing

``tracer=`` (an ``obs.trace.Tracer``) records JAX's spans: a
``request`` span per request (submit -> terminal, with ``retry`` /
``failover`` / ``degrade`` / ``pin_fp`` / ``watchdog_fired`` / ``shed``
/ ``failed`` / ``result_cache_hit`` events), a ``queue`` child per stay
in the queue (a fresh one after each backoff), and per batch ``form``,
``dispatch``, ``device`` (dispatch to the host's copy of the logits,
with the shard's domain ids) and ``finalize`` spans listing their
requests' ids.  Host clocks only: no span boundary waits on the card.

## The async host loop

``start()`` moves ``step()``/``finalize()`` onto a background thread
behind the (bounded) admission queue: ``submit()`` returns at once,
``wait()`` blocks until a request set is terminal, ``stop()`` drains and
joins.  Every public entry point takes the same RLock.  The loop runs on
the device and stream that were current where ``start()`` was called.  A
watchdog (``watchdog_ms``) declares a batch in flight longer than the
bound hung: a typed ``DeadlineExceeded`` through the same failure path,
so (off the card) the ladder moves and the requests retry on a rebuilt
executor.

``result_cache`` puts an image-hash response cache in front of
admission: a repeated image completes at ``submit()``.  Only healthy
results enter it (an undegraded executor, finite logits).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.common.errors import (
    CapacityExceeded, DeadlineExceeded, DeviceLostError, ExecutorError,
    MeshExhausted, NumericsError, ReproError)
from repro_torch.serving.executors import ExecutorCache
from repro_torch.serving.telemetry import Telemetry

__all__ = ["Request", "BucketedPolicy", "FixedMicrobatchPolicy",
           "ManualClock", "MicroBatchScheduler", "ResultCache"]


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
    retries: int = 0                     # failed dispatch attempts so far
    # tracing handles (obs.trace spans; None without a tracer): ``span``
    # is the request's root span (submit -> terminal), ``qspan`` the open
    # queue-residency child (one per stay in the queue or in backoff)
    span: Optional[object] = dataclasses.field(default=None, repr=False)
    qspan: Optional[object] = dataclasses.field(default=None, repr=False)

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


class ResultCache:
    """Image-hash -> logits LRU in front of admission.

    Keys are content hashes (blake2b over the fp32 image bytes plus the
    shape), so a byte-identical resubmission completes without occupying
    a batch slot.  ``put`` refuses non-finite logits.
    """

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lru: "collections.OrderedDict[tuple, np.ndarray]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(image) -> tuple:
        a = np.ascontiguousarray(np.asarray(image, np.float32))
        return (hashlib.blake2b(a.tobytes(), digest_size=16).hexdigest(),
                a.shape)

    def get(self, image) -> Optional[np.ndarray]:
        k = self.key(image)
        hit = self._lru.get(k)
        if hit is None:
            self.misses += 1
            return None
        self._lru.move_to_end(k)
        self.hits += 1
        return hit

    def put(self, image, logits) -> bool:
        arr = np.asarray(logits)
        if not np.all(np.isfinite(arr)):
            return False     # integrity guard: never cache corruption
        k = self.key(image)
        self._lru[k] = arr
        self._lru.move_to_end(k)
        while len(self._lru) > self.capacity:
            self._lru.popitem(last=False)
        return True

    def __len__(self) -> int:
        return len(self._lru)


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


@dataclasses.dataclass
class _InFlight:
    """One dispatched batch: its device output, requests, bucket key,
    executor (kept alive while the batch runs), dispatch time, on the
    card an event recorded after it, and its ``device`` span."""
    out: object
    reqs: list
    key: tuple
    ex: object
    t: float
    done: Optional[torch.cuda.Event] = None
    devspan: Optional[object] = None


class MicroBatchScheduler:
    """Admission queues + batch formation + asynchronous dispatch over
    an ``ExecutorCache``::

        sched = MicroBatchScheduler(cache, params)
        for req in arriving:   sched.submit(req); sched.step()
        sched.step(drain=True)
        sched.finalize()       # req.logits populated

    or one-shot: ``sched.serve(requests) -> (n, num_classes)``.

    Fault-tolerance knobs (all inert by default): ``max_queue_depth``
    bounds total admission (beyond it, submits shed with
    ``CapacityExceeded``); ``max_retries`` / ``backoff_ms`` /
    ``backoff_base`` shape the retry-with-exponential-backoff policy;
    ``faults`` is a ``serving.faults.FaultPlan`` consulted at admission
    (the "queue.overload" point); ``watchdog_ms`` bounds a batch's time
    in flight; ``result_cache`` is the capacity of a ``ResultCache``;
    ``tracer`` an ``obs.trace.Tracer`` (None: tracing off).
    """

    def __init__(self, cache: ExecutorCache, params, *, policy=None,
                 telemetry: Telemetry | None = None, clock=None,
                 max_queue_depth: int | None = None, max_retries: int = 4,
                 backoff_ms: float = 10.0, backoff_base: float = 2.0,
                 faults=None, watchdog_ms: float | None = None,
                 result_cache: int | None = None, tracer=None):
        self.cache = cache
        self.params = params
        # obs.trace.Tracer (or None): span recording is host-clock only,
        # two clock reads and a deque append per boundary
        self.tracer = tracer
        self.policy = policy if policy is not None else BucketedPolicy()
        self.telemetry = (telemetry if telemetry is not None
                          else cache.telemetry)
        self.clock = clock if clock is not None else time.monotonic
        self.max_queue_depth = max_queue_depth
        self.max_retries = int(max_retries)
        self.backoff_ms = float(backoff_ms)
        self.backoff_base = float(backoff_base)
        self.faults = faults
        self.watchdog_ms = watchdog_ms
        self.results = ResultCache(result_cache) \
            if result_cache is not None else None
        self._queues: dict[int, collections.deque] = {}
        self._pending: List[_InFlight] = []
        self._hung: List[_InFlight] = []   # abandoned, maybe still running
        self._retry: list = []       # (not_before, resolution, requests)
        self._lock = threading.RLock()
        self._work = threading.Condition(self._lock)
        self._thread: Optional[threading.Thread] = None
        self._stopping = False

    def _device(self):
        return getattr(self.cache, "device", None)

    # -- tracing helpers (no-ops without a tracer) -----------------------
    def _t_end(self, span, **attrs) -> None:
        if self.tracer is not None and span is not None:
            self.tracer.end(span, **attrs)

    def _t_event(self, req: Request, name: str, **attrs) -> None:
        if self.tracer is not None:
            self.tracer.event(req.span, name, **attrs)

    def _t_close(self, req: Request, status: str) -> None:
        """Close a request's open spans at a terminal transition."""
        if self.tracer is None:
            return
        self._t_end(req.qspan)
        req.qspan = None
        self._t_end(req.span, status=status)

    # -- terminal states (the no-lost / no-duplicated invariant) ---------
    def _shed(self, req: Request, err: ReproError) -> None:
        assert req.status == "pending", (req.rid, req.status)
        req.status, req.error = "shed", err
        self.telemetry.count("shed")
        self.telemetry.count(
            "shed_deadline" if isinstance(err, DeadlineExceeded)
            else "shed_capacity")
        self._t_event(req, "shed", error=type(err).__name__)
        self._t_close(req, "shed")

    def _fail(self, req: Request, err: ReproError) -> None:
        assert req.status == "pending", (req.rid, req.status)
        req.status, req.error = "failed", err
        self.telemetry.count("failed")
        self._t_event(req, "failed", error=type(err).__name__)
        self._t_close(req, "failed")

    # -- admission -------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Admit one request; returns False when it was shed instead
        (bounded queue / overload fault), with ``req.error`` typed.  A
        result-cache hit completes the request here, before the queue
        bound is consulted."""
        with self._lock:
            req.arrival = self.clock()
            self.telemetry.count("submitted")
            if self.tracer is not None:
                req.span = self.tracer.begin(
                    "request", rid=req.rid, resolution=req.resolution)
            if self.results is not None:
                hit = self.results.get(req.image)
                if hit is not None:
                    req.logits = np.array(hit)
                    req.status = "completed"
                    self.telemetry.count("result_cache_hit")
                    self.telemetry.count("completed")
                    self._t_event(req, "result_cache_hit")
                    self._t_close(req, "completed")
                    return True
                self.telemetry.count("result_cache_miss")
            if self.faults is not None:
                try:
                    self.faults.fire("queue.overload",
                                     resolution=req.resolution)
                except CapacityExceeded as e:
                    self._shed(req, e)
                    return False
            if self.max_queue_depth is not None \
                    and self.queue_depth() >= self.max_queue_depth:
                self._shed(req, CapacityExceeded(
                    f"admission queue full ({self.max_queue_depth}); "
                    f"request {req.rid} shed"))
                return False
            if self.tracer is not None:
                req.qspan = self.tracer.begin("queue", parent=req.span)
            self._queues.setdefault(req.resolution,
                                    collections.deque()).append(req)
            self._work.notify_all()
            return True

    def queue_depth(self, resolution: int | None = None) -> int:
        with self._lock:
            if resolution is not None:
                return len(self._queues.get(resolution, ()))
            return sum(len(q) for q in self._queues.values())

    def outstanding(self) -> int:
        """Requests not yet terminal: queued + awaiting retry + in
        flight on the device."""
        with self._lock:
            return (self.queue_depth()
                    + sum(len(reqs) for _, _, reqs in self._retry)
                    + sum(len(e.reqs) for e in self._pending))

    # -- batch formation + dispatch -------------------------------------
    def _due(self, q) -> bool:
        now = self.clock()
        return any(r.deadline_ms is not None
                   and now >= r.arrival + r.deadline_ms / 1e3 for r in q)

    def _expired(self, req: Request, now: float) -> bool:
        return req.timeout_ms is not None \
            and now > req.arrival + req.timeout_ms / 1e3

    def _sweep_expired(self) -> int:
        """Shed every queued or retry-parked request whose hard deadline
        passed, before batch formation, so none occupies a slot."""
        now = self.clock()
        shed = 0
        for res, q in self._queues.items():
            keep = collections.deque()
            for r in q:
                if self._expired(r, now):
                    self._shed(r, DeadlineExceeded(
                        f"request {r.rid} expired after "
                        f"{r.timeout_ms:g} ms in queue"))
                    shed += 1
                else:
                    keep.append(r)
            self._queues[res] = keep
        retry = []
        for not_before, res, reqs in self._retry:
            live = []
            for r in reqs:
                if self._expired(r, now):
                    self._shed(r, DeadlineExceeded(
                        f"request {r.rid} expired after "
                        f"{r.timeout_ms:g} ms (while backing off)"))
                    shed += 1
                else:
                    live.append(r)
            if live:
                retry.append((not_before, res, live))
        self._retry = retry
        return shed

    def _requeue_ripe_retries(self, drain: bool) -> None:
        """Move retry groups whose backoff elapsed back to the front of
        their admission queue (they are the oldest requests)."""
        now = self.clock()
        parked = []
        for not_before, res, reqs in self._retry:
            if drain or now >= not_before:
                q = self._queues.setdefault(res, collections.deque())
                for r in reversed(reqs):
                    q.appendleft(r)
            else:
                parked.append((not_before, res, reqs))
        self._retry = parked

    def step(self, *, drain: bool = False) -> int:
        """Form and dispatch every ready batch; returns the number of
        requests dispatched.  ``drain=True`` treats all queues as due
        (and retries at once, ignoring remaining backoff)."""
        with self._lock:
            self._check_watchdog()
            self._sweep_expired()
            self._requeue_ripe_retries(drain)
            dispatched = 0
            for res, q in list(self._queues.items()):
                due = drain or self._due(q)
                for size in self.policy.form(len(q), self.cache.buckets,
                                             due):
                    take = min(size, len(q))
                    if take == 0:
                        break
                    reqs = [q.popleft() for _ in range(take)]
                    if self.tracer is not None:
                        with self.tracer.span(
                                "form", resolution=res, bucket=size,
                                rids=[r.rid for r in reqs]):
                            for r in reqs:
                                self._t_end(r.qspan)
                                r.qspan = None
                    self._dispatch(res, reqs, size)
                    dispatched += take
            return dispatched

    def _stage(self, reqs: List[Request], bucket: int, resolution: int):
        """The batch as one fp32 host tensor, padded with zeros to the
        bucket; pinned on a card, so the executor's copy into its static
        input does not wait."""
        imgs = np.zeros((bucket, resolution, resolution, 3), np.float32)
        for i, r in enumerate(reqs):
            imgs[i] = np.asarray(r.image, np.float32)
        x = torch.from_numpy(imgs)
        dev = self._device()
        if dev is not None and dev.type == "cuda":
            x = x.pin_memory()
        return x

    def _dispatch(self, resolution: int, reqs: List[Request],
                  bucket: int) -> None:
        now = self.clock()
        key = (bucket, resolution, self.cache.precision)
        rids = [r.rid for r in reqs]
        dspan = None
        if self.tracer is not None:
            dspan = self.tracer.begin(
                "dispatch", rids=rids, bucket=bucket,
                resolution=resolution, precision=self.cache.precision)
        try:
            ex = self.cache.get(bucket, resolution)
        except ReproError as e:
            self._t_end(dspan, error=type(e).__name__)
            self._on_failure(resolution, reqs, key, e)
            return
        try:
            out = ex(self.params, self._stage(reqs, bucket, resolution))
        except ReproError as e:
            self._t_end(dspan, error=type(e).__name__)
            self._on_failure(resolution, reqs, key, e, ex=ex)
            return
        done = None
        dev = self._device()
        if dev is not None and dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
        self.telemetry.record_dispatch(
            key, len(reqs), bucket,
            queue_depth=len(self._queues.get(resolution, ())),
            wait_ms=[(now - r.arrival) * 1e3 for r in reqs])
        if getattr(ex, "shard", None) is not None:
            self.telemetry.record_device_dispatch(
                ex.device_ids, len(reqs), bucket)
        # the "device" span is the host-observed in-flight window:
        # dispatch -> the host's copy of the logits; nothing waits here
        devspan = None
        if self.tracer is not None:
            devspan = self.tracer.begin(
                "device", rids=rids, bucket=bucket, resolution=resolution,
                devices=list(getattr(ex, "device_ids", ()) or ()))
        self._pending.append(_InFlight(out, reqs, key, ex, now, done,
                                       devspan))
        self._t_end(dspan)

    # -- failure handling: retry/backoff + the degradation ladder --------
    def _on_failure(self, resolution: int, reqs: List[Request], key,
                    err: ReproError, ex=None) -> None:
        """One dispatch (or finalize) attempt failed for a whole group.

        Attempt 1 of a transient error retries the same executor after
        backoff; from attempt 2 on (or at once for persistent errors) the
        cache's degradation ladder moves (the blamed site demoted, then
        the reference interpreter), and a numerics error pins the bucket
        to fp at once.  Requests whose retry budget is spent terminate as
        "failed"; the rest park in the retry buffer with exponential
        backoff.  On the card only an injected fault moves the ladder.

        Two sharding branches, as JAX's: a ``DeviceLostError`` shrinks
        the mesh instead of moving the ladder (the survivors keep their
        fused plans) and the group retries; an exhausted mesh fails the
        group at once, typed ``MeshExhausted``, with no retry.
        """
        self.telemetry.count("dispatch_failures")
        self.telemetry.record_error(key)
        attempt = max(r.retries for r in reqs) + 1
        for r in reqs:
            r.retries = attempt
        bucket = key[0]
        blamed = getattr(err, "site", None)
        dev = self._device()
        if dev is not None and dev.type == "cuda" and not err.injected \
                and not isinstance(err, MeshExhausted):
            # a real failure on the card: the ladder would replan onto the
            # reference path's plain PyTorch, and a shrink would drop a
            # domain no drill named; retry the same executor and end
            # "failed" instead
            self.telemetry.count("real_failures")
        elif isinstance(err, DeviceLostError):
            lost = err.device
            health = getattr(self.cache, "health", None)
            if lost is None and ex is not None and health is not None:
                lost = health.attribute(err, ex.shard)
            if getattr(self.cache, "on_device_lost", None) is not None \
                    and self.cache.on_device_lost(lost):
                self.telemetry.count("device_failover", len(reqs))
                for r in reqs:
                    self._t_event(r, "failover", device=lost,
                                  error=type(err).__name__)
        elif isinstance(err, NumericsError):
            # fake caches in tests may return None; attrs read softly
            state = self.cache.pin_fp(bucket, resolution)
            for r in reqs:
                self._t_event(r, "pin_fp", site=blamed,
                              level=getattr(state, "level", None),
                              error=type(err).__name__)
        elif not isinstance(err, MeshExhausted) \
                and (not err.transient or attempt >= 2):
            state = self.cache.degrade(bucket, resolution, site=blamed)
            for r in reqs:
                self._t_event(r, "degrade", site=blamed,
                              level=getattr(state, "level", None),
                              demoted=sorted(getattr(state, "demoted",
                                                     ()) or ()),
                              error=type(err).__name__)
        if isinstance(err, MeshExhausted) \
                or getattr(self.cache, "mesh_exhausted", False):
            if not isinstance(err, MeshExhausted):
                err = MeshExhausted(
                    f"mesh exhausted while serving {key}: {err}", key=key)
            for r in reqs:
                self._fail(r, err)
            return
        if attempt > self.max_retries:
            for r in reqs:
                self._fail(r, err)
            return
        self.telemetry.count("retries", len(reqs))
        not_before = self.clock() + self.backoff_ms / 1e3 \
            * self.backoff_base ** (attempt - 1)
        if self.tracer is not None:
            for r in reqs:
                self._t_event(r, "retry", attempt=attempt,
                              error=type(err).__name__, site=blamed)
                # backoff is queue time: a fresh residency span
                self._t_end(r.qspan)
                r.qspan = self.tracer.begin("queue", parent=r.span,
                                            retry=attempt)
        self._retry.append((not_before, resolution, list(reqs)))

    # -- completion ------------------------------------------------------
    def finalize(self) -> int:
        """Wait for outstanding dispatches (in dispatch order), scatter
        logits onto requests, stamp completion latency.  Returns the
        number of requests completed.

        A failure raised while materializing an output, or non-finite
        logits (the int8 epilogue blow-up signature), routes the batch
        through the same retry/degradation path as a dispatch failure:
        call ``step()`` again afterwards to re-dispatch.
        """
        with self._lock:
            self._check_watchdog()
            done = 0
            pending, self._pending = self._pending, []
            for e in pending:
                key, reqs = e.key, e.reqs
                try:
                    arr = _to_host(e.out)          # waits on this batch
                except ReproError as err:
                    self._t_end(e.devspan, error=type(err).__name__)
                    self._on_failure(key[1], reqs, key, err, ex=e.ex)
                    continue
                except RuntimeError as err:        # untyped device error
                    self._t_end(e.devspan, error=type(err).__name__)
                    self._on_failure(key[1], reqs, key, ExecutorError(
                        f"materializing executor {key} output failed: "
                        f"{err}", key=key), ex=e.ex)
                    continue
                self._t_end(e.devspan)
                fspan = None
                if self.tracer is not None:
                    fspan = self.tracer.begin(
                        "finalize", rids=[r.rid for r in reqs],
                        bucket=key[0], resolution=key[1])
                if not np.all(np.isfinite(arr[:len(reqs)])):
                    self._t_end(fspan, error="NumericsError")
                    err = NumericsError(
                        f"non-finite logits delivered by executor {key} "
                        f"(int8 epilogue blow-up signature)", key=key)
                    err.injected = getattr(e.out, "injected", False)
                    self._on_failure(key[1], reqs, key, err, ex=e.ex)
                    continue
                t = self.clock()
                degraded = getattr(e.ex, "degraded", None)
                healthy = degraded is None or not degraded.degraded
                for i, r in enumerate(reqs):
                    assert r.status == "pending", (r.rid, r.status)
                    r.logits = arr[i]
                    r.status = "completed"
                    # only undegraded, finite results may be replayed
                    if self.results is not None and healthy \
                            and self.results.put(r.image, arr[i]):
                        self.telemetry.count("result_cache_store")
                    self._t_close(r, "completed")
                self.telemetry.record_latency(
                    key, [(t - r.arrival) * 1e3 for r in reqs])
                self._t_end(fspan)
                done += len(reqs)
            self.telemetry.count("completed", done)
            if done:
                self._work.notify_all()
            return done

    # -- the watchdog ----------------------------------------------------
    def _check_watchdog(self) -> int:
        """Convert hung in-flight batches into typed failures.

        A dispatched batch whose output has not been read within
        ``watchdog_ms`` is declared hung: its output is dropped and the
        group routes through ``_on_failure`` as a ``DeadlineExceeded``,
        persistent, so the ladder moves at once and the retry lands on a
        rebuilt executor (on the card only a drill's fault moves it).  The hung entry keeps its executor (and graph)
        alive until the device has finished with it.  Returns the number
        of batches declared hung.
        """
        self._hung = [e for e in self._hung
                      if e.done is not None and not e.done.query()]
        if self.watchdog_ms is None or not self._pending:
            return 0
        now = self.clock()
        keep, hung = [], []
        for e in self._pending:
            (hung if now - e.t > self.watchdog_ms / 1e3
             else keep).append(e)
        self._pending = keep
        for e in hung:
            self.telemetry.count("watchdog_fired")
            self._hung.append(e)
            self._t_end(e.devspan, error="watchdog")
            for r in e.reqs:
                self._t_event(r, "watchdog_fired", bucket=e.key[0])
            self._on_failure(e.key[1], e.reqs, e.key, DeadlineExceeded(
                f"batch {e.key} in flight for {(now - e.t) * 1e3:.0f} ms "
                f"(watchdog bound {self.watchdog_ms:g} ms): declared hung",
                key=e.key), ex=e.ex)
        return len(hung)

    # -- the async host loop ---------------------------------------------
    def start(self, poll_s: float = 0.002) -> "MicroBatchScheduler":
        """Run ``step()``/``finalize()`` on a background thread, on the
        device and stream current here.  ``poll_s`` bounds how long the
        loop sleeps when idle: deadline flushes, backoff expiry and the
        watchdog are all polled at least this often."""
        with self._lock:
            if self._thread is not None:
                return self
            self._stopping = False
            dev = self._device()
            stream = (torch.cuda.current_stream(dev)
                      if dev is not None and dev.type == "cuda" else None)
            self._thread = threading.Thread(
                target=self._loop, args=(float(poll_s), stream),
                name="microbatch-scheduler", daemon=True)
            self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread is not None

    def _loop(self, poll_s: float, stream) -> None:
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                with self._lock:
                    if self._stopping:
                        return
                    self.step()
                    if self._pending:
                        self.finalize()
                    self._work.wait(timeout=poll_s)

    def stop(self, *, drain: bool = True) -> None:
        """Join the host loop; ``drain=True`` first serves everything
        still outstanding (retries included) on the caller's thread."""
        with self._lock:
            if self._thread is None:
                return
            self._stopping = True
            self._work.notify_all()
            thread, self._thread = self._thread, None
        thread.join()
        if drain:
            while self.outstanding():
                self.step(drain=True)
                self.finalize()

    def wait(self, requests: List[Request],
             timeout_s: float | None = None) -> bool:
        """Block until every request in ``requests`` is terminal.
        Returns False on timeout.  Only meaningful with the host loop
        running: nothing else makes progress while the caller blocks."""
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        with self._lock:
            while any(r.status == "pending" for r in requests):
                left = None if deadline is None \
                    else deadline - time.monotonic()
                if left is not None and left <= 0:
                    return False
                self._work.wait(timeout=0.05 if left is None
                                else min(0.05, left))
            return True

    # -- one-shot --------------------------------------------------------
    def serve(self, requests: List[Request]) -> np.ndarray:
        """Submit, drain, finalize (looping until every request is
        terminal, retries included); logits stacked in request order.
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


def _to_host(out) -> np.ndarray:
    """An executor's output as an fp32 host array (waits for it)."""
    if isinstance(out, torch.Tensor):
        return out.float().cpu().numpy()
    return np.asarray(out, np.float32)
