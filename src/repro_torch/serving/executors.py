"""Shape-bucketed executor cache over the Program IR.

Counterpart of ``repro/serving/executors.py``.  An ``Executor`` is one
specialized pipeline for an ``ExecutorKey = (batch bucket, resolution,
precision)``:

    lower(cfg, batch, image_size)   -> Program     (cached, per shape)
    plan_program(program, params)   -> FusionPlan  (once per key, before
                                       the warm-up and the capture: a
                                       cold autotune cache sweeps here;
                                       blocks inherited from a donor
                                       bucket at the same resolution via
                                       reuse=)
    CUDA graph of execute(...)      -> the compiled forward

Where the JAX package jits ``execute``, the port captures it: on the
card every executor holds one ``torch.cuda.CUDAGraph`` of its forward,
reading a static input buffer, and a call is one copy in, one replay and
one copy of the logits out, with no host wait.  On the CPU the executor
runs ``execute`` eagerly and captures nothing.

``ExecutorCache`` builds executors lazily on first use, serves them LRU
with optional capacity eviction, exposes ``warmup`` and reports cache
behavior into a shared ``Telemetry``.  Each build warms the resident
weight pack of every super-site group of its plan (``weight_pack_built``
/ ``weight_pack_hit``).  The graphs of one cache share one memory pool
and one stream: they capture and replay on that stream one at a time,
under the cache's lock, whichever thread or stream calls.

## Fault tolerance

  * a failed ``lower`` -> ``plan`` -> capture build never leaves a
    half-built entry: nothing is inserted and no donor plan is published
    until the build succeeds, and a warmed entry whose warm-up crashes
    is evicted.  A capture that fails is a build failure, a typed
    ``ExecutorError``; nothing falls back to eager launches;
  * build failures are negative-cached for ``neg_ttl_s`` seconds: a hot
    failing bucket raises a cheap typed ``ExecutorError`` on every
    request instead of rebuilding each time;
  * each key carries a degradation ladder (``DegradeState``): level 0 is
    the normal fused plan, ``degrade(site=...)`` replans with the blamed
    site demoted to the reference path (reason ``"fault"``), a further
    ``degrade`` drops to the reference IR interpreter (``plan=None``),
    and ``pin_fp`` replans at forced-fp precision, the response to an
    int8 numerics blow-up.  A ladder move drops the key's executor (and
    its graph); degraded plans never donate, and the key is built and
    captured again on next use.

## Sharding and per-device fault domains

``ExecutorCache(devices=)`` serves every key over a batch mesh, as JAX's
(``repro/serving/executors.py``, ``serving/sharding.py``): each build
takes the widest shard of the bucket over the surviving domains,
lowers and plans at the local batch and runs one member per domain
(rows split contiguously, params replicated once per physical device).
On the card each member holds its own CUDA graph, captured at the local
batch on its device after an eager warm-up, on a stream of its own (so
the domains of one card overlap) and into one graph pool per physical
device; a member whose capture fails fails the build with a typed
``ExecutorError``, and nothing serves the mesh eagerly or on fewer
members.  ``device.dropout`` fires at a sharded executor's dispatch,
before its replay; ``on_device_lost`` marks the domain dead, evicts
every executor whose shard held it and clears the negative cache; an
exhausted mesh raises ``MeshExhausted`` from ``get`` itself.

## Tracing

``tracer=`` (an ``obs.trace.Tracer``) records each build as an
``executor.build`` span on the ``executors`` track with ``lower`` and
``plan`` children (the warm-up and the capture fall inside it), and the
ladder moves and mesh shrinks as zero-duration marks (``ladder.degrade``,
``ladder.pin_fp``, ``mesh.shrink``), as is the adoption of a schedule
artifact (``artifact.adopt``).  Host clocks only.

## Schedule artifacts

``ExecutorCache(artifact=)`` adopts an offline-searched
``search.ScheduleArtifact`` as JAX's does: ``validate_for`` first (a
typed ``ArtifactError`` before anything is built), then the artifact's
buckets replace the constructor's and its tuner entries are imported.
Each build pins its plan through ``artifact.overrides_for(batch, or the
local batch when sharded; resolution)``, so a covered shape plans with
no tuner consulted and no sweep.  A degraded key plans without the
artifact (the ladder's ``demote=`` wins), and a shape the artifact does
not cover plans normally.  ``overrides=`` and ``artifact=`` together are
refused: one source pins a plan.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device, to_device, tree_to
from repro_torch.common.errors import ExecutorError, MeshExhausted, ReproError
from repro_torch.core.efficientvit import EfficientViTConfig
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import execute, lower
from repro_torch.serving.sharding import (
    DeviceHealth, physical_device, replicate, sharded_forward)
from repro_torch.serving.telemetry import Telemetry

__all__ = ["ExecutorKey", "Executor", "ExecutorCache", "DegradeState"]


@dataclasses.dataclass(frozen=True)
class ExecutorKey:
    batch: int        # bucket size (the batch dimension of the executor)
    resolution: int   # square image size
    precision: str    # requested plan precision: "auto" | "fp" | "int8"
    #                   (int8 plans the FIX8 kernels of a quantized tree)
    epilogues: bool = True   # producer-side int8 emission assigned by the
    #                          plan (the int8 dataflow); False captures the
    #                          consumer-side-quantize pipeline, so both
    #                          dataflows can be cached side by side


@dataclasses.dataclass(frozen=True)
class DegradeState:
    """Where one executor key sits on the graceful-degradation ladder.

    ``level`` 0 = fully fused; 1 = the ``demoted`` sites replanned onto
    the reference path, everything else still fused; 2 = the whole key
    runs the reference IR interpreter (``plan=None``).  ``pinned_fp``
    forces the plan to ``precision="fp"``: for a quantized tree every
    int8 kernel demotes to the reference path, the correctness-preserving
    response to an int8 numerics blow-up.
    """
    level: int = 0
    demoted: frozenset = frozenset()
    pinned_fp: bool = False

    @property
    def degraded(self) -> bool:
        return self.level > 0 or self.pinned_fp


def _pool_bytes(pool) -> Optional[int]:
    """Bytes the caching allocator holds in the graph memory pool
    ``pool`` (pool ids are unique in the process); None where the
    allocator's snapshot does not name pools."""
    total, named = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get("segment_pool_id")
        if pid is not None:
            named = True
            if tuple(pid) == tuple(pool):
                total += seg["total_size"]
    return total if named else None


def _stop_pool_capture(device: torch.device, pool) -> None:
    """After a failed capture, stop the caching allocator from routing
    the capture stream's allocations into the graph pool: PyTorch's
    ``capture_end`` skips that step when ending an invalidated capture
    raises.  Ends every recording into ``pool`` left open (one, as
    observed; the loop is bounded)."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    for _ in range(8):
        try:
            torch.cuda.memory._cuda_endAllocateToPool(index, pool)
        except RuntimeError:     # "not currently recording": all ended
            return


class _Member:
    """One mesh member of an executor (the whole bucket when unsharded):
    rows ``[lo, hi)`` of the bucket on ``device``, with its param tree
    (``None``: the tree the executor is called with); on the card the
    stream and graph pool it captures and replays on, and its graph."""

    def __init__(self, device, lo: int, hi: int, *, params=None,
                 stream=None, pool=None, domain: Optional[int] = None):
        self.device, self.lo, self.hi = device, lo, hi
        self.params = params
        self.stream, self.pool = stream, pool
        self.domain = domain        # mesh id (None when unsharded)
        self.graph = None
        self.static_in = None
        self.static_out = None
        self.replay_launches: dict[str, int] = {}
        self.graph_bytes: Optional[int] = None


class Executor:
    """One (program, plan) pair for a fixed shape.

    On the card, ``warm`` does what the first call of a jitted function
    does: it runs the forward eagerly once on the cache's stream (every
    kernel built and loaded, every ``scalar`` constant and weight pack
    made, first-touch allocations done), then captures the same forward
    into a CUDA graph reading ``static_in``.  ``__call__`` copies its
    input into ``static_in``, replays the graph and returns a fresh copy
    of the graph's output.  All three run on the cache's stream, after
    the work already queued on the caller's stream, and the caller's
    stream waits for them; nothing waits on the host.  ``lock`` is the
    cache's: the graphs of one cache share one memory pool, so no two of
    them may run at once, and no replay may run while one captures.  The
    graph reads the param tree it was captured with, so a call must pass
    that tree.  On the CPU the forward runs eagerly.

    ``members`` are the ``_Member``s that run the bucket: one covering
    it when unsharded; for a sharded executor (``shard``, a
    ``serving.sharding.ShardSpec``, ``program`` lowered at the local
    batch) one per mesh domain, each on its rows of the bucket.  On the
    CPU ``sharding.sharded_forward`` runs them one after another; on the
    card each holds one graph, captured on the member's device and
    stream into its device's pool, replayed one after another under the
    lock, the member streams overlapping on the device.  The outputs are
    gathered in row order on ``device``.  ``graph`` / ``static_in`` are
    the first member's, ``graphs`` all.

    A replay runs no kernel wrapper, so it adds nothing to the wrappers'
    ``launches`` counters; ``replay_launches`` records the launches the
    captures issued (summed over the members; ``member_launches`` per
    member), which every replay repeats on the device.

    ``degraded`` is the key's ``DegradeState`` (None = healthy);
    ``faults`` is an optional ``serving.faults.FaultPlan`` consulted at
    dispatch: "device.dropout" only on sharded executors (before the
    replay), "kernel.launch" faults only on executors that launch fused
    kernels, and "epilogue.numerics" corruption only on executors
    running fused int8 sites, so a degraded rebuild escapes the failure
    it degraded away from.  ``program`` is the plan-annotated lowering
    (``Program.with_epilogues``).
    """

    def __init__(self, key: ExecutorKey, program, plan, device, members, *,
                 faults=None, degraded: Optional[DegradeState] = None,
                 lock=None, shard=None):
        if device.type == "cuda" and (lock is None or any(
                m.stream is None or m.pool is None for m in members)):
            raise ValueError("an executor on the card takes its cache's "
                             "lock and each member's graph pool and stream")
        self.key = key
        self.program = program.with_epilogues(plan) if plan is not None \
            else program
        self.plan = plan
        self.device = device
        self.faults = faults
        self.degraded = degraded
        self.shard = shard       # ShardSpec when mesh-sharded, else None
        self._lock = lock
        self.members = list(members)
        self.calls = 0
        self.warmed = False
        self._params = None
        decisions = plan.decisions.values() if plan is not None else ()
        self.fused_sites = tuple(d.name for d in decisions if d.fused)
        self._runs_int8 = any(d.fused and d.precision == "int8"
                              for d in decisions)

    # -- the members' state, read as one executor's ----------------------
    @property
    def device_ids(self) -> Tuple[int, ...]:
        return self.shard.device_ids if self.shard is not None else ()

    @property
    def graph(self):
        return self.members[0].graph

    @property
    def graphs(self) -> tuple:
        return tuple(m.graph for m in self.members)

    @property
    def static_in(self):
        return self.members[0].static_in

    @property
    def member_launches(self) -> list:
        return [dict(m.replay_launches) for m in self.members]

    @property
    def replay_launches(self) -> dict:
        total: dict[str, int] = {}
        for m in self.members:
            for name, n in m.replay_launches.items():
                total[name] = total.get(name, 0) + n
        return total

    @property
    def graph_bytes(self) -> Optional[int]:
        sizes = [m.graph_bytes for m in self.members]
        return None if None in sizes else sum(sizes)

    def _ctx(self) -> dict:
        k = self.key
        return dict(batch=k.batch, resolution=k.resolution,
                    precision=k.precision)

    def __call__(self, params, x):
        """Dispatch the forward of ``x`` ((n, H, W, 3), n <= the bucket;
        missing rows are zeros) -> (bucket, num_classes).  Asynchronous
        on the card: the result is a device tensor and nothing here waits
        for it."""
        self.calls += 1
        if self.faults is not None and self.shard is not None:
            self.faults.fire("device.dropout", **self._ctx(),
                             devices=self.device_ids)
        if self.faults is not None and self.fused_sites:
            self.faults.fire("kernel.launch", sites=self.fused_sites,
                             **self._ctx())
        k = self.key
        n = int(x.shape[0])
        if not 1 <= n <= k.batch or tuple(x.shape[1:]) != (
                k.resolution, k.resolution, 3):
            raise ValueError(f"executor {k} takes (<= {k.batch}, "
                             f"{k.resolution}, {k.resolution}, 3) images, "
                             f"got {tuple(x.shape)}")
        with torch.inference_mode():
            if self.device.type == "cuda":
                out = self._replay(params, x, n)
            else:
                if n < k.batch:
                    x = torch.cat([x, x.new_zeros((k.batch - n,)
                                                  + tuple(x.shape[1:]))])
                out = self._eager(params, x)
        if self.faults is not None and self._runs_int8:
            out = self.faults.corrupt("epilogue.numerics", out,
                                      **self._ctx())
        return out

    def _eager(self, params, x):
        """The whole bucket's forward, eagerly (the CPU's path)."""
        return sharded_forward(self.program, self.members, x,
                               plan=self.plan, params=params)

    def _replay(self, params, x, n: int):
        caller = torch.cuda.current_stream(self.device)
        outs = []
        with self._lock:
            if not self.warmed:
                self.warm(params)
            if params is not self._params:
                raise ValueError(f"executor {self.key} replays the param "
                                 f"tree it was captured with; got another "
                                 f"tree")
            for m in self.members:
                side = m.stream
                side.wait_stream(caller)
                take = max(0, min(m.hi, n) - m.lo)
                with torch.cuda.stream(side):
                    if take:
                        m.static_in[:take].copy_(x[m.lo:m.lo + take],
                                                 non_blocking=True)
                    if take < m.hi - m.lo:
                        m.static_in[take:].zero_()
                    m.graph.replay()
                    outs.append(m.static_out.clone())
            for m in self.members:
                torch.cuda.current_stream(m.device).wait_stream(m.stream)
        # the allocator must not hand a tensor's memory out again before
        # every stream that uses it is done with it
        for o in outs:
            o.record_stream(torch.cuda.current_stream(o.device))
        if x.device.type == "cuda":
            for m in self.members:
                if m.device == x.device:
                    x.record_stream(m.stream)
        if len(outs) == 1:
            return outs[0]
        return torch.cat([o.to(self.device) for o in outs])

    def warm(self, params) -> "Executor":
        """Run a zero batch once, copied in from the host as requests are,
        outside the request loop; on the card, then capture the graph of
        each member.  A capture that fails raises ``ExecutorError``."""
        if not self.warmed:
            if self.device.type == "cuda":
                with self._lock:
                    for i, m in enumerate(self.members):
                        self._capture(i, m, params)
                    self._params = params
            else:
                k = self.key
                x = to_device(np.zeros((k.batch, k.resolution,
                                        k.resolution, 3), np.float32),
                              self.device)
                with torch.inference_mode():
                    self._eager(params, x)
            self.warmed = True
        return self

    def _capture(self, i: int, m: _Member, params) -> None:
        """Warm member ``m`` eagerly on its stream, then capture its
        forward (at its rows' batch) into its device's pool."""
        from repro_torch.kernels.registry import kernel_wrappers

        k = self.key
        dev, side = m.device, m.stream
        tree = m.params if m.params is not None else params
        x = to_device(np.zeros((m.hi - m.lo, k.resolution, k.resolution,
                                3), np.float32), dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), torch.inference_mode():
            execute(self.program, tree, x, plan=self.plan)
        torch.cuda.synchronize(dev)
        wrappers = kernel_wrappers()
        before = {name: w.launches for name, w in wrappers.items()}
        pool0 = _pool_bytes(m.pool)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side), torch.inference_mode():
                graph.capture_begin(pool=m.pool,
                                    capture_error_mode="thread_local")
                try:
                    out = execute(self.program, tree, x, plan=self.plan)
                finally:
                    graph.capture_end()
        except Exception as e:
            _stop_pool_capture(dev, m.pool)
            where = "" if m.domain is None else \
                f" (member {i}, mesh device {m.domain}, {dev})"
            raise ExecutorError(f"CUDA graph capture failed for "
                                f"executor {self.key}{where}: {e}",
                                key=self.key) from e
        torch.cuda.current_stream(dev).wait_stream(side)
        m.graph, m.static_in, m.static_out = graph, x, out
        m.replay_launches = {
            name: w.launches - before[name] for name, w in wrappers.items()
            if w.launches != before[name]}
        if pool0 is not None:
            m.graph_bytes = _pool_bytes(m.pool) - pool0


class ExecutorCache:
    """LRU cache of ``Executor``s keyed by (batch bucket, resolution).

    ``buckets`` is the ascending set of batch sizes served;
    ``bucket_for(n)`` picks the smallest bucket >= n.  The first plan
    built at a resolution becomes the donor for every later bucket at
    that resolution (``plan_program(..., reuse=)``).  ``device`` defaults
    to the CUDA card (to the first mesh device when ``devices`` is
    given); without one, and without ``device="cpu"``, the constructor
    raises.  ``params`` move to ``device``.  On the card a build ends
    with the executor's warm-up and capture.

    ``devices`` (names or ``torch.device``s, one fault domain each,
    repeats allowed: ``("cuda:0",) * 4`` is four domains on one card,
    ``("cpu",) * 4`` four on the CPU) makes every executor a batch shard
    over the surviving domains of ``health`` (``serving.sharding``);
    ``None`` serves each key on ``device`` alone.

    ``autotune`` lets each key's plan sweep the tuners' candidates on the
    card where the autotune cache has no entry (at build, before the
    warm-up and the capture); ``epilogues`` is ``plan_program``'s switch
    and part of the key; ``overrides`` (``{site: core.fusion.
    SiteOverride}``) reach every plan the cache builds (a ladder
    demotion still wins).  ``faults`` / ``neg_ttl_s`` / ``clock`` are the
    fault-tolerance knobs (see the module docstring); all default to
    inert.  ``tracer`` (an ``obs.trace.Tracer``) records builds, ladder
    moves and mesh shrinks.  ``artifact`` (a ``search.ScheduleArtifact``)
    is adopted as the module docstring says.
    """

    def __init__(self, params, cfg: EfficientViTConfig, *,
                 buckets: Tuple[int, ...] = (1, 2, 4, 8),
                 precision: str = "auto", use_plan: bool = True,
                 autotune: bool = True, epilogues: bool = True,
                 overrides=None, capacity: int | None = None,
                 telemetry: Telemetry | None = None, device=None,
                 faults=None, neg_ttl_s: float = 1.0, clock=None,
                 devices=None, tracer=None, artifact=None):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        if artifact is not None and overrides:
            raise ValueError("ExecutorCache takes overrides= or artifact=, "
                             "not both: one source pins a plan")
        if artifact is not None:
            # a mismatched artifact is refused before anything is built;
            # then the searched buckets replace the constructor's, and
            # the tuner entries seed the cache for the shapes the pins
            # do not cover
            from repro_torch.kernels.autotune import import_entries
            artifact.validate_for(cfg, precision)
            buckets = artifact.buckets
            n_entries = import_entries(artifact.tuner_cache)
            if tracer is not None:
                tracer.end(tracer.begin(
                    "artifact.adopt", track="executors",
                    config=artifact.config_name or artifact.config_hash,
                    buckets=list(artifact.buckets), entries=n_entries))
        self.artifact = artifact
        # obs.trace.Tracer (or None): build spans land on the
        # "executors" track; ladder moves and mesh shrinks are recorded
        # as zero-duration marks.  Host clocks only.
        self.tracer = tracer
        # devices=None -> one device per executor; a device list (even
        # of one) -> every executor is a batch shard over the survivors
        self.health = DeviceHealth.of(devices) if devices is not None \
            else None
        if self.health is not None:
            self.health.tracer = tracer
            self.device = physical_device(
                device if device is not None
                else self.health.devices[0].device)
        else:
            self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.precision = precision
        self.use_plan = use_plan
        self.autotune = autotune
        self.epilogues = epilogues
        self.overrides = dict(overrides or {})
        self.capacity = capacity
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.faults = faults
        self.neg_ttl_s = float(neg_ttl_s)
        self.clock = clock if clock is not None else time.monotonic
        # the param tree per physical device of the mesh (params itself
        # on its own device), shared by every sharded executor
        self._replicas: dict = {}
        # the graphs of one physical device share one memory pool:
        # {device: [pool handle, the executors alive in it (None until
        # the first capture into it)]}
        self._pools: dict = {}
        # member i of every key on device d captures and replays on the
        # stream (d, i) (the allocator reuses a pool's free blocks only
        # on the stream that freed them): the unsharded graphs all share
        # the cache's stream, (device, 0), one after another on it
        self._member_streams: dict = {}
        self.stream = self._member_stream(self.device, 0) \
            if self.device.type == "cuda" else None
        # one build, capture or replay at a time, whichever thread asks
        self._lock = threading.RLock()
        self._lru: "collections.OrderedDict[ExecutorKey, Executor]" = \
            collections.OrderedDict()
        self._donor_plans: dict[int, object] = {}   # resolution -> plan
        self._neg: dict[ExecutorKey, tuple[float, ReproError]] = {}
        self._degrade: dict[ExecutorKey, DegradeState] = {}

    # -- bucket policy ---------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n; the largest when n exceeds all."""
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def chunks_for(self, n: int) -> list[int]:
        """Greedy bucket cover of ``n`` requests: full largest buckets,
        then the smallest bucket that fits the ragged tail."""
        out = []
        big = self.buckets[-1]
        while n >= big:
            out.append(big)
            n -= big
        if n:
            out.append(self.bucket_for(n))
        return out

    # -- graph pools -------------------------------------------------------
    def _pool_entry(self, device) -> list:
        key = physical_device(device) if device.type == "cuda" else device
        entry = self._pools.get(key)
        if entry is None:
            entry = self._pools[key] = [torch.cuda.graph_pool_handle(),
                                        None]
        return entry

    @property
    def pool(self):
        """The graph pool of the cache's own device (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        return self._pool_entry(self.device)[0]

    def _fresh_pool(self, device) -> None:
        """Start another pool on ``device`` (the old one's memory goes
        back at the allocator's next release of cached memory)."""
        entry = self._pool_entry(device)
        entry[0], entry[1] = torch.cuda.graph_pool_handle(), None

    def _usable_pool(self, device):
        """``device``'s pool, after starting a new one if a ladder move
        or an eviction dropped the pool's last graph: PyTorch refuses a
        capture into a pool whose graphs are all gone (an internal
        assert) until it has freed the pool.  Returns (pool, the pool's
        live executors, held until the capture ends)."""
        entry = self._pool_entry(device)
        live = list(entry[1] or ())
        if entry[1] is not None and not live:
            self._fresh_pool(device)
        return entry[0], live

    def _member_stream(self, device, slot: int):
        key = (device, slot)
        if key not in self._member_streams:
            self._member_streams[key] = torch.cuda.Stream(device)
        return self._member_streams[key]

    # -- the cache -------------------------------------------------------
    def _key(self, batch: int, resolution: int) -> ExecutorKey:
        return ExecutorKey(int(batch), int(resolution), self.precision,
                           self.epilogues)

    def get(self, batch: int, resolution: int) -> Executor:
        with self._lock:
            key = self._key(batch, resolution)
            ex = self._lru.get(key)
            if ex is not None:
                self._lru.move_to_end(key)
                self.telemetry.count("executor_hit")
                return ex
            neg = self._neg.get(key)
            if neg is not None:
                expiry, cause = neg
                if self.clock() < expiry:
                    # hot failing bucket: answer from the negative cache
                    self.telemetry.count("negative_cache_hit")
                    err = ExecutorError(
                        f"executor {key} failed recently (negative-cached "
                        f"for {self.neg_ttl_s:g}s): {cause}", key=key,
                        site=getattr(cause, "site", None))
                    err.injected = cause.injected
                    raise err from cause
                del self._neg[key]
            self.telemetry.count("executor_miss")
            bspan = None
            if self.tracer is not None:
                bspan = self.tracer.begin(
                    "executor.build", track="executors", bucket=key.batch,
                    resolution=key.resolution, precision=key.precision)
            try:
                ex = self._build(key, parent=bspan)
            except MeshExhausted as e:
                # nothing was built and no domain comes back: the typed
                # error itself, not wrapped and not negative-cached
                self.telemetry.count("executor_build_failed")
                self._t_end(bspan, error=type(e).__name__)
                raise
            except ReproError as e:
                self._note_build_failure(key, e)
                self._t_end(bspan, error=type(e).__name__)
                raise
            except Exception as e:   # untyped crash inside lower/plan
                err = ExecutorError(f"executor build failed for {key}: {e}",
                                    key=key)
                self._note_build_failure(key, err)
                self._t_end(bspan, error=type(e).__name__)
                raise err from e
            self._t_end(bspan, fused_sites=len(ex.fused_sites),
                        degraded=ex.degraded is not None
                        and ex.degraded.degraded)
            self._lru[key] = ex
            while self.capacity is not None \
                    and len(self._lru) > self.capacity:
                evicted, _ = self._lru.popitem(last=False)
                self.telemetry.count("executor_evicted")
                if not any(k.resolution == evicted.resolution
                           for k in self._lru):
                    self._donor_plans.pop(evicted.resolution, None)
            return ex

    # -- tracing helpers (no-ops without a tracer) -----------------------
    def _t_end(self, span, **attrs) -> None:
        if self.tracer is not None and span is not None:
            self.tracer.end(span, **attrs)

    def _t_mark(self, name: str, **attrs) -> None:
        """Zero-duration mark on the executors track (ladder moves, mesh
        shrinks): a begin/end pair at one clock reading."""
        if self.tracer is not None:
            self.tracer.end(self.tracer.begin(name, track="executors",
                                              **attrs))

    def _note_build_failure(self, key: ExecutorKey,
                            err: ReproError) -> None:
        """Count a failed build and negative-cache its key.  Nothing was
        inserted and no donor plan published (both happen only after a
        successful build), so there is nothing to roll back."""
        self.telemetry.count("executor_build_failed")
        if self.neg_ttl_s > 0:
            self._neg[key] = (self.clock() + self.neg_ttl_s, err)

    def _build(self, key: ExecutorKey, parent=None) -> Executor:
        # pick the device slice first: an exhausted mesh raises its typed
        # error before any build work (or build fault) runs
        shard = self.health.shard_for(key.batch) \
            if self.health is not None else None
        if self.faults is not None:
            self.faults.fire("executor.compile", batch=key.batch,
                             resolution=key.resolution,
                             precision=key.precision)
        state = self._degrade.get(key)
        lspan = None
        if self.tracer is not None:
            lspan = self.tracer.begin("lower", parent=parent)
        # a sharded executor lowers and plans at the LOCAL batch: each
        # member runs its own slice of the bucket
        program = lower(self.cfg,
                        batch=shard.local_batch if shard is not None
                        else key.batch,
                        image_size=key.resolution)
        self._t_end(lspan)
        plan, donate = None, False
        if self.use_plan and not (state is not None and state.level >= 2):
            precision = "fp" if (state is not None and state.pinned_fp) \
                else self.precision
            donor = self._donor_plans.get(key.resolution)
            pspan = None
            if self.tracer is not None:
                pspan = self.tracer.begin("plan", parent=parent,
                                          reused_donor=donor is not None)
            overrides = self.overrides
            if self.artifact is not None \
                    and (state is None or not state.degraded):
                # the searched plan, pinned; None for a shape the
                # artifact does not cover (a sharded local batch it
                # lacks), which plans normally
                overrides = self.artifact.overrides_for(
                    shard.local_batch if shard is not None else key.batch,
                    key.resolution)
            plan = plan_program(program, self.params, precision=precision,
                                reuse=donor, autotune=self.autotune,
                                epilogues=self.epilogues,
                                overrides=overrides,
                                demote=(state.demoted if state is not None
                                        else ()))
            self._t_end(pspan)
            self.telemetry.count("plans_built")
            reused = sum(d.reused for d in plan.decisions.values())
            if reused:
                self.telemetry.count("plan_sites_reused", reused)
            # degraded plans never become donors: their demotions and
            # forced precision must not leak into healthy buckets
            donate = donor is None and (state is None or not state.degraded)
        # (device, mesh id, param tree) per member: a sharded key's params
        # replicated once per physical device of the shard (every key
        # reuses the trees already moved), None for the call's own tree
        if shard is None:
            spots = [(self.device, None, None)]
        else:
            replicate(self.params, shard.devices, self._replicas)
            spots = [(d.device, d.id, self._replicas[d.device])
                     for d in shard.devices]
        if plan is not None:
            # one resident pack per physical device: the domains of one
            # card share one tree
            trees = {id(t): t for t in (tree if tree is not None
                                        else self.params
                                        for _, _, tree in spots)}
            for tree in trees.values():
                self._warm_weight_packs(program, plan, tree)
        ex = self._new_executor(key, program, plan, state, shard, spots)
        if donate:
            self._donor_plans[key.resolution] = plan
        return ex

    def _new_executor(self, key, program, plan, state, shard, spots):
        """The executor of a built (program, plan), one member per
        (device, mesh id, param tree) of ``spots``; on the card its
        members warm up and capture here, and a capture that fails
        fails the build."""
        cuda = self.device.type == "cuda"
        held = []        # the pools' live executors, until capture ends
        members = []
        for i, (dev, domain, tree) in enumerate(spots):
            pool = stream = None
            if cuda:
                pool, live = self._usable_pool(dev)
                held += live
                stream = self._member_stream(dev, i)
            lo, hi = shard.rows(i) if shard is not None else (0, key.batch)
            members.append(_Member(dev, lo, hi, params=tree, stream=stream,
                                   pool=pool, domain=domain))
        ex = Executor(key, program, plan, self.device, members,
                      faults=self.faults, degraded=state, lock=self._lock,
                      shard=shard)
        if not cuda:
            return ex
        try:
            ex.warm(self.params)   # a capture that fails fails the build
        except ExecutorError:
            # PyTorch refuses every later capture into a pool that saw a
            # failed one ("already recording to mempool_id"): later
            # builds capture into fresh pools, and the graphs already
            # captured keep theirs
            for m in ex.members:
                if m.pool == self._pool_entry(m.device)[0]:
                    self._fresh_pool(m.device)
            raise
        for m in ex.members:
            entry = self._pool_entry(m.device)
            if entry[1] is None:
                entry[1] = weakref.WeakSet()
            entry[1].add(ex)
        del held
        return ex

    def _warm_weight_packs(self, program, plan, params) -> None:
        """Build (or hit) the resident weight pack of every super-site
        group of ``plan`` on ``params`` at build time, so no request pays
        the packing, and count which.  The pack cache keys on (param
        tree, precision, chain), not on resolution or batch: every
        bucket after the first counts a ``weight_pack_hit``, and each
        physical device of a mesh holds one pack (``weight_pack_built``
        once per device)."""
        if not plan.groups:
            return
        from repro_torch.core.program import SuperSite
        from repro_torch.kernels.supersite.pack import get_pack
        for g in plan.groups.values():
            sup = SuperSite.of(program, g.members, name=g.name)
            _, hit = get_pack(params, sup, g.precision)
            self.telemetry.count(
                "weight_pack_hit" if hit else "weight_pack_built")

    # -- per-device fault domains ----------------------------------------
    @property
    def mesh_exhausted(self) -> bool:
        """True when a device mesh is configured and fully dead."""
        return self.health is not None and self.health.exhausted

    def on_device_lost(self, device_id: int | None) -> bool:
        """Shrink the mesh around a dead domain.

        Marks it dead in the health registry, evicts every cached
        executor whose shard held it (the next ``get`` replans on the
        survivors at the new local batch; a dispatch still in flight
        holds its own executor and graphs) and clears the negative
        cache, whose entries may record failures the dead domain caused.
        Donor plans survive.  Returns True when the mesh shrank (a newly
        dead domain)."""
        if self.health is None or device_id is None:
            return False
        with self._lock:
            if not self.health.mark_dead(device_id):
                return False
            self.telemetry.count("device_lost")
            self.telemetry.record_device_error(device_id, lost=True)
            self._t_mark("mesh.shrink", device=device_id,
                         alive=self.health.n_alive,
                         epoch=self.health.epoch)
            stale = [k for k, ex in self._lru.items()
                     if ex.shard is not None and device_id in ex.device_ids]
            for k in stale:
                del self._lru[k]
            self._neg.clear()
            if not self.health.exhausted:
                self.telemetry.count("mesh_shrunk")
            return True

    # -- the degradation ladder ------------------------------------------
    def degradation(self, batch: int, resolution: int
                    ) -> Optional[DegradeState]:
        """The key's ladder state (None = healthy, never degraded)."""
        return self._degrade.get(self._key(batch, resolution))

    def _apply_degrade(self, key: ExecutorKey, state: DegradeState,
                       counter: str) -> DegradeState:
        with self._lock:
            self._degrade[key] = state
            # drop the current executor, its graph with it (a dispatch
            # still in flight holds its own reference), and any negative
            # entry, so the next get() rebuilds at the new level
            self._lru.pop(key, None)
            self._neg.pop(key, None)
            self.telemetry.count(counter)
            return state

    def degrade(self, batch: int, resolution: int, *,
                site: str | None = None) -> DegradeState:
        """Move one key down the ladder after a fused-launch or build
        failure: demote the blamed ``site`` first (everything else stays
        fused); with no site to blame, or when the demoted plan failed
        too, fall to the reference IR interpreter."""
        key = self._key(batch, resolution)
        state = self._degrade.get(key, DegradeState())
        if site is not None and state.level == 0:
            state = dataclasses.replace(
                state, level=1, demoted=state.demoted | {site})
        elif site is not None and state.level == 1 \
                and site not in state.demoted:
            state = dataclasses.replace(
                state, demoted=state.demoted | {site})
        else:
            state = dataclasses.replace(state, level=2)
        self._t_mark("ladder.degrade", bucket=key.batch,
                     resolution=key.resolution, site=site,
                     level=state.level, demoted=sorted(state.demoted))
        return self._apply_degrade(key, state, "degraded")

    def pin_fp(self, batch: int, resolution: int) -> DegradeState:
        """Pin one key's plan to forced-fp precision, the response to
        detected int8 NaN/overflow: on a quantized tree every int8 kernel
        demotes to the reference path, so correctness survives while the
        key stays captured."""
        key = self._key(batch, resolution)
        state = dataclasses.replace(
            self._degrade.get(key, DegradeState()), pinned_fp=True)
        self._t_mark("ladder.pin_fp", bucket=key.batch,
                     resolution=key.resolution, level=state.level)
        return self._apply_degrade(key, state, "pinned_fp")

    # -- introspection / lifecycle --------------------------------------
    def keys(self) -> Tuple[ExecutorKey, ...]:
        """Currently cached keys, least- to most-recently used."""
        return tuple(self._lru)

    def __len__(self) -> int:
        return len(self._lru)

    def warmup(self, resolutions, buckets=None) -> "ExecutorCache":
        """Build and warm every (bucket, resolution) pair before traffic
        arrives (on the card the build captures).  An entry whose warm
        run crashes is evicted before the error propagates."""
        for res in resolutions:
            for b in (buckets if buckets is not None else self.buckets):
                ex = self.get(b, res)
                try:
                    ex.warm(self.params)
                except Exception:
                    self._lru.pop(ex.key, None)
                    self.telemetry.count("executor_build_failed")
                    raise
        return self
