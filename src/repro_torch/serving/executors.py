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

Sharding and per-device fault domains (``devices=``), schedule artifacts
and tracing are later slices of the port.
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
from repro_torch.common.errors import ExecutorError, ReproError
from repro_torch.core.efficientvit import EfficientViTConfig
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import execute, lower
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

    A replay runs no kernel wrapper, so it adds nothing to the wrappers'
    ``launches`` counters; ``replay_launches`` records the launches the
    capture issued, which every replay repeats on the device.

    ``degraded`` is the key's ``DegradeState`` (None = healthy);
    ``faults`` is an optional ``serving.faults.FaultPlan`` consulted at
    dispatch: "kernel.launch" faults only fire on executors that launch
    fused kernels, and "epilogue.numerics" corruption only on executors
    running fused int8 sites, so a degraded rebuild escapes the failure
    it degraded away from.
    """

    def __init__(self, key: ExecutorKey, program, plan, device, *,
                 faults=None, degraded: Optional[DegradeState] = None,
                 pool=None, stream=None, lock=None):
        if device.type == "cuda" and None in (pool, stream, lock):
            raise ValueError("an executor on the card takes its cache's "
                             "graph pool, stream and lock")
        self.key = key
        self.program = program
        self.plan = plan
        self.device = device
        self.faults = faults
        self.degraded = degraded
        self.pool = pool
        self.stream = stream     # warms, captures and replays the graph
        self._lock = lock
        self.calls = 0
        self.warmed = False
        self.graph = None
        self.static_in = None
        self._static_out = None
        self._params = None
        self.replay_launches: dict[str, int] = {}
        self.graph_bytes: Optional[int] = None
        decisions = plan.decisions.values() if plan is not None else ()
        self.fused_sites = tuple(d.name for d in decisions if d.fused)
        self._runs_int8 = any(d.fused and d.precision == "int8"
                              for d in decisions)

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
                out = execute(self.program, params, x, plan=self.plan)
        if self.faults is not None and self._runs_int8:
            out = self.faults.corrupt("epilogue.numerics", out,
                                      **self._ctx())
        return out

    def _replay(self, params, x, n: int):
        caller = torch.cuda.current_stream(self.device)
        with self._lock:
            if self.graph is None:
                self.warm(params)
            if params is not self._params:
                raise ValueError(f"executor {self.key} replays the param "
                                 f"tree it was captured with; got another "
                                 f"tree")
            side = self.stream
            side.wait_stream(caller)
            with torch.cuda.stream(side):
                self.static_in[:n].copy_(x, non_blocking=True)
                if n < self.key.batch:
                    self.static_in[n:].zero_()
                self.graph.replay()
                out = self._static_out.clone()
            caller.wait_stream(side)
        # the allocator must not hand either tensor's memory out again
        # before the other stream is done with it
        out.record_stream(caller)
        if x.device.type == "cuda":
            x.record_stream(side)
        return out

    def warm(self, params) -> "Executor":
        """Run a zero batch once, copied in from the host as requests are,
        outside the request loop; on the card, then capture the graph.
        A capture that fails raises ``ExecutorError``."""
        if not self.warmed:
            k = self.key
            x = to_device(np.zeros((k.batch, k.resolution, k.resolution, 3),
                                   np.float32), self.device)
            if self.device.type == "cuda":
                self._capture(params, x)
            else:
                with torch.inference_mode():
                    execute(self.program, params, x, plan=self.plan)
            self.warmed = True
        return self

    def _capture(self, params, x) -> None:
        from repro_torch.kernels.registry import kernel_wrappers

        dev, side = self.device, self.stream
        with self._lock:
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), torch.inference_mode():
                execute(self.program, params, x, plan=self.plan)
            torch.cuda.synchronize(dev)
            wrappers = kernel_wrappers()
            before = {name: w.launches for name, w in wrappers.items()}
            pool0 = _pool_bytes(self.pool)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side), torch.inference_mode():
                    graph.capture_begin(pool=self.pool,
                                        capture_error_mode="thread_local")
                    try:
                        out = execute(self.program, params, x,
                                      plan=self.plan)
                    finally:
                        graph.capture_end()
            except Exception as e:
                _stop_pool_capture(dev, self.pool)
                raise ExecutorError(f"CUDA graph capture failed for "
                                    f"executor {self.key}: {e}",
                                    key=self.key) from e
            torch.cuda.current_stream(dev).wait_stream(side)
        self.graph, self.static_in, self._static_out = graph, x, out
        self._params = params
        self.replay_launches = {
            name: w.launches - before[name] for name, w in wrappers.items()
            if w.launches != before[name]}
        if pool0 is not None:
            self.graph_bytes = _pool_bytes(self.pool) - pool0


class ExecutorCache:
    """LRU cache of ``Executor``s keyed by (batch bucket, resolution).

    ``buckets`` is the ascending set of batch sizes served;
    ``bucket_for(n)`` picks the smallest bucket >= n.  The first plan
    built at a resolution becomes the donor for every later bucket at
    that resolution (``plan_program(..., reuse=)``).  ``device`` defaults
    to the CUDA card; without one, and without ``device="cpu"``, the
    constructor raises.  ``params`` move to ``device``.  On the card a
    build ends with the executor's warm-up and capture.

    ``autotune`` lets each key's plan sweep the tuners' candidates on the
    card where the autotune cache has no entry (at build, before the
    warm-up and the capture); ``epilogues`` is ``plan_program``'s switch
    and part of the key; ``overrides`` (``{site: core.fusion.
    SiteOverride}``) reach every plan the cache builds (a ladder
    demotion still wins).  ``faults`` / ``neg_ttl_s`` / ``clock`` are the
    fault-tolerance knobs (see the module docstring); all default to
    inert.
    """

    def __init__(self, params, cfg: EfficientViTConfig, *,
                 buckets: Tuple[int, ...] = (1, 2, 4, 8),
                 precision: str = "auto", use_plan: bool = True,
                 autotune: bool = True, epilogues: bool = True,
                 overrides=None, capacity: int | None = None,
                 telemetry: Telemetry | None = None, device=None,
                 faults=None, neg_ttl_s: float = 1.0, clock=None):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
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
        # the graphs share one memory pool and one stream (the allocator
        # reuses a pool's free blocks only on the stream that freed them):
        # they capture and replay one after another on that stream
        cuda = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if cuda else None
        # the executors whose graphs live in ``pool`` (None until the
        # first capture into it)
        self._pool_users: Optional[weakref.WeakSet] = None
        self.stream = torch.cuda.Stream(self.device) if cuda else None
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
            try:
                ex = self._build(key)
            except ReproError as e:
                self._note_build_failure(key, e)
                raise
            except Exception as e:   # untyped crash inside lower/plan
                err = ExecutorError(f"executor build failed for {key}: {e}",
                                    key=key)
                self._note_build_failure(key, err)
                raise err from e
            self._lru[key] = ex
            while self.capacity is not None \
                    and len(self._lru) > self.capacity:
                evicted, _ = self._lru.popitem(last=False)
                self.telemetry.count("executor_evicted")
                if not any(k.resolution == evicted.resolution
                           for k in self._lru):
                    self._donor_plans.pop(evicted.resolution, None)
            return ex

    def _note_build_failure(self, key: ExecutorKey,
                            err: ReproError) -> None:
        """Count a failed build and negative-cache its key.  Nothing was
        inserted and no donor plan published (both happen only after a
        successful build), so there is nothing to roll back."""
        self.telemetry.count("executor_build_failed")
        if self.neg_ttl_s > 0:
            self._neg[key] = (self.clock() + self.neg_ttl_s, err)

    def _build(self, key: ExecutorKey) -> Executor:
        if self.faults is not None:
            self.faults.fire("executor.compile", batch=key.batch,
                             resolution=key.resolution,
                             precision=key.precision)
        state = self._degrade.get(key)
        program = lower(self.cfg, batch=key.batch,
                        image_size=key.resolution)
        plan, donate = None, False
        if self.use_plan and not (state is not None and state.level >= 2):
            precision = "fp" if (state is not None and state.pinned_fp) \
                else self.precision
            donor = self._donor_plans.get(key.resolution)
            plan = plan_program(program, self.params, precision=precision,
                                reuse=donor, autotune=self.autotune,
                                epilogues=self.epilogues,
                                overrides=self.overrides,
                                demote=(state.demoted if state is not None
                                        else ()))
            self.telemetry.count("plans_built")
            reused = sum(d.reused for d in plan.decisions.values())
            if reused:
                self.telemetry.count("plan_sites_reused", reused)
            # degraded plans never become donors: their demotions and
            # forced precision must not leak into healthy buckets
            donate = donor is None and (state is None or not state.degraded)
            self._warm_weight_packs(program, plan)
        cuda = self.device.type == "cuda"
        # the pool's live executors, held until the capture ends: PyTorch
        # refuses a capture into a pool whose graphs are all gone (an
        # internal assert) until it has freed the pool
        live = list(self._pool_users or ())
        if cuda and self._pool_users is not None and not live:
            # a ladder move or an eviction dropped the pool's last graph:
            # start another pool; the old one's memory goes back at the
            # allocator's next release of cached memory
            self._new_pool()
        ex = Executor(key, program, plan, self.device, faults=self.faults,
                      degraded=state, pool=self.pool, stream=self.stream,
                      lock=self._lock)
        if cuda:
            try:
                ex.warm(self.params)   # a capture that fails fails the build
            except ExecutorError:
                # PyTorch refuses every later capture into a pool that
                # saw a failed one ("already recording to mempool_id"):
                # later builds capture into a fresh pool, and the graphs
                # already captured keep theirs
                self._new_pool()
                raise
            if self._pool_users is None:
                self._pool_users = weakref.WeakSet()
            self._pool_users.add(ex)
        if donate:
            self._donor_plans[key.resolution] = plan
        return ex

    def _new_pool(self) -> None:
        self.pool = torch.cuda.graph_pool_handle()
        self._pool_users = None

    def _warm_weight_packs(self, program, plan) -> None:
        """Build (or hit) the resident weight pack of every super-site
        group of ``plan`` at build time, so no request pays the packing,
        and count which.  The pack cache keys on (param tree, precision,
        chain), not on resolution or batch: every bucket after the first
        counts a ``weight_pack_hit``."""
        if not plan.groups:
            return
        from repro_torch.core.program import SuperSite
        from repro_torch.kernels.supersite.pack import get_pack
        for g in plan.groups.values():
            sup = SuperSite.of(program, g.members, name=g.name)
            _, hit = get_pack(self.params, sup, g.precision)
            self.telemetry.count(
                "weight_pack_hit" if hit else "weight_pack_built")

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
        return self._apply_degrade(key, state, "degraded")

    def pin_fp(self, batch: int, resolution: int) -> DegradeState:
        """Pin one key's plan to forced-fp precision, the response to
        detected int8 NaN/overflow: on a quantized tree every int8 kernel
        demotes to the reference path, so correctness survives while the
        key stays captured."""
        key = self._key(batch, resolution)
        state = dataclasses.replace(
            self._degrade.get(key, DegradeState()), pinned_fp=True)
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
