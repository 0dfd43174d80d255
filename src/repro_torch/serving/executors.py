"""Shape-bucketed executor cache over the Program IR.

Counterpart of ``repro/serving/executors.py``.  An ``Executor`` is one
specialized pipeline for an ``ExecutorKey = (batch bucket, resolution,
precision)``:

    lower(cfg, batch, image_size)   -> Program     (cached, per shape)
    plan_program(program, params)   -> FusionPlan  (once per key; blocks
                                       inherited from a donor bucket at
                                       the same resolution via reuse=)
    execute(program, params, x, plan)              (eager; where the JAX
                                       package jits, the port launches
                                       its kernels directly)

``ExecutorCache`` builds executors lazily on first use, serves them LRU
with optional capacity eviction, exposes ``warmup`` and reports cache
behavior into a shared ``Telemetry``.  A failed build inserts nothing.
Each build warms the resident weight pack of every super-site group of
its plan (``weight_pack_built`` / ``weight_pack_hit``).
The negative cache, the degradation ladder, fault injection, sharding
and schedule artifacts are later slices of the port.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.common.device import resolve_device, to_device, tree_to
from repro_torch.common.errors import ExecutorError, ReproError
from repro_torch.core.efficientvit import EfficientViTConfig
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import execute, lower
from repro_torch.serving.telemetry import Telemetry

__all__ = ["ExecutorKey", "Executor", "ExecutorCache"]


@dataclasses.dataclass(frozen=True)
class ExecutorKey:
    batch: int        # bucket size (the batch dimension of the executor)
    resolution: int   # square image size
    precision: str    # requested plan precision: "auto" | "fp" | "int8"
    #                   (int8 plans the FIX8 kernels of a quantized tree)


class Executor:
    """One (program, plan) pair for a fixed shape, run eagerly."""

    def __init__(self, key: ExecutorKey, program, plan, device):
        self.key = key
        self.program = program
        self.plan = plan
        self.device = device
        self.warmed = False

    def __call__(self, params, x):
        """Launch the forward.  Asynchronous on the card: the result is
        a device tensor and nothing here waits for it."""
        with torch.inference_mode():
            return execute(self.program, params, x, plan=self.plan)

    def warm(self, params) -> "Executor":
        """Run a zero batch once, copied in from the host as requests are
        (kernel build and load, the pinned staging buffer, first-touch
        allocations), and wait for it, outside the request loop."""
        if not self.warmed:
            k = self.key
            x = np.zeros((k.batch, k.resolution, k.resolution, 3), np.float32)
            self(params, to_device(x, self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.warmed = True
        return self


class ExecutorCache:
    """LRU cache of ``Executor``s keyed by (batch bucket, resolution).

    ``buckets`` is the ascending set of batch sizes served;
    ``bucket_for(n)`` picks the smallest bucket >= n.  The first plan
    built at a resolution becomes the donor for every later bucket at
    that resolution (``plan_program(..., reuse=)``).  ``device`` defaults
    to the CUDA card; without one, and without ``device="cpu"``, the
    constructor raises.  ``params`` move to ``device``.
    """

    def __init__(self, params, cfg: EfficientViTConfig, *,
                 buckets: Tuple[int, ...] = (1, 2, 4, 8),
                 precision: str = "auto", use_plan: bool = True,
                 capacity: int | None = None,
                 telemetry: Telemetry | None = None, device=None):
        if not buckets or any(b < 1 for b in buckets):
            raise ValueError(f"buckets must be positive, got {buckets}")
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.cfg = cfg
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.precision = precision
        self.use_plan = use_plan
        self.capacity = capacity
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self._lru: "collections.OrderedDict[ExecutorKey, Executor]" = \
            collections.OrderedDict()
        self._donor_plans: dict[int, object] = {}   # resolution -> plan

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
        return ExecutorKey(int(batch), int(resolution), self.precision)

    def get(self, batch: int, resolution: int) -> Executor:
        key = self._key(batch, resolution)
        ex = self._lru.get(key)
        if ex is not None:
            self._lru.move_to_end(key)
            self.telemetry.count("executor_hit")
            return ex
        self.telemetry.count("executor_miss")
        try:
            ex = self._build(key)
        except ReproError:
            self.telemetry.count("executor_build_failed")
            raise
        except Exception as e:   # untyped crash inside lower/plan
            self.telemetry.count("executor_build_failed")
            raise ExecutorError(f"executor build failed for {key}: {e}",
                                key=key) from e
        self._lru[key] = ex
        while self.capacity is not None and len(self._lru) > self.capacity:
            evicted, _ = self._lru.popitem(last=False)
            self.telemetry.count("executor_evicted")
            if not any(k.resolution == evicted.resolution
                       for k in self._lru):
                self._donor_plans.pop(evicted.resolution, None)
        return ex

    def _build(self, key: ExecutorKey) -> Executor:
        program = lower(self.cfg, batch=key.batch,
                        image_size=key.resolution)
        plan = None
        if self.use_plan:
            donor = self._donor_plans.get(key.resolution)
            plan = plan_program(program, self.params,
                                precision=self.precision, reuse=donor)
            self.telemetry.count("plans_built")
            reused = sum(d.reused for d in plan.decisions.values())
            if reused:
                self.telemetry.count("plan_sites_reused", reused)
            if donor is None:
                self._donor_plans[key.resolution] = plan
            self._warm_weight_packs(program, plan)
        return Executor(key, program, plan, self.device)

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

    # -- introspection / lifecycle --------------------------------------
    def keys(self) -> Tuple[ExecutorKey, ...]:
        """Currently cached keys, least- to most-recently used."""
        return tuple(self._lru)

    def __len__(self) -> int:
        return len(self._lru)

    def warmup(self, resolutions, buckets=None) -> "ExecutorCache":
        """Build and warm every (bucket, resolution) pair before traffic
        arrives.  An entry whose warm run crashes is evicted before the
        error propagates."""
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
