"""Vision serving: a thin façade over the serving runtime.

Counterpart of ``repro/serving/vision.py``.  ``VisionEngine`` builds an
``ExecutorCache`` (shape-bucketed executors, plans shared across
buckets) and vends ``MicroBatchScheduler``s over it.  The primary
executor (the full microbatch at the config's resolution) is built in
the constructor, outside the request loop (on the card its CUDA graph
is captured there too), and exposed as ``.program`` / ``.plan``.  A
``serving.faults.FaultPlan`` (``faults=``) reaches the cache and every
scheduler the engine vends; ``VisionServeConfig`` sets the schedulers'
result cache and watchdog, and its ``autotune`` and ``epilogues``
switches reach every plan.  ``VisionServeConfig(devices=)`` serves every
key over a batch mesh of fault domains (``serving.sharding``), and
``VisionEngine(tracer=)`` threads one ``obs.trace.Tracer`` through the
cache, every scheduler the engine vends and its fault plan
(``export_trace`` writes the timeline; ``metrics`` renders the
telemetry as Prometheus text).  ``VisionServeConfig(artifact=)`` (a
``search.ScheduleArtifact`` or a path to one) serves an offline-searched
schedule: the buckets come from the artifact, the microbatch is its
largest bucket, and every covered plan is pinned, so a cold start runs
no autotune sweep (``serving.executors``).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from repro_torch.common.device import resolve_device, to_device, tree_to
from repro_torch.core.efficientvit import EfficientViTConfig
from repro_torch.serving.executors import ExecutorCache
from repro_torch.serving.scheduler import (
    BucketedPolicy, FixedMicrobatchPolicy, MicroBatchScheduler, Request)
from repro_torch.serving.telemetry import Telemetry

__all__ = ["VisionServeConfig", "VisionEngine"]


def _default_buckets(microbatch: int) -> tuple:
    """Powers of two up to and including the microbatch: 8 -> (1,2,4,8)."""
    out = {microbatch}
    b = 1
    while b < microbatch:
        out.add(b)
        b *= 2
    return tuple(sorted(out))


@dataclasses.dataclass(frozen=True)
class VisionServeConfig:
    microbatch: int = 8       # largest batch bucket (and the fixed size
    #                           under policy="fixed")
    use_plan: bool = True     # False -> reference path (A/B, debugging)
    autotune: bool = True     # sweep the tuners' candidates on the card
    #                           where the autotune cache has none
    precision: str = "auto"   # "auto" | "fp" | "int8" (FIX8: serve a
    #                           quantize_efficientvit tree; see quantized)
    policy: str = "bucketed"  # "bucketed" | "fixed" (pad to microbatch)
    buckets: tuple | None = None   # None -> powers of 2 up to microbatch
    capacity: int | None = None    # executor-cache LRU capacity
    epilogues: bool = True    # producer-side int8 emission (the int8
    #                           dataflow); False serves the consumer-side
    #                           quantize pipeline (A/B)
    result_cache: int | None = None  # image-hash response cache capacity
    #                                  in front of admission (None = off)
    watchdog_ms: float | None = None  # in-flight hang bound for the
    #                                   scheduler's watchdog (None = off)
    devices: tuple | None = None   # device mesh for batch-axis sharding
    #                                and per-device fault domains, one
    #                                domain per entry (("cuda:0",) * 4:
    #                                four on one card); None = one device
    artifact: object | None = None  # an offline-searched ScheduleArtifact
    #                                 (or a path to one): buckets and
    #                                 per-site decisions come from the
    #                                 search (repro_torch.search)


class VisionEngine:
    """``device`` defaults to the CUDA card (the first mesh device when
    ``serve_cfg.devices`` is set); without a card, and without
    ``device="cpu"``, the constructor raises.  ``overrides``
    (``{site: core.fusion.SiteOverride}``) reach every plan the engine's
    cache builds.  ``tracer`` (an ``obs.trace.Tracer``, None = tracing
    off) reaches the cache, every scheduler the engine vends and the
    fault plan, unless the plan already carries one."""

    def __init__(self, params, cfg: EfficientViTConfig,
                 serve_cfg: VisionServeConfig = VisionServeConfig(), *,
                 device=None, faults=None, overrides=None, tracer=None):
        if serve_cfg.policy not in ("bucketed", "fixed"):
            raise ValueError(f"policy must be bucketed|fixed, got "
                             f"{serve_cfg.policy!r}")
        self.cfg = cfg
        self.serve_cfg = serve_cfg
        artifact = serve_cfg.artifact
        if isinstance(artifact, (str, os.PathLike)):
            from repro_torch.search.artifact import ScheduleArtifact
            artifact = ScheduleArtifact.load(os.fspath(artifact))
        self.artifact = artifact
        if artifact is not None:
            # the searched bucket set replaces the configured one, and
            # the microbatch (the primary shape, the chunking unit)
            # becomes its largest bucket
            mb = max(artifact.buckets)
            buckets = artifact.buckets
        else:
            mb = serve_cfg.microbatch
            buckets = serve_cfg.buckets
            if buckets is None:
                buckets = (mb,) if serve_cfg.policy == "fixed" \
                    else _default_buckets(mb)
            # the microbatch is always a bucket: chunking must never
            # hand an n-row batch to an executor built for fewer rows
            buckets = tuple(sorted(set(buckets) | {mb}))
        self.microbatch = mb
        self.faults = faults  # serving.faults.FaultPlan (chaos testing)
        self.tracer = tracer
        if faults is not None and tracer is not None \
                and getattr(faults, "tracer", None) is None:
            faults.tracer = tracer
        self.telemetry = Telemetry()
        self.cache = ExecutorCache(
            params, cfg, buckets=buckets, precision=serve_cfg.precision,
            use_plan=serve_cfg.use_plan, autotune=serve_cfg.autotune,
            epilogues=serve_cfg.epilogues, capacity=serve_cfg.capacity,
            telemetry=self.telemetry, device=device, faults=faults,
            overrides=overrides, devices=serve_cfg.devices, tracer=tracer,
            artifact=artifact)
        self.params = self.cache.params
        self.device = self.cache.device
        primary = self.cache.get(mb, cfg.image_size)
        self.program = primary.program
        self.plan = primary.plan
        self._scheduler: MicroBatchScheduler | None = None

    @classmethod
    def quantized(cls, params, cfg: EfficientViTConfig,
                  serve_cfg: VisionServeConfig = VisionServeConfig(), *,
                  device=None, faults=None, tracer=None) -> "VisionEngine":
        """FIX8 serving: quantize an fp32 param tree post-training (BN
        folded, int8 weights per output channel) on ``device`` (default:
        the card) and serve it through the int8 kernels."""
        from repro_torch.core.quantization import quantize_efficientvit
        if device is None and serve_cfg.devices is not None:
            device = serve_cfg.devices[0]
        dev = resolve_device(device)
        return cls(quantize_efficientvit(tree_to(params, dev)), cfg,
                   dataclasses.replace(serve_cfg, precision="int8"),
                   device=dev, faults=faults, tracer=tracer)

    # -- batch API -------------------------------------------------------
    def logits(self, images) -> torch.Tensor:
        """images: (n, H, W, 3), any n -> (n, num_classes) on the device.

        Chunks dispatch without waiting on each other; the ragged tail
        routes to the smallest bucket >= its size (policy "bucketed") or
        pads to the microbatch (policy "fixed").  Each chunk is copied
        straight into its executor's static input, the missing rows
        zeroed there."""
        images = to_device(images, self.device)
        n, res = int(images.shape[0]), int(images.shape[1])
        mb = self.microbatch
        if self.serve_cfg.policy == "fixed":
            sizes = [mb] * -(-n // mb)
        else:
            sizes = self.cache.chunks_for(n)
        outs = []
        i = 0
        for bucket in sizes:
            take = min(bucket, n - i)
            ex = self.cache.get(bucket, res)
            outs.append(ex(self.params, images[i:i + take])[:take])
            self.telemetry.record_dispatch(
                (bucket, res, self.cache.precision), take, bucket)
            i += take
        return torch.cat(outs)

    def classify(self, images) -> np.ndarray:
        """images: (n, H, W, 3) -> (n,) int top-1 labels."""
        return self.logits(images).argmax(dim=-1).cpu().numpy()

    # -- request API -----------------------------------------------------
    def scheduler(self, *, clock=None, policy=None,
                  **kw) -> MicroBatchScheduler:
        """A micro-batching scheduler bound to this engine's executor
        cache, params and telemetry.  Extra keywords (``max_queue_depth``,
        ``max_retries``, ``backoff_ms``, ...) pass through to
        ``MicroBatchScheduler``; the engine's fault plan, result cache and
        watchdog are the defaults."""
        if policy is None:
            policy = (FixedMicrobatchPolicy(self.microbatch)
                      if self.serve_cfg.policy == "fixed"
                      else BucketedPolicy())
        kw.setdefault("faults", self.faults)
        kw.setdefault("result_cache", self.serve_cfg.result_cache)
        kw.setdefault("watchdog_ms", self.serve_cfg.watchdog_ms)
        kw.setdefault("tracer", self.tracer)
        return MicroBatchScheduler(self.cache, self.params, policy=policy,
                                   telemetry=self.telemetry, clock=clock,
                                   **kw)

    def export_trace(self, path: str) -> dict:
        """Write the engine's request timeline as Chrome trace JSON
        (``chrome://tracing`` / Perfetto).  Requires a tracer."""
        if self.tracer is None:
            raise ValueError("VisionEngine built without tracer=; "
                             "nothing to export")
        return self.tracer.export(path)

    def metrics(self):
        """A ``repro_torch.obs.MetricsRegistry`` over this engine's
        telemetry (Prometheus text / JSON export)."""
        from repro_torch.obs.metrics import MetricsRegistry
        return MetricsRegistry(telemetry=self.telemetry)

    def serve(self, requests: list[Request]) -> np.ndarray:
        """Serve ``Request``s (mixed resolutions and deadlines welcome);
        logits stacked in request order."""
        if self._scheduler is None:
            self._scheduler = self.scheduler()
        return self._scheduler.serve(requests)

    def warmup(self, resolutions=None) -> "VisionEngine":
        """Build and warm every bucket at the given resolutions
        (default: the config's image size)."""
        self.cache.warmup(resolutions if resolutions is not None
                          else (self.cfg.image_size,))
        return self
