"""Offline schedule search, counterpart of ``repro/search/``.

The serving runtime otherwise decides online: the autotuner sweeps block
sizes at first use, the planner routes each site by its own policy, and
the bucket set is configured by hand.  This package moves those
decisions to an offline search against a recorded traffic trace, on the
host only, and ships the result as a versioned artifact:

    trace.py      recorded traces (save/load, schema-versioned, the JAX
                  package's file format) and ``workload``, the mirror of
                  the scheduler's batch formation
    evaluator.py  the cost surface: candidate schedules scored through
                  the analytic cycle model, no device work
    drivers.py    the per-site block sweep and the seeded annealing over
                  (bucket set x routing x group boundaries); ``search``
                  is the entry point
    artifact.py   ``ScheduleArtifact``: schema, backend, config hash,
                  trace fingerprint, the frozen decisions and groups per
                  (bucket, resolution), a tuner-cache snapshot

``ExecutorCache(artifact=)`` and ``VisionServeConfig(artifact=)`` adopt
an artifact at startup: the buckets come from the search and every
covered plan is pinned through ``core.fusion.SiteOverride``, so a cold
start runs no autotune sweep.  Each package refuses the other's
artifacts (``artifact.py``).
"""
from repro_torch.search.artifact import (ARTIFACT_SCHEMA, ScheduleArtifact,
                                         config_hash)
from repro_torch.search.drivers import anneal, search, sweep_blocks
from repro_torch.search.evaluator import (evaluate, key_cycles,
                                          trace_resolutions)
from repro_torch.search.trace import (TRACE_SCHEMA, load_trace, save_trace,
                                      trace_fingerprint, workload)

__all__ = ["ARTIFACT_SCHEMA", "TRACE_SCHEMA", "ScheduleArtifact",
           "config_hash", "anneal", "search", "sweep_blocks", "evaluate",
           "key_cycles", "trace_resolutions", "load_trace", "save_trace",
           "trace_fingerprint", "workload"]
