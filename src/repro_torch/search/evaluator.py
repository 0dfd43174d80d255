"""The search's cost surface: candidate schedules scored on the host.

Counterpart of ``repro/search/evaluator.py``.  Everything runs through
the analytic cycle model (``core.accelerator_model.site_breakdown``) on
plans built with ``autotune=False``: no kernel is timed and no card is
needed, and the param tree may live on the CPU or on the card.

Cost of one executor key (batch bucket b, resolution r) under a
candidate schedule:

    cycles(b, r) = sum over sites of the site's modeled cycles, with
                   the candidate's routing applied
                   (``plan_program(overrides=...)``) and each fused
                   site's blocks charged their tile overcompute
                   (``KernelImpl.block_work``, the port's own tiles):
                   dead padded work raises compute cycles by work >= 1,
                   plus ``LAUNCH_OVERHEAD_CYCLES`` per launch.

Objective of a whole schedule against a recorded trace:

    J = sum over dispatched keys of  dispatches[b, r] * cycles(b, r)
        + compile_penalty * |buckets| * |resolutions|
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

from repro_torch.core.accelerator_model import HwConfig, site_breakdown
from repro_torch.core.fusion import SiteOverride, plan_program
from repro_torch.core.program import lower

from .trace import workload

__all__ = ["key_cycles", "evaluate", "trace_resolutions",
           "LAUNCH_OVERHEAD_CYCLES"]


def trace_resolutions(trace) -> tuple:
    return tuple(sorted({int(res) for _, res in trace}))


def _default_precision(precision: str) -> str:
    # structural sites outside the plan move int8 weights only when the
    # tree itself is quantized
    return "int8" if precision == "int8" else "fp"


# Fixed per-launch cost (cycles) added for every scheduled op group: the
# dispatch and the off-chip round trip the DRAM model does not see.  It
# makes un-fusing cost something even on a weight-bound site, so the
# annealer cannot demote its way to an all-reference schedule.
LAUNCH_OVERHEAD_CYCLES = 1000.0


def key_cycles(cfg, params, batch: int, resolution: int, *,
               precision: str = "auto",
               demoted: frozenset = frozenset(),
               breaks: frozenset = frozenset(),
               blocks_for: Optional[Callable] = None,
               launch_overhead: float = LAUNCH_OVERHEAD_CYCLES,
               hw: HwConfig = HwConfig()) -> float:
    """Modeled cycles of one (bucket, resolution) executor under a
    candidate schedule.

    ``demoted`` pins those sites to the reference path
    (``SiteOverride(fused=False)``); ``breaks`` pins super-site group
    boundaries (``SiteOverride(group_break=True)``); ``blocks_for(site)
    -> blocks | None`` supplies searched block choices for the rest
    (None: the kernel's deterministic pick).  The plan is built by
    ``plan_program`` itself, so the precision policies, shared-memory
    fits, epilogues and grouping of the served plan shape the cost.
    """
    from repro_torch.kernels.registry import get_kernel

    program = lower(cfg, batch=batch, image_size=resolution)
    overrides: dict[str, SiteOverride] = {}
    for site in program.fusible():
        if site.name in demoted:
            overrides[site.name] = SiteOverride(fused=False)
            continue
        blk = blocks_for(site) if blocks_for is not None else None
        brk = site.name in breaks
        if blk or brk:
            overrides[site.name] = SiteOverride(
                blocks=dict(blk) if blk else None,
                group_break=True if brk else None)
    plan = plan_program(program, params, autotune=False,
                        precision=precision, overrides=overrides or None)
    program = program.with_epilogues(plan)
    sites = {s.name: s for s in program.sites}
    total = 0.0
    for row in site_breakdown(
            program, hw, plan=plan,
            default_precision=_default_precision(precision)):
        cycles = row["cycles"]
        if row["fused"] and row["blocks"]:
            try:
                impl = get_kernel(row["kind"], row["precision"])
            except KeyError:
                impl = None
            if impl is not None:
                work = impl.block_work(sites[row["site"]], row["blocks"])
                # dead tile work raises the site's compute cycles; it
                # costs latency only past the site's existing bound
                cycles = max(cycles, row["compute_cycles"] * work)
        total += cycles + launch_overhead * row["launches"]
    return total


def evaluate(cfg, params, trace, *, buckets: Sequence[int],
             precision: str = "auto",
             deadline_ms: float | None = None,
             demoted: frozenset = frozenset(),
             breaks: frozenset = frozenset(),
             blocks_for: Optional[Callable] = None,
             compile_penalty: float = 0.0,
             hw: HwConfig = HwConfig(),
             cost_cache: Optional[dict] = None) -> dict:
    """Score one candidate (bucket set, demotion set, group-boundary
    set, block assignment) against a trace; returns ``{"objective",
    "workload", "per_key", "n_keys"}``.

    ``cost_cache`` (a dict the caller owns) memoizes per-key cycles by
    (b, r, demoted, breaks) across evaluations.  ``blocks_for`` here
    takes ``(site, batch, resolution)``: block choices are per shape.
    """
    buckets = tuple(sorted(set(int(b) for b in buckets)))
    resolutions = trace_resolutions(trace)
    wl = workload(trace, buckets, deadline_ms=deadline_ms)
    per_key: dict[tuple, float] = {}
    total = 0.0
    for (b, res), n in sorted(wl.items()):
        ck = (b, res, demoted, breaks)
        if cost_cache is not None and ck in cost_cache:
            cycles = cost_cache[ck]
        else:
            bf = (None if blocks_for is None
                  else (lambda site, _b=b, _r=res:
                        blocks_for(site, _b, _r)))
            cycles = key_cycles(cfg, params, b, res, precision=precision,
                                demoted=demoted, breaks=breaks,
                                blocks_for=bf, hw=hw)
            if cost_cache is not None:
                cost_cache[ck] = cycles
        per_key[(b, res)] = cycles
        total += n * cycles
    n_keys = len(buckets) * len(resolutions)
    return {"objective": total + compile_penalty * n_keys,
            "workload": wl, "per_key": per_key, "n_keys": n_keys}
