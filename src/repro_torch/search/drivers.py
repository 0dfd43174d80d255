"""Search drivers: exhaustive block sweep and seeded annealing, then the
artifact.

Counterpart of ``repro/search/drivers.py``.  Two layers of search over
``evaluator``'s cost surface:

  * ``sweep_blocks``: each fused site's candidate blocks
    (``KernelImpl.candidates``, the port's Hopper tiles) scored by their
    tile overcompute (``block_work``).  Sites are independent in the cost
    model, so the per-site pick is the global one.  Ties break to the
    least overcompute, then the largest sum of block values: every key
    of the port's block dicts counts in that sum (``block_m`` and
    ``split`` beside ``block_rows`` for the fp MBConv), which is the
    port's ranking, not JAX's, whose keys are the Pallas kernels'.
  * ``anneal``: seeded simulated annealing (``random.Random(seed)``)
    over (serving bucket set x demoted sites x super-site boundaries),
    move for move JAX's walk.  It starts at the default schedule with
    swept blocks and keeps the best state seen, so the searched
    objective is never worse than the default one.

``search()`` runs both, then builds every (bucket, resolution) plan of
the winner through ``plan_program(overrides=...)`` and freezes its
decisions and groups into a ``ScheduleArtifact``: what ships is the
planner's own output, and a serve-time replan from the artifact
reproduces it.
"""
from __future__ import annotations

import math
import random
from typing import Optional, Sequence

from repro_torch.core.accelerator_model import HwConfig
from repro_torch.core.fusion import SiteOverride, plan_program
from repro_torch.core.program import lower
from repro_torch.kernels.autotune import export_entries
from repro_torch.kernels.registry import get_kernel

from .artifact import ScheduleArtifact, config_hash
from .evaluator import evaluate, trace_resolutions
from .trace import trace_fingerprint

__all__ = ["sweep_blocks", "anneal", "search"]


def sweep_blocks(cfg, params, *, batch: int, resolution: int,
                 precision: str = "auto") -> dict:
    """{site name: best blocks} for one executor shape over each fused
    site's candidates, scored by ``KernelImpl.block_work`` (host
    arithmetic).  Deterministic; the FIX8 families have no candidates,
    so a quantized tree sweeps nothing."""
    program = lower(cfg, batch=batch, image_size=resolution)
    plan = plan_program(program, params, autotune=False,
                        precision=precision)
    best: dict[str, dict] = {}
    for site in program.fusible():
        d = plan.get(site.name)
        if d is None or not d.fused:
            continue
        impl = get_kernel(site.kind, d.precision)
        cands = impl.candidates(site)
        if not cands:
            continue
        best[site.name] = dict(min(
            cands,
            key=lambda c: (impl.block_work(site, c),
                           -sum(int(v) for v in c.values()))))
    return best


def anneal(objective, state, *, universe_buckets: Sequence[int],
           universe_sites: Sequence[str], universe_breaks: Sequence[str] = (),
           seed: int = 0, iters: int = 64, verbose: bool = False):
    """Seeded simulated annealing over (bucket set, demoted site set,
    super-site boundary set).

    ``objective(buckets: frozenset, demoted: frozenset[, breaks:
    frozenset]) -> float``; ``state`` is the (buckets, demoted[,
    breaks]) start.  A move toggles one bucket (never emptying the set),
    one site's demotion, or one group boundary of ``universe_breaks``.
    With ``universe_breaks`` empty and a 2-tuple ``state`` the walk and
    the objective's arity are the 2-axis search.  Returns (best_state,
    best_objective, evaluations).
    """
    rng = random.Random(seed)
    universe_buckets = tuple(sorted(set(int(b) for b in universe_buckets)))
    universe_sites = tuple(universe_sites)
    universe_breaks = tuple(universe_breaks)
    three = len(state) > 2 or bool(universe_breaks)
    cur = (frozenset(state[0]), frozenset(state[1]),
           frozenset(state[2]) if len(state) > 2 else frozenset())

    def _obj(s):
        return objective(*s) if three else objective(s[0], s[1])

    cur_obj = _obj(cur)
    best, best_obj = cur, cur_obj
    evals = 1
    # the temperature spans a fixed fraction of the start objective and
    # cools geometrically, so the walk behaves alike across model sizes
    t0 = 0.05 * max(cur_obj, 1.0)
    for i in range(iters):
        frac = i / max(1, iters - 1)
        temp = t0 * (0.01 ** frac)
        bset, demoted, breaks = set(cur[0]), set(cur[1]), set(cur[2])
        if (rng.random() < 0.5
                or not (universe_sites or universe_breaks)) \
                and len(universe_buckets) > 1:
            b = rng.choice(universe_buckets)
            if b in bset and len(bset) > 1:
                bset.remove(b)
            else:
                bset.add(b)
        elif universe_breaks and (not universe_sites
                                  or rng.random() < 0.5):
            s = rng.choice(universe_breaks)
            breaks.symmetric_difference_update({s})
        elif universe_sites:
            s = rng.choice(universe_sites)
            demoted.symmetric_difference_update({s})
        cand = (frozenset(bset), frozenset(demoted), frozenset(breaks))
        if cand == cur:
            continue
        cand_obj = _obj(cand)
        evals += 1
        delta = cand_obj - cur_obj
        if delta <= 0 or rng.random() < math.exp(-delta / max(temp, 1e-9)):
            cur, cur_obj = cand, cand_obj
            if cur_obj < best_obj:
                best, best_obj = cur, cur_obj
                if verbose:
                    print(f"  anneal[{i:>3}] new best {best_obj:,.0f} "
                          f"buckets={sorted(best[0])} "
                          f"demoted={sorted(best[1])} "
                          f"breaks={sorted(best[2])}")
    return (best if three else best[:2]), best_obj, evals


def search(cfg, params, trace, *, buckets: Sequence[int] = (1, 2, 4, 8),
           precision: str = "auto", deadline_ms: float | None = None,
           seed: int = 0, iters: int = 64,
           bucket_universe: Optional[Sequence[int]] = None,
           compile_penalty: float | None = None,
           hw: HwConfig = HwConfig(),
           verbose: bool = False) -> ScheduleArtifact:
    """The offline schedule search: per-site blocks, per-site routing,
    super-site boundaries and the serving bucket set against a recorded
    trace; returns the versioned ``ScheduleArtifact``.

    ``buckets`` is the default bucket set (the baseline of the objective
    gate); ``bucket_universe`` bounds what the annealer may toggle
    (default: the baseline set).  ``compile_penalty`` is the cycle
    charge per compiled executor (default: 1 % of the default schedule's
    mean cost per dispatch).  Deterministic under a fixed ``seed``.
    Runs on the host only: every plan is built with ``autotune=False``.
    """
    trace = [(float(at), int(res)) for at, res in trace]
    assert trace, "cannot search against an empty trace"
    resolutions = trace_resolutions(trace)
    base = frozenset(int(b) for b in buckets)
    universe = tuple(sorted(base | set(
        int(b) for b in (bucket_universe or ()))))

    # layer 1: the per-site block sweep, per executor shape
    swept: dict[tuple, dict] = {}

    def blocks_for(site, batch, resolution):
        key = (batch, resolution)
        if key not in swept:
            swept[key] = sweep_blocks(cfg, params, batch=batch,
                                      resolution=resolution,
                                      precision=precision)
        return swept[key].get(site.name)

    # the default baseline: the kernels' picks, every site routed by the
    # planner's own policy, the configured bucket set
    raw_default = evaluate(cfg, params, trace, buckets=sorted(base),
                           precision=precision, deadline_ms=deadline_ms,
                           hw=hw, cost_cache={})
    if compile_penalty is None:
        n_dispatch = max(1, sum(raw_default["workload"].values()))
        compile_penalty = 0.01 * raw_default["objective"] / n_dispatch
    default_objective = raw_default["objective"] \
        + compile_penalty * raw_default["n_keys"]

    # layer 2: annealing with swept blocks.  The break universe is every
    # interior member of a default-plan group at the trace's resolutions.
    searched_cache: dict = {}

    def objective(bset, demoted, breaks):
        return evaluate(cfg, params, trace, buckets=sorted(bset),
                        precision=precision, deadline_ms=deadline_ms,
                        demoted=demoted, breaks=breaks,
                        blocks_for=blocks_for,
                        compile_penalty=compile_penalty, hw=hw,
                        cost_cache=searched_cache)["objective"]

    site_names = tuple(s.name for s in lower(
        cfg, batch=1, image_size=resolutions[0]).fusible())
    break_names: list[str] = []
    for res in resolutions:
        dprog = lower(cfg, batch=1, image_size=res)
        dplan = plan_program(dprog, params, autotune=False,
                             precision=precision)
        for g in dplan.groups.values():
            for m in g.members[1:]:
                if m not in break_names:
                    break_names.append(m)
    (best_buckets, best_demoted, best_breaks), best_obj, evals = anneal(
        objective, (base, frozenset(), frozenset()),
        universe_buckets=universe, universe_sites=site_names,
        universe_breaks=tuple(break_names), seed=seed, iters=iters,
        verbose=verbose)
    assert best_obj <= default_objective + 1e-6, \
        (best_obj, default_objective)   # the start state guarantees this

    # layer 3: the winner's plans, built by the real planner
    entries: dict[str, list] = {}
    groups: dict[str, list] = {}
    for b in sorted(best_buckets):
        for res in resolutions:
            program = lower(cfg, batch=b, image_size=res)
            overrides = {}
            for site in program.fusible():
                if site.name in best_demoted:
                    overrides[site.name] = SiteOverride(fused=False)
                    continue
                blk = blocks_for(site, b, res)
                brk = site.name in best_breaks
                if blk or brk:
                    overrides[site.name] = SiteOverride(
                        blocks=dict(blk) if blk else None,
                        group_break=True if brk else None)
            plan = plan_program(program, params, autotune=False,
                                precision=precision,
                                overrides=overrides or None)
            entries[f"{b}x{res}"] = [d.to_dict()
                                     for d in plan.decisions.values()]
            groups[f"{b}x{res}"] = [g.to_dict()
                                    for g in plan.groups.values()]
    if verbose:
        print(f"search: {evals} evaluations, objective "
              f"{default_objective:,.0f} -> {best_obj:,.0f} "
              f"({best_obj / default_objective:.3f}x), buckets "
              f"{sorted(base)} -> {sorted(best_buckets)}, "
              f"{len(best_demoted)} site(s) demoted, "
              f"{len(best_breaks)} group boundary(ies) split")
    return ScheduleArtifact(
        config_hash=config_hash(cfg), precision=precision,
        trace_fingerprint=trace_fingerprint(trace),
        buckets=tuple(sorted(best_buckets)), resolutions=resolutions,
        entries=entries, groups=groups, tuner_cache=export_entries(),
        demoted=tuple(sorted(best_demoted)),
        breaks=tuple(sorted(best_breaks)),
        objective=float(best_obj),
        default_objective=float(default_objective), seed=int(seed),
        config_name=getattr(cfg, "name", ""))
