"""The port's offline schedule search (``repro_torch.search``) and its
adoption by the serving runtime, against the JAX package on the CPU.

- Traces: a round trip, typed refusals, and each package reading the
  other's trace file with the same list and fingerprint.
- ``workload`` equal to JAX's on the committed smoke trace.
- ``anneal`` equal to JAX's, move for move, on a synthetic objective.
- ``sweep_blocks``: deterministic, each pick among the port's candidates;
  empty at FIX8, where the port's int8 families have fixed path rules.
- ``key_cycles`` / ``evaluate`` / ``search``: the JAX package's FIX8
  Pallas kernels keep block candidates (``block_f``, ``block_n``) and
  charge their tile overcompute, where the port's int8 families charge
  none.  The FIX8 comparisons therefore put JAX on the port's cost
  surface (its three int8 kernels' ``candidates`` empty and
  ``block_work`` 1.0, patched for the test); there the cycles, the
  search's buckets, objectives, demotions and every decision field but
  ``blocks`` are equal.  At fp32 each package charges its own tiles; the
  test names the reason of every decision that differs.
- Artifacts: a JSON round trip, typed refusals (schema, config,
  precision, backend both ways), uncovered shapes, ``overrides_for``
  re-forming the stored groups.
- Adoption: ``ExecutorCache(artifact=)`` and ``VisionServeConfig(
  artifact=)``, with no tuner consulted for a covered shape (counted
  through ``autotune.set_fault_hook``: nothing sweeps on the CPU, so
  ``SWEEP_COUNT`` alone would prove nothing).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from numpy.testing import assert_allclose
from test_torch_fix8 import _fp_tree, _qtree
from test_torch_supersite import JCFG, TCFG

from repro.common.errors import ArtifactError as JArtifactError
from repro.core import efficientvit as jevit
from repro.core import program as jprog
from repro.kernels import autotune as jat
from repro.kernels.dsconv.ops import DsconvInt8Kernel as JDsconvInt8
from repro.kernels.int8_matmul.ops import MsaInt8Kernel as JMsaInt8
from repro.kernels.mbconv.ops import MbconvInt8Kernel as JMbconvInt8
from repro.kernels.registry import get_kernel as jget_kernel
from repro.search import artifact as jart
from repro.search import drivers as jdrv
from repro.search import evaluator as jeval
from repro.search import trace as jtrace
from repro.serving import vision as jvision
from repro_torch import search as tsearch
from repro_torch.common.errors import ArtifactError
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.kernels import autotune as tat
from repro_torch.kernels.registry import get_kernel
from repro_torch.serving import executors as tex
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.vision import VisionEngine, VisionServeConfig

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "trace_smoke.json")
SPEC = dict(buckets=(1, 2, 4), deadline_ms=40.0)


def _strip(entries):
    """Artifact entries without the tile choices."""
    return {k: [{f: v for f, v in d.items() if f != "blocks"} for d in ds]
            for k, ds in entries.items()}


def _demoted(art):
    return sorted({d["name"] for ds in art.entries.values() for d in ds
                   if d["reason"] == "search"})


@pytest.fixture(scope="module", autouse=True)
def tuner_files(tmp_path_factory):
    """Both packages' autotune caches in fresh files for the module."""
    td = tmp_path_factory.mktemp("search_tuners")
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_AUTOTUNE_CACHE", str(td / "jax.json"))
    mp.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(td / "port.json"))
    jat.clear_memory_cache()
    tat.clear_memory_cache()
    yield td
    mp.undo()
    jat.clear_memory_cache()
    tat.clear_memory_cache()


@pytest.fixture
def jax_fix8_surface(monkeypatch):
    """JAX's FIX8 Pallas kernels without block candidates and tile
    overcompute: the port's FIX8 cost surface."""
    for cls in (JDsconvInt8, JMbconvInt8, JMsaInt8):
        monkeypatch.setattr(cls, "candidates", lambda self, site: ())
        monkeypatch.setattr(cls, "block_work",
                            lambda self, site, blocks: 1.0)


@pytest.fixture(scope="module")
def trace():
    return tsearch.load_trace(FIXTURE)


@pytest.fixture(scope="module")
def smoke_fp():
    return _fp_tree(jevit.B1_SMOKE, 0)


@pytest.fixture(scope="module")
def deep_trees():
    """The grouped smoke config's (fp, quantized) trees as numpy."""
    fp = _fp_tree(JCFG, 0)
    return fp, _qtree(fp)


@pytest.fixture(scope="module")
def searched(deep_trees, trace):
    """One search of the grouped smoke config at fp32, seed 1: it keeps
    bucket 4 alone, so buckets 1 and 2 are uncovered shapes."""
    params = params_from_jax(deep_trees[0], "cpu")
    art = tsearch.search(TCFG, params, trace, seed=1, iters=64, **SPEC)
    return params, art


@pytest.fixture(scope="module")
def searched_full(deep_trees, trace):
    """A search that keeps every bucket (seed 0, 16 iterations)."""
    params = params_from_jax(deep_trees[0], "cpu")
    art = tsearch.search(TCFG, params, trace, seed=0, iters=16, **SPEC)
    return params, art


# ---------------------------------------------------------------------------
# traces
# ---------------------------------------------------------------------------

def test_trace_roundtrip_and_refusals(tmp_path):
    trace = [(0.0, 64), (0.001, 32), (0.5, 64)]
    path = str(tmp_path / "t.json")
    fp = tsearch.save_trace(path, trace, spec={"buckets": (1, 2)})
    assert fp == tsearch.trace_fingerprint(trace)
    assert tsearch.load_trace(path) == trace
    doc = json.load(open(path))
    doc["schema"] = tsearch.TRACE_SCHEMA + 1
    json.dump(doc, open(path, "w"))
    with pytest.raises(ArtifactError, match="schema"):
        tsearch.load_trace(path)
    json.dump({"schema": tsearch.TRACE_SCHEMA, "requests": [["bad"]]},
              open(path, "w"))
    with pytest.raises(ArtifactError, match="malformed"):
        tsearch.load_trace(path)
    with pytest.raises(ArtifactError, match="unreadable"):
        tsearch.load_trace(str(tmp_path / "missing.json"))


def test_trace_files_cross_packages(tmp_path, trace):
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    jfp = jtrace.save_trace(jpath, trace, spec={"n": len(trace)})
    tfp = tsearch.save_trace(tpath, trace, spec={"n": len(trace)})
    assert jfp == tfp
    assert tsearch.load_trace(jpath) == jtrace.load_trace(tpath) == trace
    assert tsearch.trace_fingerprint(jtrace.load_trace(tpath)) == jfp
    assert json.load(open(jpath)) == json.load(open(tpath))


@pytest.mark.parametrize("deadline", [None, 40.0])
@pytest.mark.parametrize("buckets", [(1, 2, 4), (4,), (1, 2, 4, 8)])
def test_workload_matches_jax(trace, buckets, deadline):
    got = tsearch.workload(trace, buckets, deadline_ms=deadline)
    assert got == jtrace.workload(trace, buckets, deadline_ms=deadline)
    assert sum(b * n for (b, _), n in got.items()) >= len(trace)


# ---------------------------------------------------------------------------
# the annealer
# ---------------------------------------------------------------------------

def _synthetic(three):
    """A deterministic objective with structure on every axis."""
    site_w = {"a": -30.0, "b": 55.0, "c": -12.5, "d": 8.0}
    break_w = {"x": -21.0, "y": 17.0, "z": -4.0}

    def f(bset, demoted, breaks=frozenset()):
        v = 1000.0 + sum((b - 3) ** 2 * 9.0 for b in bset) \
            - 40.0 * len(bset) + sum(site_w[s] for s in demoted)
        if three:
            v += sum(break_w[s] for s in breaks)
        return v
    return f


@pytest.mark.parametrize("three", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_anneal_matches_jax(seed, three):
    kw = dict(universe_buckets=(1, 2, 4, 8), universe_sites="abcd",
              seed=seed, iters=48)
    state = (frozenset({1, 2, 4, 8}), frozenset())
    if three:
        kw["universe_breaks"] = ("x", "y", "z")
        state += (frozenset(),)
    got = tsearch.anneal(_synthetic(three), state, **kw)
    want = jdrv.anneal(_synthetic(three), state, **kw)
    assert got == want
    assert len(got[0]) == (3 if three else 2)


# ---------------------------------------------------------------------------
# the cost surface
# ---------------------------------------------------------------------------

def test_sweep_blocks_deterministic_and_in_candidates(deep_trees):
    params = params_from_jax(deep_trees[0], "cpu")
    kw = dict(batch=2, resolution=64)
    best = tsearch.sweep_blocks(TCFG, params, **kw)
    assert best and best == tsearch.sweep_blocks(TCFG, params, **kw)
    program = tprog.lower(TCFG, batch=2, image_size=64)
    plan = tfusion.plan_program(program, params, autotune=False)
    for site in program.fusible():
        if site.name in best:
            impl = get_kernel(site.kind, plan.get(site.name).precision)
            assert best[site.name] in [dict(c) for c in
                                       impl.candidates(site)]
            # the least overcompute of the site's candidates
            assert impl.block_work(site, best[site.name]) == min(
                impl.block_work(site, c) for c in impl.candidates(site))


def test_sweep_blocks_empty_at_fix8(deep_trees, jax_fix8_surface):
    q = deep_trees[1]
    assert tsearch.sweep_blocks(TCFG, params_from_jax(q, "cpu"), batch=2,
                                resolution=64, precision="int8") == {}
    assert jdrv.sweep_blocks(JCFG, jax.tree.map(jnp.asarray, q), batch=2,
                             resolution=64, precision="int8") == {}


def _default_groups(tcfg, params, batch, res, precision="auto"):
    plan = tfusion.plan_program(tprog.lower(tcfg, batch=batch,
                                            image_size=res),
                                params, autotune=False, precision=precision)
    return plan.groups


@pytest.mark.parametrize("case", ["default", "demoted", "split"])
def test_key_cycles_fix8_matches_jax(deep_trees, jax_fix8_surface, case):
    q = deep_trees[1]
    tq, jq = params_from_jax(q, "cpu"), jax.tree.map(jnp.asarray, q)
    groups = _default_groups(TCFG, tq, 2, 64, "int8")
    assert groups, "the grouped smoke config groups at FIX8"
    g = next(iter(groups.values()))
    kw = {"default": {},
          "demoted": {"demoted": frozenset({"S3.evit0.msa"})},
          "split": {"breaks": frozenset({g.members[1]})}}[case]
    for b in (1, 2, 4):
        got = tsearch.key_cycles(TCFG, tq, b, 64, precision="int8", **kw)
        want = jeval.key_cycles(JCFG, jq, b, 64, precision="int8", **kw)
        assert got == pytest.approx(want, rel=1e-12), (case, b)
    ev = dict(buckets=SPEC["buckets"], precision="int8",
              deadline_ms=SPEC["deadline_ms"], **kw)
    trace = tsearch.load_trace(FIXTURE)
    got = tsearch.evaluate(TCFG, tq, trace, **ev)
    want = jeval.evaluate(JCFG, jq, trace, **ev)
    assert got["workload"] == want["workload"]
    assert got["objective"] == pytest.approx(want["objective"], rel=1e-12)


def test_key_cycles_fp_all_demoted_matches_jax(deep_trees):
    fp = deep_trees[0]
    names = frozenset(s.name for s in tprog.lower(TCFG, batch=2,
                                                  image_size=64).fusible())
    got = tsearch.key_cycles(TCFG, params_from_jax(fp, "cpu"), 2, 64,
                             demoted=names)
    want = jeval.key_cycles(JCFG, jax.tree.map(jnp.asarray, fp), 2, 64,
                            demoted=names)
    assert got == pytest.approx(want, rel=1e-12)


def test_key_cycles_demotion_costs_launches(deep_trees):
    params = params_from_jax(deep_trees[0], "cpu")
    base = tsearch.key_cycles(TCFG, params, 4, 64)
    names = frozenset(s.name for s in tprog.lower(TCFG, batch=4,
                                                  image_size=64).fusible())
    assert base > 0
    assert tsearch.key_cycles(TCFG, params, 4, 64, demoted=names) > base


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------

def test_search_deterministic(deep_trees, trace):
    params = params_from_jax(deep_trees[0], "cpu")
    dicts = [tsearch.search(TCFG, params, trace, seed=2, iters=24,
                            **SPEC).to_dict() for _ in range(2)]
    assert dicts[0] == dicts[1]
    assert dicts[0]["objective"] <= dicts[0]["default_objective"]


def test_search_stamps_provenance(searched, trace):
    _, art = searched
    assert art.objective <= art.default_objective
    assert art.schema == tsearch.ARTIFACT_SCHEMA == 2
    assert art.backend == "torch-cuda"
    assert art.config_hash == tsearch.config_hash(TCFG)
    assert art.trace_fingerprint == tsearch.trace_fingerprint(trace)
    assert art.config_name == TCFG.name
    assert set(art.entries) == set(art.groups) == {
        f"{b}x{r}" for b in art.buckets for r in art.resolutions}
    assert art.tuner_cache == tat.export_entries()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_search_fix8_matches_jax(deep_trees, trace, jax_fix8_surface, seed):
    q = deep_trees[1]
    kw = dict(precision="int8", seed=seed, iters=64, **SPEC)
    got = tsearch.search(TCFG, params_from_jax(q, "cpu"), trace, **kw)
    want = jdrv.search(JCFG, jax.tree.map(jnp.asarray, q), trace, **kw)
    assert got.buckets == want.buckets
    assert got.resolutions == want.resolutions
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    assert got.default_objective == pytest.approx(want.default_objective,
                                                  rel=1e-12)
    assert list(got.demoted) == _demoted(want)
    assert _strip(got.entries) == _strip(want.entries)


@pytest.mark.parametrize("seed", [0, 1])
def test_search_fp_against_jax(deep_trees, trace, seed):
    """At fp32 each objective charges its own package's tiles.  Seed 0
    agrees field for field (blocks aside).  Where the two differ (seed
    1), every difference is a JAX demotion of an MSA site whose swept
    Pallas token tile pads the site's tokens (JAX's ``block_work`` > 1;
    demoting it drops that charge), while the port's token tile is
    ``min(tokens, block_n)`` and pads nothing, so the port's demotion
    would only add launches."""
    fp = deep_trees[0]
    kw = dict(seed=seed, iters=64, **SPEC)
    jparams = jax.tree.map(jnp.asarray, fp)
    got = tsearch.search(TCFG, params_from_jax(fp, "cpu"), trace, **kw)
    want = jdrv.search(JCFG, jparams, trace, **kw)
    assert got.buckets == want.buckets
    assert got.objective <= got.default_objective
    extra = set(_demoted(want)) - set(got.demoted)
    assert set(got.demoted) <= set(_demoted(want))
    if seed == 0:
        assert not extra and _strip(got.entries) == _strip(want.entries)
    else:
        assert extra, "seed 1 is the documented difference"
    for name in extra:
        b, r = want.buckets[0], want.resolutions[0]
        program = jprog.lower(JCFG, batch=b, image_size=r)
        site = next(s for s in program.fusible() if s.name == name)
        assert site.kind == "msa", name
        jblocks = jdrv.sweep_blocks(JCFG, jparams, batch=b, resolution=r)
        assert jget_kernel("msa", "fp").block_work(
            site, jblocks[name]) > 1.0, name
        tsite = next(s for s in tprog.lower(TCFG, batch=b,
                                            image_size=r).fusible()
                     if s.name == name)
        impl = get_kernel("msa", "fp")
        assert all(impl.block_work(tsite, c) == 1.0
                   for c in impl.candidates(tsite)), name
    # with those demotions undone, every other decision agrees
    for key, ds in _strip(want.entries).items():
        mine = {d["name"]: d for d in _strip(got.entries)[key]}
        for d in ds:
            if d["name"] not in extra and not d["group"]:
                assert (d["fused"], d["reason"], d["precision"]) == (
                    mine[d["name"]]["fused"], mine[d["name"]]["reason"],
                    mine[d["name"]]["precision"]), (key, d["name"])


# ---------------------------------------------------------------------------
# artifacts
# ---------------------------------------------------------------------------

def test_artifact_roundtrip(searched, tmp_path):
    _, art = searched
    path = str(tmp_path / "sched.json")
    art.save(path)
    loaded = tsearch.ScheduleArtifact.load(path)
    assert loaded.to_dict() == art.to_dict()
    assert loaded.validate_for(TCFG, "auto") is loaded


def test_artifact_refusals(searched, tmp_path):
    _, art = searched
    doc = art.to_dict()
    doc["schema"] = tsearch.ARTIFACT_SCHEMA + 1
    with pytest.raises(ArtifactError, match="schema"):
        tsearch.ScheduleArtifact.from_dict(doc)
    doc = art.to_dict()
    del doc["buckets"]
    with pytest.raises(ArtifactError, match="malformed"):
        tsearch.ScheduleArtifact.from_dict(doc)
    with pytest.raises(ArtifactError, match="unreadable"):
        tsearch.ScheduleArtifact.load(str(tmp_path / "missing.json"))
    other = dataclasses.replace(TCFG, image_size=96)
    assert tsearch.config_hash(other) != tsearch.config_hash(TCFG)
    with pytest.raises(ArtifactError, match="config"):
        art.validate_for(other, "auto")
    with pytest.raises(ArtifactError, match="precision"):
        art.validate_for(TCFG, "int8")


def test_artifact_uncovered_shape_returns_none(searched):
    _, art = searched
    assert art.buckets == (4,)
    assert art.overrides_for(2, 64) is None
    assert art.overrides_for(4, 640) is None
    ov = art.overrides_for(4, 64)
    assert ov and all(isinstance(v, tfusion.SiteOverride)
                      for v in ov.values())


def test_overrides_reform_the_stored_groups(deep_trees, trace):
    """A search with a split boundary pinned back: the replan from the
    artifact's overrides re-forms exactly the stored groups."""
    params = params_from_jax(deep_trees[0], "cpu")
    art = tsearch.search(TCFG, params, trace, seed=0, iters=4, **SPEC)
    default = _default_groups(TCFG, params, 1, 64)
    g = next(iter(default.values()))
    plan = tfusion.plan_program(
        tprog.lower(TCFG, batch=1, image_size=64), params, autotune=False,
        overrides={g.members[1]: tfusion.SiteOverride(group_break=True)})
    assert [x.members for x in plan.groups.values()] != \
        [x.members for x in default.values()]
    art.entries["1x64"] = [d.to_dict() for d in plan.decisions.values()]
    art.groups["1x64"] = [x.to_dict() for x in plan.groups.values()]
    for b in art.buckets:
        for r in art.resolutions:
            replan = tfusion.plan_program(
                tprog.lower(TCFG, batch=b, image_size=r), params,
                autotune=False, overrides=art.overrides_for(b, r))
            assert [x.to_dict() for x in replan.groups.values()] == \
                art.groups_for(b, r), (b, r)
            assert [d.to_dict() for d in replan.decisions.values()] == \
                art.decisions_for(b, r), (b, r)


def test_each_package_refuses_the_others_artifact(smoke_fp, trace,
                                                  tmp_path):
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jdrv.search(jevit.B1_SMOKE, jax.tree.map(jnp.asarray, smoke_fp), trace,
                iters=4, **SPEC).save(jpath)
    tsearch.search(tevit.B1_SMOKE, params_from_jax(smoke_fp, "cpu"), trace,
                   iters=4, **SPEC).save(tpath)
    with pytest.raises(ArtifactError, match="'jax'.*'torch-cuda'"):
        tsearch.ScheduleArtifact.load(jpath)
    with pytest.raises(JArtifactError, match="schema 2"):
        jart.ScheduleArtifact.load(tpath)
    assert json.load(open(jpath))["schema"] == jart.ARTIFACT_SCHEMA == 1


# ---------------------------------------------------------------------------
# adoption by the serving runtime
# ---------------------------------------------------------------------------

class _Consults:
    """Counts tuner consultations through ``autotune.set_fault_hook``."""

    def __enter__(self):
        self.calls = []
        tat.set_fault_hook(lambda kind, key: self.calls.append(kind))
        return self

    def __exit__(self, *exc):
        tat.set_fault_hook(None)


def test_cache_adopts_the_artifact_with_no_consultation(searched_full):
    params, art = searched_full
    assert art.groups_for(1, 64), "the grouped config's plans hold groups"
    sweeps0 = tat.SWEEP_COUNT
    with _Consults() as c:
        cache = tex.ExecutorCache(params, TCFG, buckets=(8,),
                                  device="cpu", autotune=True, artifact=art)
        assert cache.buckets == art.buckets
        for b in art.buckets:
            for r in art.resolutions:
                plan = cache.get(b, r).plan
                assert [d.to_dict() for d in plan.decisions.values()] == \
                    art.decisions_for(b, r), (b, r)
                assert [g.to_dict() for g in plan.groups.values()] == \
                    art.groups_for(b, r), (b, r)
    assert c.calls == []
    assert tat.SWEEP_COUNT == sweeps0
    # without the artifact the same builds consult the tuners
    with _Consults() as c:
        tex.ExecutorCache(params, TCFG, device="cpu").get(1, 64)
    assert c.calls


def test_cache_refuses_a_stale_artifact_before_building(searched):
    params, art = searched
    with pytest.raises(ArtifactError, match="precision"):
        tex.ExecutorCache(params, TCFG, precision="int8", device="cpu",
                          artifact=art)
    with pytest.raises(ArtifactError, match="config"):
        tex.ExecutorCache(params, tevit.B1_SMOKE, device="cpu",
                          artifact=art)
    with pytest.raises(ValueError, match="not both"):
        tex.ExecutorCache(params, TCFG, device="cpu", artifact=art,
                          overrides={"S1.mb0": tfusion.SiteOverride(
                              fused=False)})


def test_degraded_key_plans_without_the_pins(searched):
    """A kernel-launch fault twice on one site (a retry, then the
    ladder's level-1 demotion): the rebuilt plan demotes that site with
    reason "fault" and drops the artifact's pins (here a "search"
    demotion of the MSA site written into the artifact), so that site is
    planned, and its tuner consulted, as without an artifact."""
    params, art = searched
    art = tsearch.ScheduleArtifact.from_dict(art.to_dict())
    msa = "S3.evit0.msa"
    art.entries["4x64"] = [
        dict(d, fused=False, reason="search", blocks={}, epilogue=None)
        if d["name"] == msa else d for d in art.entries["4x64"]]
    site = "S2.mb1"
    clock = tsched.ManualClock()
    faults = tfaults.FaultPlan(tfaults.FaultSpec(
        "kernel.launch", times=2, match={"batch": 4}, site=site))
    cache = tex.ExecutorCache(params, TCFG, device="cpu", artifact=art,
                              faults=faults, clock=clock)
    healthy = cache.get(4, 64).plan
    assert healthy.get(msa).reason == "search" and healthy.get(site).fused
    sched = tsched.MicroBatchScheduler(cache, cache.params, clock=clock,
                                       backoff_ms=10.0, faults=faults)
    imgs = np.random.default_rng(2).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    reqs = [tsched.Request(i, imgs[i]) for i in range(4)]
    with _Consults() as c:
        for r in reqs:
            sched.submit(r)
        for _ in range(8):
            if not sched.outstanding():
                break
            sched.step(drain=True)
            clock.advance(0.1)
            sched.finalize()
    assert all(r.status == "completed" for r in reqs)
    state = cache.degradation(4, 64)
    assert state is not None and state.level == 1 and site in state.demoted
    plan = cache.get(4, 64).plan
    assert plan.get(site).reason == "fault" and not plan.get(site).fused
    assert plan.get(msa).fused and plan.get(msa).reason == "ok"
    assert c.calls == ["relu_attn"]


def test_sharded_uncovered_local_batch_plans_normally(searched):
    """Bucket 4 over two CPU domains plans at local batch 2, which the
    artifact (bucket 4 alone) does not cover: the normal plan."""
    params, art = searched
    cache = tex.ExecutorCache(params, TCFG, device="cpu", artifact=art,
                              devices=("cpu",) * 2)
    with _Consults() as c:
        ex = cache.get(4, 64)
    assert ex.shard.local_batch == 2 and c.calls
    want = tfusion.plan_program(tprog.lower(TCFG, batch=2, image_size=64),
                                params, autotune=False)
    assert [d.to_dict() for d in ex.plan.decisions.values()] == \
        [d.to_dict() for d in want.decisions.values()]


def test_vision_engine_serves_the_artifact_like_jax(smoke_fp, trace,
                                                    tmp_path):
    """``VisionServeConfig(artifact=path)``: the microbatch is the
    artifact's largest bucket, no tuner is consulted, and the logits
    match JAX's engine serving JAX's artifact searched from the same
    trace and seed."""
    jparams = jax.tree.map(jnp.asarray, smoke_fp)
    tparams = params_from_jax(smoke_fp, "cpu")
    kw = dict(seed=1, iters=16, **SPEC)
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jdrv.search(jevit.B1_SMOKE, jparams, trace, **kw).save(jpath)
    tart = tsearch.search(tevit.B1_SMOKE, tparams, trace, **kw)
    tart.save(tpath)
    with _Consults() as c:
        eng = VisionEngine(tparams, tevit.B1_SMOKE, VisionServeConfig(
            microbatch=1, artifact=tpath), device="cpu")
        assert c.calls == []
    assert eng.microbatch == max(tart.buckets)
    assert eng.cache.buckets == tart.buckets
    assert eng.artifact.to_dict() == tart.to_dict()
    jeng = jvision.VisionEngine(jparams, jevit.B1_SMOKE,
                                jvision.VisionServeConfig(artifact=jpath))
    assert jeng.microbatch == eng.microbatch
    imgs = np.random.default_rng(4).standard_normal(
        (5, 64, 64, 3)).astype(np.float32)
    assert_allclose(eng.logits(imgs).numpy(), np.asarray(jeng.logits(imgs)),
                    rtol=1e-5, atol=1e-5)


def test_engine_traces_the_adoption(searched):
    from repro_torch.obs.trace import Tracer
    params, art = searched
    tracer = Tracer()
    tex.ExecutorCache(params, TCFG, device="cpu", artifact=art,
                      tracer=tracer)
    marks = tracer.spans("artifact.adopt")
    assert len(marks) == 1 and marks[0].track == "executors"
    assert marks[0].attrs["buckets"] == list(art.buckets)
    assert marks[0].attrs["config"] == TCFG.name
