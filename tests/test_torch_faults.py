"""The port's fault ladder (``serving/faults.py``, ``plan_program(demote=)``,
the executor cache's negative cache and degradation ladder, the
scheduler's retries, watchdog, result cache and host loop) against the
JAX package, on the CPU.

- Plans with demoted sites: the same decisions (name, fused, reason) and
  super-site groups as JAX's.
- The scheduler's failure policy against scriptable fake caches, as
  ``tests/test_fault_tolerance.py`` and ``tests/test_sharded_serving.py``
  sweep JAX's.
- One request trace and one ``FaultPlan`` on a ``ManualClock`` through
  JAX's scheduler and the port's: the same outcome per request, the same
  telemetry, the same ladder state per key.
- Level-1 and level-2 forwards against JAX's within rtol = atol = 1e-5
  (fp32 on both sides), JAX run op by op (``jax.disable_jit``, ROADMAP
  R5).
On the CPU no executor captures a CUDA graph.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from proptest import sweep
from test_torch_fix8 import _fp_tree
from test_torch_supersite import GROUPS, JCFG, TCFG, _trees

from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro.serving import executors as jex
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro.serving.telemetry import Telemetry as JTelemetry
from repro_torch.common.errors import (
    CapacityExceeded, DeadlineExceeded, ExecutorError, KernelLaunchError,
    ReproError)
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.core.quantization import quantize_efficientvit
from repro_torch.kernels.registry import kernel_wrappers
from repro_torch.serving import executors as tex
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import vision as tvision
from repro_torch.serving.telemetry import Telemetry

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    """B1_SMOKE as numpy (JAX's init, BN statistics perturbed)."""
    return _fp_tree(jevit.B1_SMOKE, 0)


@pytest.fixture(scope="module")
def tsmoke(smoke):
    return params_from_jax(smoke, "cpu")


@pytest.fixture(scope="module")
def deep():
    return _trees(JCFG, 0)


@pytest.fixture(scope="module")
def b1():
    return _trees(jevit.B1, 1)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _groups(plan):
    return {g.name: tuple(g.members) for g in plan.groups.values()}


def _decisions(plan):
    return {d.name: (d.fused, d.reason, d.group)
            for d in plan.decisions.values()}


# ---------------------------------------------------------------------------
# plan_program(demote=)
# ---------------------------------------------------------------------------

DEMOTIONS = [("b1", ("S1.mb0",)), ("b1", ("S1.mb1",)), ("b1", ("S2.mb0",)),
             ("b1", ("S2.mb1",)), ("b1", ("S2.mb2",)),
             ("b1", ("S3.evit0.msa",)), ("b1", ("stem.ds0",)),
             ("b1", ("S2.mb0", "S2.mb2")), ("deep", ("stem.ds1",)),
             ("deep", ("S2.mb1",))]


@pytest.mark.parametrize("precision", ["fp", "int8"])
@pytest.mark.parametrize("cfg,demote", DEMOTIONS)
def test_demote_matches_jax(b1, deep, cfg, demote, precision,
                            tmp_autotune_cache):
    """Every member of B1's two chains, two standalone sites, two members
    at once, and the deep config's chains: the demoted site takes reason
    "fault", leaves its group, and the members around it regroup as
    JAX's grouping pass regroups them."""
    jcfg, tcfg = (jevit.B1, tevit.B1) if cfg == "b1" else (JCFG, TCFG)
    fp, q = b1 if cfg == "b1" else deep
    tree = fp if precision == "fp" else q
    j = jfusion.plan_program(jprog.lower(jcfg), _jtree(tree),
                             autotune=False, demote=demote)
    t = tfusion.plan_program(tprog.lower(tcfg), params_from_jax(tree, "cpu"),
                             demote=demote)
    assert _decisions(t) == _decisions(j)
    assert _groups(t) == _groups(j)
    for name in demote:
        assert t.decisions[name].reason == "fault"
        assert not t.decisions[name].fused and not t.decisions[name].group
    assert tfusion.launch_counts(t) == jfusion.launch_counts(j)


def test_demote_splits_the_chains_as_expected(deep):
    """The regrouping spelled out on the deep config."""
    tp = params_from_jax(deep[0], "cpu")
    program = tprog.lower(TCFG)
    assert _groups(tfusion.plan_program(program, tp)) == GROUPS
    mid = tfusion.plan_program(program, tp, demote={"S2.mb1"})
    assert _groups(mid) == {k: v for k, v in GROUPS.items()
                            if k != "S2.ss0"}
    head = tfusion.plan_program(program, tp, demote={"S2.mb0"})
    assert _groups(head)["S2.ss0"] == ("S2.mb1", "S2.mb2")


# ---------------------------------------------------------------------------
# FaultPlan mechanics
# ---------------------------------------------------------------------------

def test_fault_points_and_errors_match_jax():
    assert tfaults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert {p: e.__name__ for p, e in tfaults._ERROR_FOR_POINT.items()} == \
        {p: e.__name__ for p, e in jfaults._ERROR_FOR_POINT.items()}
    assert set(tfaults._ERROR_FOR_POINT) | {"epilogue.numerics"} == \
        set(tfaults.FAULT_POINTS)


def test_fault_plan_budget_and_matching():
    plan = tfaults.FaultPlan(tfaults.FaultSpec(
        "kernel.launch", times=2, match={"resolution": 64}, site="S"))
    plan.fire("kernel.launch", resolution=32)          # no match: no-op
    with pytest.raises(KernelLaunchError) as ei:
        plan.fire("kernel.launch", resolution=64)
    assert ei.value.site == "S"
    with pytest.raises(KernelLaunchError):
        plan.fire("kernel.launch", resolution=64)
    plan.fire("kernel.launch", resolution=64)          # budget spent
    assert plan.exhausted and plan.fired == {"kernel.launch": 2}
    blame = tfaults.FaultPlan(tfaults.FaultSpec("kernel.launch"))
    with pytest.raises(KernelLaunchError) as ei:
        blame.fire("kernel.launch", sites=("a", "b"))
    assert ei.value.site == "a"                        # first fused site
    with pytest.raises(CapacityExceeded):
        tfaults.FaultPlan(tfaults.FaultSpec("queue.overload")).fire(
            "queue.overload")
    with pytest.raises(ValueError, match="unknown fault point"):
        tfaults.FaultSpec("no.such.point")


def test_fault_plan_corrupt_is_silent_and_writes_a_new_tensor():
    plan = tfaults.FaultPlan(tfaults.FaultSpec("epilogue.numerics"))
    out = torch.ones((2, 3))
    bad = plan.corrupt("epilogue.numerics", out)
    assert bad is not out and bool(torch.isnan(bad[..., 0]).all())
    assert bool(torch.isfinite(out).all()), "the given tensor is untouched"
    again = plan.corrupt("epilogue.numerics", out)     # budget spent
    assert again is out
    assert plan.fired == {"epilogue.numerics": 1}


def test_injected_faults_are_marked(tsmoke):
    """What a ``FaultPlan`` raises or corrupts carries ``injected``, and
    so does a negative-cache hit on an injected build failure: on the
    card only such faults move the ladder.  Errors raised anywhere else
    are real."""
    plan = tfaults.FaultPlan(
        tfaults.FaultSpec("kernel.launch"), tfaults.FaultSpec("autotune"),
        tfaults.FaultSpec("queue.overload"),
        tfaults.FaultSpec("device.dropout"),
        tfaults.FaultSpec("epilogue.numerics"))
    for point in ("kernel.launch", "autotune", "queue.overload",
                  "device.dropout"):
        with pytest.raises(ReproError) as ei:
            plan.fire(point)
        assert ei.value.injected, point
    assert plan.corrupt("epilogue.numerics", torch.ones((1, 2))).injected
    assert not ExecutorError("real").injected
    assert not KernelLaunchError("real", site="S").injected
    clock = tsched.ManualClock()
    cache = _cache(tsmoke, clock=clock, faults=tfaults.FaultPlan(
        tfaults.FaultSpec("executor.compile")))
    with pytest.raises(ExecutorError) as first:
        cache.get(1, 32)
    with pytest.raises(ExecutorError, match="negative-cached") as hit:
        cache.get(1, 32)
    assert first.value.injected and hit.value.injected


def test_idle_fault_plan_is_inert(tsmoke):
    idle = tfaults.FaultPlan()
    plain = tex.ExecutorCache(tsmoke, tevit.B1_SMOKE, buckets=(1,),
                              telemetry=Telemetry(), device="cpu")
    chaos = tex.ExecutorCache(tsmoke, tevit.B1_SMOKE, buckets=(1,),
                              telemetry=Telemetry(), device="cpu",
                              faults=idle)
    x = torch.zeros((1, 32, 32, 3))
    assert torch.equal(plain.get(1, 32)(plain.params, x),
                       chaos.get(1, 32)(chaos.params, x))
    assert idle.fired == {} and idle.exhausted
    assert "shed" not in chaos.telemetry.counters
    assert "degraded" not in chaos.telemetry.counters


# ---------------------------------------------------------------------------
# the executor cache: negative cache, ladder, no graph on the CPU
# ---------------------------------------------------------------------------

def _cache(params, cfg=tevit.B1_SMOKE, *, faults=None, clock=None,
           neg_ttl_s=1.0, **kw):
    kw.setdefault("buckets", (1, 2))
    return tex.ExecutorCache(params, cfg, faults=faults, clock=clock,
                             neg_ttl_s=neg_ttl_s, telemetry=Telemetry(),
                             device="cpu", **kw)


def test_failed_build_leaves_no_half_built_entry(tsmoke):
    faults = tfaults.FaultPlan(tfaults.FaultSpec("executor.compile"))
    cache = _cache(tsmoke, faults=faults, clock=tsched.ManualClock())
    with pytest.raises(ExecutorError):
        cache.get(1, 32)
    assert len(cache) == 0 and cache.keys() == ()
    assert cache._donor_plans == {}, "a failed build publishes no donor"
    assert cache.telemetry.counters["executor_build_failed"] == 1


def test_negative_cache_ttl(tsmoke):
    faults = tfaults.FaultPlan(tfaults.FaultSpec("executor.compile"))
    clock = tsched.ManualClock()
    cache = _cache(tsmoke, faults=faults, clock=clock, neg_ttl_s=2.0)
    with pytest.raises(ExecutorError):
        cache.get(1, 32)
    with pytest.raises(ExecutorError, match="negative-cached"):
        cache.get(1, 32)
    assert cache.telemetry.counters["negative_cache_hit"] == 1
    assert cache.telemetry.counters["executor_build_failed"] == 1
    clock.advance(2.5)             # TTL expired; fault budget spent
    ex = cache.get(1, 32)
    assert ex.plan is not None and len(cache) == 1


def test_degradation_ladder_levels(tsmoke):
    cache = _cache(tsmoke)
    assert cache.degradation(1, 32) is None
    s1 = cache.degrade(1, 32, site="stem.ds0")
    assert s1.level == 1 and s1.demoted == frozenset({"stem.ds0"})
    ex1 = cache.get(1, 32)
    assert ex1.degraded == s1
    assert ex1.plan.decisions["stem.ds0"].reason == "fault"
    assert "stem.ds0" not in ex1.fused_sites and ex1.fused_sites
    s1b = cache.degrade(1, 32, site="S2.mb0")      # a second site, level 1
    assert s1b.level == 1 and s1b.demoted == {"stem.ds0", "S2.mb0"}
    assert cache.get(1, 32) is not ex1, "a ladder move drops the executor"
    s2 = cache.degrade(1, 32, site="stem.ds0")     # nothing left: level 2
    assert s2.level == 2
    ex2 = cache.get(1, 32)
    assert ex2.plan is None and ex2.fused_sites == ()
    assert cache.telemetry.counters["degraded"] == 3


def test_pin_fp_and_degraded_plans_never_donate(tsmoke):
    cache = tex.ExecutorCache(quantize_efficientvit(tsmoke), tevit.B1_SMOKE,
                              buckets=(1, 2), precision="int8",
                              telemetry=Telemetry(), device="cpu")
    st = cache.pin_fp(1, 32)
    assert st.pinned_fp and st.degraded and st.level == 0
    ex = cache.get(1, 32)          # degraded build: forced-fp plan
    assert not any(d.precision == "int8"
                   for d in ex.plan.decisions.values() if d.fused)
    assert not ex._runs_int8
    assert cache._donor_plans == {}, \
        "a degraded plan must not become the resolution's donor"
    ex2 = cache.get(2, 32)         # healthy key at the same resolution
    assert ex2._runs_int8, "the fp pin must not leak into healthy buckets"
    assert cache._donor_plans[32] is ex2.plan


def test_warmup_evicts_an_entry_whose_warmup_fails(tsmoke, monkeypatch):
    cache = _cache(tsmoke)

    def boom(self, params):
        raise ExecutorError("warm-up crashed")
    monkeypatch.setattr(tex.Executor, "warm", boom)
    with pytest.raises(ExecutorError):
        cache.warmup([32], buckets=(1,))
    assert len(cache) == 0
    assert cache.telemetry.counters["executor_build_failed"] == 1


def test_no_graph_is_captured_on_the_cpu(tsmoke):
    """On the CPU an executor runs eagerly: no graph, no static buffers,
    no pool; a partial batch is padded with zeros."""
    cache = _cache(tsmoke, buckets=(2,))
    assert cache.pool is None
    cache.warmup([32])
    ex = cache.get(2, 32)
    assert ex.warmed and ex.graph is None and ex.static_in is None
    assert ex.replay_launches == {}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 32, 32, 3)).astype(np.float32))
    got = ex(cache.params, x)
    want = tprog.execute(ex.program, cache.params,
                         torch.cat([x, torch.zeros_like(x)]), plan=ex.plan)
    assert got.shape == (2, 10) and torch.equal(got, want)
    assert ex.graph is None
    with pytest.raises(ValueError, match="takes"):
        ex(cache.params, torch.zeros((3, 32, 32, 3)))


def test_kernel_wrappers_name_every_counter():
    wrappers = kernel_wrappers()
    assert len(wrappers) == 14
    assert all(isinstance(w.launches, int) for w in wrappers.values())


# ---------------------------------------------------------------------------
# the scheduler's policy against scriptable fake caches
# ---------------------------------------------------------------------------

class FakeExecutor:
    degraded = None

    def __init__(self, cache, bucket):
        self.cache, self.bucket = cache, bucket

    def __call__(self, params, x):
        if self.cache.call_faults:
            raise self.cache.call_faults.pop(0)
        n = int(x.shape[0])
        if self.cache.echo:     # each row's mean: ordering bugs show
            out = np.mean(np.asarray(x).reshape(n, -1), axis=1,
                          keepdims=True).astype(np.float32)
        else:
            out = np.full((n, 4), float(self.bucket), np.float32)
        if self.cache.nan_calls > 0:
            self.cache.nan_calls -= 1
            out = out.copy()
            out[..., 0] = np.nan
        return out


class FakeCache:
    """Quacks like ExecutorCache for the scheduler: scripted failures,
    recorded degradations, instant host-only executors."""
    precision = "auto"

    def __init__(self, *, buckets=(1, 2, 4), get_faults=(), call_faults=(),
                 nan_calls=0, echo=False, degraded=None):
        self.buckets = tuple(buckets)
        self.telemetry = Telemetry()
        self.get_faults = list(get_faults)
        self.call_faults = list(call_faults)
        self.nan_calls = int(nan_calls)
        self.echo = echo
        self._degraded = degraded
        self.degrades, self.pins = [], []

    def get(self, batch, resolution):
        if self.get_faults:
            raise self.get_faults.pop(0)
        ex = FakeExecutor(self, batch)
        ex.degraded = self._degraded
        return ex

    def degrade(self, batch, resolution, *, site=None):
        self.degrades.append((batch, resolution, site))

    def pin_fp(self, batch, resolution):
        self.pins.append((batch, resolution))


def _drain(sched, clock, max_rounds=64):
    for _ in range(max_rounds):
        if not sched.outstanding():
            return
        sched.step(drain=True)
        sched.finalize()
        clock.advance(0.1)
    raise AssertionError(f"not drained: {sched.outstanding()} left")


def _reqs(n, res=32, seed=None, **kw):
    rng = np.random.default_rng(seed)
    return [tsched.Request(rid=i, image=(
        np.zeros((res, res, 3), np.float32) if seed is None
        else rng.standard_normal((res, res, 3)).astype(np.float32)), **kw)
        for i in range(n)]


def test_scheduler_retry_then_success():
    cache = FakeCache(get_faults=[ExecutorError("flaky build")])
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(cache, None, clock=clock,
                                       backoff_ms=10.0)
    reqs = _reqs(4)
    for r in reqs:
        sched.submit(r)
    sched.step(drain=True)                   # dispatch fails, parks retry
    assert sched.outstanding() == 4 and sched.queue_depth() == 0
    clock.advance(0.005)
    sched.step()                             # backoff (10 ms) not elapsed
    assert sched.queue_depth() == 0
    clock.advance(0.01)
    sched.step()
    sched.finalize()
    assert all(r.status == "completed" for r in reqs)
    assert all(r.retries == 1 for r in reqs)
    assert cache.telemetry.counters["retries"] == 4
    assert cache.degrades == [], "one transient failure: no degrade yet"


def test_scheduler_degrades_on_second_failure_with_site_blame():
    cache = FakeCache(call_faults=[
        KernelLaunchError("boom", site="S3.evit0.msa"),
        KernelLaunchError("boom", site="S3.evit0.msa")])
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(cache, None, clock=clock)
    reqs = _reqs(4)
    for r in reqs:
        sched.submit(r)
    _drain(sched, clock)
    assert all(r.status == "completed" for r in reqs)
    assert cache.degrades == [(4, 32, "S3.evit0.msa")]


def test_scheduler_pins_fp_on_nan_logits():
    cache = FakeCache(nan_calls=1)
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(cache, None, clock=clock)
    reqs = _reqs(4)
    for r in reqs:
        sched.submit(r)
    _drain(sched, clock)
    assert all(r.status == "completed" for r in reqs)
    assert cache.pins == [(4, 32)] and cache.degrades == []
    assert all(np.all(np.isfinite(r.logits)) for r in reqs)
    assert cache.telemetry.bucket((4, 32, "auto")).errors == 1


def test_scheduler_exhausts_retries_into_failed():
    cache = FakeCache(get_faults=[ExecutorError(f"f{i}") for i in range(9)])
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(cache, None, clock=clock,
                                       max_retries=2)
    reqs = _reqs(2)
    for r in reqs:
        sched.submit(r)
    _drain(sched, clock)
    assert all(r.status == "failed" for r in reqs)
    assert all(isinstance(r.error, ExecutorError) for r in reqs)
    assert all(r.retries == 3 for r in reqs)   # initial + 2 retries


def test_scheduler_capacity_shed():
    cache = FakeCache()
    sched = tsched.MicroBatchScheduler(cache, None,
                                       clock=tsched.ManualClock(),
                                       max_queue_depth=2)
    reqs = _reqs(5)
    admitted = [sched.submit(r) for r in reqs]
    assert admitted == [True, True, False, False, False]
    shed = [r for r in reqs if r.status == "shed"]
    assert len(shed) == 3
    assert all(isinstance(r.error, CapacityExceeded) for r in shed)
    assert cache.telemetry.counters["shed_capacity"] == 3


def test_scheduler_deadline_shed_before_formation():
    cache = FakeCache()
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(cache, None, clock=clock)
    stale = _reqs(2, timeout_ms=5.0)
    for r in stale:
        sched.submit(r)
    clock.advance(0.02)
    fresh = _reqs(2, timeout_ms=1000.0)
    for r in fresh:
        r.rid += 100
        sched.submit(r)
    _drain(sched, clock)
    assert all(r.status == "shed" and isinstance(r.error, DeadlineExceeded)
               for r in stale)
    assert all(r.status == "completed" for r in fresh)
    assert cache.telemetry.counters["shed_deadline"] == 2
    assert cache.telemetry.total("samples") == 2, "no slot for the stale"


def test_scheduler_serve_raises_typed_error_on_shed():
    sched = tsched.MicroBatchScheduler(FakeCache(), None,
                                       clock=tsched.ManualClock(),
                                       max_queue_depth=1)
    with pytest.raises(CapacityExceeded):
        sched.serve(_reqs(3))


@sweep(n_cases=40, seed=6)
def test_scheduler_terminal_state_partition(rng):
    """Random arrivals x timeouts x fault schedules: every request ends
    in exactly one of completed/shed/failed; none lost or duplicated."""
    n = int(rng.integers(1, 12))
    faults = []
    for _ in range(int(rng.integers(0, 4))):
        kind = rng.choice(["get", "call"])
        err = (ExecutorError("inj-get") if kind == "get"
               else KernelLaunchError("inj-call", site="s"))
        faults.append((kind, err))
    cache = FakeCache(
        get_faults=[e for k, e in faults if k == "get"],
        call_faults=[e for k, e in faults if k == "call"],
        nan_calls=int(rng.integers(0, 2)))
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(
        cache, None, clock=clock,
        max_queue_depth=(int(rng.integers(1, 16))
                         if rng.random() < 0.3 else None),
        max_retries=int(rng.integers(0, 4)),
        backoff_ms=float(rng.choice([0.0, 5.0, 50.0])),
        watchdog_ms=(None if rng.random() < 0.5 else 30.0))
    reqs = []
    for i in range(n):
        timeout = (None if rng.random() < 0.5
                   else float(rng.choice([0.5, 20.0, 1e6])))
        r = tsched.Request(rid=i, image=np.zeros((32, 32, 3), np.float32),
                           timeout_ms=timeout,
                           deadline_ms=(None if rng.random() < 0.5
                                        else 10.0))
        reqs.append(r)
        sched.submit(r)
        clock.advance(float(rng.random()) * 0.02)
        if rng.random() < 0.7:
            sched.step()
        if rng.random() < 0.3:
            sched.finalize()
    _drain(sched, clock, max_rounds=128)
    states = {"completed": 0, "shed": 0, "failed": 0}
    for r in reqs:
        assert r.status in states, (r.rid, r.status)
        states[r.status] += 1
        if r.status == "completed":
            assert r.logits is not None and np.all(np.isfinite(r.logits))
        else:
            assert isinstance(r.error, ReproError), (r.rid, r.error)
    assert sum(states.values()) == n
    tel = cache.telemetry.counters
    assert tel.get("submitted", 0) == n
    assert (tel.get("completed", 0) == states["completed"]
            and tel.get("shed", 0) == states["shed"]
            and tel.get("failed", 0) == states["failed"])


# ---------------------------------------------------------------------------
# the result cache, the watchdog, the host loop
# ---------------------------------------------------------------------------

def test_result_cache_hit_miss_lru_and_refusal():
    rc = tsched.ResultCache(capacity=2)
    a, b, c = (np.full((4, 4, 3), v, np.float32) for v in (1.0, 0.0, 2.0))
    assert rc.get(a) is None and rc.misses == 1
    assert rc.put(a, np.arange(4.0))
    np.testing.assert_array_equal(rc.get(a), np.arange(4.0))
    assert rc.hits == 1
    rc.put(b, np.arange(4.0) + 1)
    rc.put(c, np.arange(4.0) + 2)          # capacity 2: evicts a (LRU)
    assert rc.get(a) is None and len(rc) == 2
    assert rc.get(b.copy()) is not None    # content, not identity
    assert not rc.put(a, np.array([1.0, np.nan]))
    assert not rc.put(a, np.array([np.inf]))
    assert rc.get(a) is None


def test_result_cache_admits_only_healthy_results():
    """A hit completes at submit, ahead of the queue bound; results of a
    degraded executor, or non-finite ones, never enter the cache."""
    cache = FakeCache(echo=True)
    sched = tsched.MicroBatchScheduler(cache, None,
                                       clock=tsched.ManualClock(),
                                       result_cache=8, max_queue_depth=2)
    first = _reqs(2, res=8, seed=0)
    for r in first:
        sched.submit(r)
    sched.step(drain=True)
    sched.finalize()
    tel = cache.telemetry.counters
    assert tel["result_cache_miss"] == 2 and tel["result_cache_store"] == 2
    again = [tsched.Request(rid=10 + i, image=first[i].image)
             for i in range(2)]
    for r in again:
        assert sched.submit(r) and r.status == "completed"
    assert tel["result_cache_hit"] == 2 and sched.queue_depth() == 0
    assert_allclose(np.ravel(again[0].logits), [np.mean(first[0].image)],
                    rtol=1e-6)

    class Degraded:
        degraded = True
    for cache in (FakeCache(echo=True, degraded=Degraded()),
                  FakeCache(echo=True, nan_calls=1)):
        sched = tsched.MicroBatchScheduler(cache, None,
                                           clock=tsched.ManualClock(),
                                           result_cache=8)
        reqs = _reqs(2, res=8, seed=1)
        for r in reqs:
            sched.submit(r)
        _drain(sched, sched.clock)
        assert all(r.status == "completed" for r in reqs)
        stored = cache.telemetry.counters.get("result_cache_store", 0)
        assert stored == (0 if cache._degraded is not None else 2)
        assert len(sched.results) == stored


def test_watchdog_retries_on_a_rebuilt_executor(tsmoke):
    """A batch held in flight past ``watchdog_ms`` is declared hung: the
    ladder moves at once (``DeadlineExceeded`` is persistent) and the
    requests complete on a rebuilt executor, at the reference level."""
    clock = tsched.ManualClock()
    cache = _cache(tsmoke, buckets=(4,), clock=clock)
    sched = tsched.MicroBatchScheduler(cache, cache.params, clock=clock,
                                       watchdog_ms=50.0, backoff_ms=0.0)
    reqs = _reqs(4, seed=2)
    for r in reqs:
        sched.submit(r)
    sched.step(drain=True)               # dispatched, now in flight
    first = cache.get(4, 32)
    clock.advance(0.2)                   # blow the 50 ms bound
    sched.step()                         # watchdog sweeps, then re-forms
    assert cache.telemetry.counters["watchdog_fired"] == 1
    assert cache.degradation(4, 32).level == 2
    assert all(r.retries == 1 for r in reqs)
    sched.finalize()
    assert all(r.status == "completed" for r in reqs)
    rebuilt = cache.get(4, 32)
    assert rebuilt is not first and rebuilt.plan is None
    want = tprog.execute(rebuilt.program, cache.params, torch.from_numpy(
        np.stack([r.image for r in reqs])))
    assert_allclose(np.stack([r.logits for r in reqs]), want.numpy(), **TOL)


def test_watchdog_spares_fresh_batches():
    cache = FakeCache()
    clock = tsched.ManualClock()
    sched = tsched.MicroBatchScheduler(cache, None, clock=clock,
                                       watchdog_ms=50.0)
    reqs = _reqs(4)
    for r in reqs:
        sched.submit(r)
    sched.step(drain=True)
    clock.advance(0.01)
    sched.finalize()
    assert all(r.status == "completed" for r in reqs)
    assert "watchdog_fired" not in cache.telemetry.counters


def test_host_loop_completes_every_request(tsmoke):
    """start / wait / stop over a real executor cache: the loop serves
    full buckets with no foreground step or finalize, each request gets
    its own image's logits, and stop drains a tail no bucket fills."""
    engine = tvision.VisionEngine(tsmoke, tevit.B1_SMOKE,
                                  tvision.VisionServeConfig(microbatch=2),
                                  device="cpu")
    imgs = np.random.default_rng(3).standard_normal(
        (5, 32, 32, 3)).astype(np.float32)
    want = engine.logits(imgs).numpy()
    sched = engine.scheduler(clock=tsched.ManualClock())
    sched.start(poll_s=0.001)
    try:
        reqs = [tsched.Request(i, imgs[i]) for i in range(5)]
        for r in reqs:
            sched.submit(r)
        assert sched.wait(reqs[:4], timeout_s=120.0), \
            [(r.rid, r.status) for r in reqs]
        assert sched.running
    finally:
        sched.stop(drain=True)
    assert not sched.running
    assert all(r.status == "completed" for r in reqs)
    assert_allclose(np.stack([r.logits for r in reqs]), want, **TOL)


def test_host_loop_concurrent_submitters():
    cache = FakeCache(echo=True)
    sched = tsched.MicroBatchScheduler(cache, None,
                                       clock=tsched.ManualClock())
    sched.start(poll_s=0.001)
    groups = [_reqs(4, res=8, seed=10 + g) for g in range(4)]
    threads = [threading.Thread(
        target=lambda g=g: [sched.submit(r) for r in g]) for g in groups]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    flat = [r for g in groups for r in g]
    assert sched.wait(flat, timeout_s=30.0)
    sched.stop()
    for r in flat:
        assert_allclose(np.ravel(r.logits), [np.mean(r.image)], rtol=1e-6)


def test_wait_times_out_without_loop():
    sched = tsched.MicroBatchScheduler(FakeCache(), None,
                                       clock=tsched.ManualClock())
    r = _reqs(1)[0]
    sched.submit(r)
    t0 = time.monotonic()
    assert not sched.wait([r], timeout_s=0.1)
    assert time.monotonic() - t0 < 5.0


def test_engine_scheduler_defaults(tsmoke):
    faults = tfaults.FaultPlan()
    eng = tvision.VisionEngine(
        tsmoke, tevit.B1_SMOKE,
        tvision.VisionServeConfig(microbatch=2, result_cache=4,
                                  watchdog_ms=500.0),
        device="cpu", faults=faults)
    assert eng.cache.faults is faults
    s = eng.scheduler(max_retries=1)
    assert s.faults is faults and s.watchdog_ms == 500.0
    assert s.results.capacity == 4 and s.max_retries == 1
    assert eng.scheduler(faults=None, result_cache=None).faults is None


# ---------------------------------------------------------------------------
# the port against JAX under one fault schedule
# ---------------------------------------------------------------------------

def _fault_plan(mod):
    return mod.FaultPlan(
        mod.FaultSpec("queue.overload", times=1),
        mod.FaultSpec("executor.compile", times=1, match={"batch": 2}),
        mod.FaultSpec("kernel.launch", times=2, match={"batch": 1},
                      site="S2.mb0"))


def _replay(emod, smod, fmod, cache_kw, params):
    """One trace on a ManualClock: an overload shed, a compile failure
    (negative-cached, then a level-2 rebuild), a kernel-launch fault
    twice on one site (a retry, then a level-1 demotion), a request
    whose hard deadline passes while queued."""
    clock = smod.ManualClock()
    faults = _fault_plan(fmod)
    cache = emod.ExecutorCache(params, buckets=(1, 2), faults=faults,
                               clock=clock, neg_ttl_s=1.0, **cache_kw)
    sched = smod.MicroBatchScheduler(cache, params, clock=clock,
                                     backoff_ms=10.0, faults=faults)
    imgs = np.random.default_rng(5).standard_normal(
        (7, 32, 32, 3)).astype(np.float32)
    reqs = [smod.Request(i, imgs[i]) for i in range(3)]
    reqs.append(smod.Request(3, imgs[3], deadline_ms=0.0))
    reqs.append(smod.Request(4, imgs[4], timeout_ms=1.0))
    reqs += [smod.Request(i, imgs[i]) for i in (5, 6)]
    for r in reqs[:3]:
        sched.submit(r)                  # r0 shed: overload
    sched.step()                         # (2, 32): compile fault
    sched.submit(reqs[3])
    sched.step()                         # (1, 32): launch fault
    sched.submit(reqs[4])
    clock.advance(0.005)
    sched.step()                         # r4 expired: shed
    clock.advance(0.05)
    sched.step()                         # retries ripe: faults again
    for r in reqs[5:]:
        sched.submit(r)
    for _ in range(16):
        if not sched.outstanding():
            break
        clock.advance(0.1)
        sched.step(drain=True)
        sched.finalize()
    tel = cache.telemetry
    states = {k: cache.degradation(*k) for k in ((1, 32), (2, 32))}
    return (
        [(r.status, r.retries, type(r.error).__name__) for r in reqs],
        dict(tel.counters),
        {k: (b.dispatches, b.samples, b.padded, b.errors)
         for k, b in tel.buckets.items()},
        {k: None if s is None else (s.level, sorted(s.demoted), s.pinned_fp)
         for k, s in states.items()},
        faults.fired), reqs


def test_fault_replay_matches_jax(smoke, tmp_autotune_cache):
    j, jreqs = _replay(jex, jsched, jfaults,
                       dict(cfg=jevit.B1_SMOKE, autotune=False,
                            telemetry=JTelemetry()), _jtree(smoke))
    t, treqs = _replay(tex, tsched, tfaults,
                       dict(cfg=tevit.B1_SMOKE, telemetry=Telemetry(),
                            device="cpu"), params_from_jax(smoke, "cpu"))
    assert t == j
    outcome, counters, _, states, fired = t
    assert outcome[0] == ("shed", 0, "CapacityExceeded")
    assert outcome[4] == ("shed", 0, "DeadlineExceeded")
    assert all(o[0] == "completed" for i, o in enumerate(outcome)
               if i not in (0, 4))
    assert states[(1, 32)] == (1, ["S2.mb0"], False)
    assert states[(2, 32)][0] == 2
    assert counters["negative_cache_hit"] == 1
    assert fired == {"queue.overload": 1, "executor.compile": 1,
                     "kernel.launch": 2}
    for a, b in zip(treqs, jreqs):
        if a.status == "completed":
            assert_allclose(a.logits, np.asarray(b.logits), **TOL)


@pytest.mark.parametrize("batch", [1, 2])
def test_ladder_forwards_match_jax(deep, batch, tmp_autotune_cache):
    """Level 1 (a middle chain member demoted: S2.ss0 splits) and level 2
    (the reference interpreter) against JAX's executors at the same
    ladder state."""
    fp = deep[0]
    jparams = _jtree(fp)
    jcache = jex.ExecutorCache(jparams, JCFG, buckets=(batch,),
                               autotune=False, telemetry=JTelemetry())
    tcache = tex.ExecutorCache(params_from_jax(fp, "cpu"), TCFG,
                               buckets=(batch,), telemetry=Telemetry(),
                               device="cpu")
    x = np.random.default_rng(7 + batch).standard_normal(
        (batch, 64, 64, 3)).astype(np.float32)
    for site in ("S2.mb1", None):
        js = jcache.degrade(batch, 64, site=site)
        ts = tcache.degrade(batch, 64, site=site)
        assert (ts.level, ts.demoted, ts.pinned_fp) == \
            (js.level, js.demoted, js.pinned_fp)
        jexr, texr = jcache.get(batch, 64), tcache.get(batch, 64)
        if site is not None:
            assert _groups(texr.plan) == _groups(jexr.plan) == {
                k: v for k, v in GROUPS.items() if k != "S2.ss0"}
            assert texr.fused_sites == jexr.fused_sites
        else:
            assert texr.plan is None and jexr.plan is None
        with jax.disable_jit():
            want = np.asarray(jexr(jparams, jnp.asarray(x)))
        got = texr(tcache.params, torch.from_numpy(x))
        assert_allclose(got.numpy(), want, **TOL)


def test_pinned_fix8_key_matches_jax(deep, tmp_autotune_cache):
    """``epilogue.numerics`` once on a FIX8 key: finalize finds the NaN,
    the key pins to fp, the retry completes on a plan that runs no int8
    kernel.  The pinned plan's decisions equal JAX's, and its forward
    JAX's pinned executor's, run op by op."""
    q = deep[1]
    faults = tfaults.FaultPlan(tfaults.FaultSpec("epilogue.numerics"))
    cache = tex.ExecutorCache(params_from_jax(q, "cpu"), TCFG, buckets=(2,),
                              precision="int8", telemetry=Telemetry(),
                              device="cpu", faults=faults)
    sched = tsched.MicroBatchScheduler(cache, cache.params,
                                       clock=tsched.ManualClock())
    imgs = np.random.default_rng(9).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    reqs = [tsched.Request(i, imgs[i]) for i in range(2)]
    out = sched.serve(reqs)
    assert faults.exhausted and cache.degradation(2, 64).pinned_fp
    assert cache.telemetry.counters["pinned_fp"] == 1
    assert all(r.retries == 1 for r in reqs)
    ex = cache.get(2, 64)
    assert not ex._runs_int8
    jparams = _jtree(q)
    jcache = jex.ExecutorCache(jparams, JCFG, buckets=(2,), precision="int8",
                               autotune=False, telemetry=JTelemetry())
    jcache.pin_fp(2, 64)
    jexr = jcache.get(2, 64)
    assert _decisions(ex.plan) == _decisions(jexr.plan)
    assert ex.fused_sites == jexr.fused_sites
    with jax.disable_jit():
        want = np.asarray(jexr(jparams, jnp.asarray(imgs)))
    assert_allclose(out, want, **TOL)
