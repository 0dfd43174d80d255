"""The port's observability layer (``repro_torch.obs``: the tracer, the
metrics registry, the per-site profiler) and its cycle model
(``repro_torch.core.accelerator_model``) against the JAX package, on the
CPU.

- The same scripted runs on a ``ManualClock`` through JAX's scheduler
  and the port's, on scriptable fake caches (the idiom of
  ``tests/test_obs.py``), give the same Chrome trace: names, tracks,
  parent links, timestamps and attributes.  A plain run, a retry, a
  watchdog firing, a device loss and a lost mesh; and the executor
  cache's build spans and ladder / mesh marks on real caches.
- ``repro_torch.obs.trace`` imports neither ``jax`` nor ``repro``.
- Prometheus text and JSON equal to JAX's for telemetry filled by the
  same calls.
- ``analyze_program`` and ``site_breakdown`` equal to JAX's, float for
  float, on B1@224 and B1_SMOKE, with no plan and with each package's
  own plan; ``drift_report`` on a scripted timer equal to JAX's.
- ``execute(profile=)`` records every site once per repeat, groups off.
"""
import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_torch_fix8 import _fp_tree
from test_torch_supersite import GROUPS, JCFG, TCFG, _trees

from repro.common import errors as jerrors
from repro.core import accelerator_model as jam
from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro.core import quantization as jq
from repro.obs import metrics as jmetrics
from repro.obs import profile as jprofile
from repro.obs import trace as jtrace
from repro.serving import executors as jex
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro.serving import sharding as jshard
from repro.serving.telemetry import Telemetry as JTelemetry
from repro_torch.common import errors as terrors
from repro_torch.convert import params_from_jax
from repro_torch.core import accelerator_model as tam
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.obs import metrics as tmetrics
from repro_torch.obs import profile as tprofile
from repro_torch.obs import trace as ttrace
from repro_torch.serving import executors as tex
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import sharding as tshard
from repro_torch.serving import vision as tvision
from repro_torch.serving.telemetry import Telemetry

# (scheduler, errors, faults, sharding, tracer, telemetry) per package
JAX = (jsched, jerrors, jfaults, jshard, jtrace, JTelemetry)
PORT = (tsched, terrors, tfaults, tshard, ttrace, Telemetry)


# ---------------------------------------------------------------------------
# the scheduler's spans against JAX's, on fake caches
# ---------------------------------------------------------------------------

class _Dev:
    def __init__(self, did):
        self.id = did


class FakeExecutor:
    def __init__(self, cache, bucket):
        self.cache, self.bucket = cache, bucket
        self.degraded = None
        self.shard = cache.shard_for(bucket) if cache.health else None
        self.device_ids = self.shard.device_ids if self.shard else ()

    def __call__(self, params, x):
        if self.cache.faults is not None and self.shard is not None:
            self.cache.faults.fire("device.dropout", batch=self.bucket,
                                   devices=self.device_ids)
        if self.cache.call_faults:
            raise self.cache.call_faults.pop(0)
        return np.full((int(x.shape[0]), 4), float(self.bucket),
                       np.float32)


class FakeCache:
    """Quacks like an ExecutorCache: scripted failures, optional mesh of
    fake domains (a package's own ``DeviceHealth``, its tracer threaded),
    host-only executors."""
    precision = "auto"

    def __init__(self, pkg, tracer, *, buckets=(1, 2, 4), call_faults=(),
                 mesh=0, faults=None):
        sched, errs, fmod, shard, _, tel = pkg
        self.buckets = tuple(buckets)
        self.telemetry = tel()
        self.call_faults = list(call_faults)
        self.faults = faults
        self.health = None
        if mesh:
            self.health = shard.DeviceHealth(
                devices=tuple(_Dev(i) for i in range(mesh)))
            self.health.tracer = tracer
        self.degrades = []

    def shard_for(self, batch):
        return self.health.shard_for(batch)

    @property
    def mesh_exhausted(self):
        return self.health is not None and self.health.exhausted

    def get(self, batch, resolution):
        if self.health is not None:
            self.health.shard_for(batch)      # MeshExhausted when dead
        return FakeExecutor(self, batch)

    def on_device_lost(self, device_id):
        return self.health.mark_dead(device_id)

    def degrade(self, batch, resolution, *, site=None):
        self.degrades.append((batch, resolution, site))

    def pin_fp(self, batch, resolution):
        pass


def _drain(sched, clock, rounds=16):
    for _ in range(rounds):
        if not sched.outstanding():
            return
        sched.step(drain=True)
        sched.finalize()
        clock.advance(0.1)
    raise AssertionError("not drained")


def _scripted(pkg, scenario):
    """One scripted run through a package's scheduler; returns the
    chrome trace and the requests' outcomes."""
    smod, errs, fmod, _, tmod, _ = pkg
    clock = smod.ManualClock()
    tracer = tmod.Tracer(clock=clock)
    imgs = np.random.default_rng(0).standard_normal(
        (6, 32, 32, 3)).astype(np.float32)
    kw, cache_kw, faults = {}, {}, None
    if scenario == "retry":
        cache_kw["call_faults"] = [errs.ExecutorError("flaky launch")]
        kw["backoff_ms"] = 10.0
    elif scenario == "watchdog":
        kw.update(watchdog_ms=50.0, backoff_ms=0.0)
    elif scenario == "device_loss":
        faults = fmod.FaultPlan(fmod.FaultSpec("device.dropout", times=1,
                                               device=2), tracer=tracer)
        cache_kw.update(mesh=4, faults=faults)
        kw["backoff_ms"] = 0.0
    elif scenario == "mesh_loss":
        faults = fmod.FaultPlan(*[fmod.FaultSpec("device.dropout", times=1,
                                                 device=d) for d in range(2)],
                                tracer=tracer)
        cache_kw.update(mesh=2, faults=faults)
        kw["backoff_ms"] = 0.0
    cache = FakeCache(pkg, tracer, **cache_kw)
    sched = smod.MicroBatchScheduler(cache, None, clock=clock,
                                     tracer=tracer, **kw)
    reqs = [smod.Request(rid=i, image=imgs[i],
                         deadline_ms=5.0 if i % 2 else None)
            for i in range(5)]
    for r in reqs[:4]:
        sched.submit(r)
        clock.advance(0.001)
    sched.step()                       # one full bucket of 4
    clock.advance(0.01)
    sched.submit(reqs[4])
    if scenario == "watchdog":
        clock.advance(0.2)             # blow the 50 ms bound
        sched.step()                   # the sweep declares it hung
    clock.advance(0.02)
    sched.step()
    sched.finalize()
    _drain(sched, clock)
    if scenario == "mesh_loss":        # a late request fails fast
        late = smod.Request(rid=9, image=imgs[5])
        sched.submit(late)
        _drain(sched, clock)
        reqs.append(late)
    assert not tracer.open_spans(), [s.name for s in tracer.open_spans()]
    outcome = [(r.rid, r.status, r.retries, type(r.error).__name__)
               for r in reqs]
    return tracer.to_chrome(), outcome, dict(cache.telemetry.counters)


@pytest.mark.parametrize("scenario", ["plain", "retry", "watchdog",
                                      "device_loss", "mesh_loss"])
def test_scheduler_trace_matches_jax(scenario):
    j_doc, j_out, j_tel = _scripted(JAX, scenario)
    t_doc, t_out, t_tel = _scripted(PORT, scenario)
    assert t_out == j_out
    assert t_tel == j_tel
    assert json.dumps(t_doc, sort_keys=True) == \
        json.dumps(j_doc, sort_keys=True)
    n = ttrace.validate_chrome_trace(t_doc)
    assert n == jtrace.validate_chrome_trace(j_doc)
    chains = ttrace.request_chains(t_doc)
    events = {rid: c["events"] for rid, c in chains.items()}
    if scenario == "mesh_loss":
        assert all(o[1] == "failed" and o[3] == "MeshExhausted"
                   for o in t_out)
        return
    assert all(o[1] == "completed" for o in t_out)
    for c in chains.values():
        assert {"queue"} <= c["children"]
        assert {"dispatch", "device", "finalize"} <= c["member_of"]
    if scenario == "retry":
        assert "retry" in events[0]
    if scenario == "watchdog":
        assert "watchdog_fired" in events[0]
    if scenario == "device_loss":
        assert events[0] == ("failover", "retry")
        names = {e["name"] for e in t_doc["traceEvents"]}
        assert {"device.lost", "fault.injected"} <= names


# ---------------------------------------------------------------------------
# the executor cache's spans and marks against JAX's, on real caches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    return _fp_tree(jevit.B1_SMOKE, 0)


def _cache_trace(pkg, smoke):
    """Builds (a donor reuse, a compile fault, a negative-cache hit),
    ladder moves and a mesh of one domain lost, on a ManualClock."""
    smod, _, fmod, _, tmod, _ = pkg
    clock = smod.ManualClock()
    tracer = tmod.Tracer(clock=clock)
    faults = fmod.FaultPlan(fmod.FaultSpec("executor.compile", times=1,
                                           match={"batch": 4}),
                            tracer=tracer)
    if pkg is JAX:
        cache = jex.ExecutorCache(jax.tree.map(jnp.asarray, smoke),
                                  jevit.B1_SMOKE, buckets=(1, 2, 4),
                                  autotune=False, clock=clock, faults=faults,
                                  telemetry=JTelemetry(), tracer=tracer,
                                  devices=jax.devices()[:1])
    else:
        cache = tex.ExecutorCache(params_from_jax(smoke, "cpu"),
                                  tevit.B1_SMOKE, buckets=(1, 2, 4),
                                  autotune=False, clock=clock, faults=faults,
                                  telemetry=Telemetry(), tracer=tracer,
                                  device="cpu", devices=("cpu",))
    errors = []
    cache.get(1, 32)
    clock.advance(0.01)
    cache.get(2, 32)
    for _ in range(2):
        clock.advance(0.01)
        try:
            cache.get(4, 32)
        except Exception as e:
            errors.append(type(e).__name__)
    cache.degrade(1, 32, site="S2.mb0")
    cache.get(1, 32)
    cache.degrade(1, 32)
    cache.pin_fp(2, 32)
    clock.advance(0.01)
    cache.get(2, 32)
    clock.advance(2.0)                 # past the negative TTL
    cache.get(4, 32)
    cache.on_device_lost(0)
    try:
        cache.get(4, 32)
    except Exception as e:
        errors.append(type(e).__name__)
    return tracer.to_chrome(), errors, dict(cache.telemetry.counters)


def test_cache_trace_matches_jax(smoke):
    j_doc, j_err, j_tel = _cache_trace(JAX, smoke)
    t_doc, t_err, t_tel = _cache_trace(PORT, smoke)
    assert t_err == j_err == ["ExecutorError", "ExecutorError",
                              "MeshExhausted"]
    # the port's conv blocks depend on the batch (the grid fills the
    # card), so fewer sites inherit a donor's blocks than in JAX
    t_tel.pop("plan_sites_reused")
    j_tel.pop("plan_sites_reused")
    assert t_tel == j_tel
    assert json.dumps(t_doc, sort_keys=True) == \
        json.dumps(j_doc, sort_keys=True)
    names = [e["name"] for e in t_doc["traceEvents"] if e["ph"] == "X"]
    for name in ("executor.build", "lower", "plan", "ladder.degrade",
                 "ladder.pin_fp", "mesh.shrink", "device.lost",
                 "fault.injected"):
        assert name in names, name


def test_trace_module_never_imports_jax():
    """``repro_torch.obs.trace`` and ``repro_torch.obs`` load neither
    ``jax`` nor the JAX package (nor ``torch``: the tracer is standard
    library only)."""
    code = ("import sys; import repro_torch.obs.trace; import repro_torch.obs;"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro', 'torch')]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True)


def test_engine_traces_a_sharded_run(smoke, tmp_path):
    """``VisionEngine(tracer=)`` over four CPU domains: the tracer reaches
    the fault plan; every request's chain is complete, no span stays
    open, the exported file validates, and the metrics registry renders
    the per-device rows."""
    tracer = ttrace.Tracer()
    faults = tfaults.FaultPlan(tfaults.FaultSpec("device.dropout", times=1,
                                                 device=3))
    eng = tvision.VisionEngine(
        params_from_jax(smoke, "cpu"), tevit.B1_SMOKE,
        tvision.VisionServeConfig(microbatch=4, devices=("cpu",) * 4),
        device="cpu", faults=faults, tracer=tracer)
    assert faults.tracer is tracer and eng.cache.tracer is tracer
    imgs = np.random.default_rng(4).standard_normal(
        (6, 64, 64, 3)).astype(np.float32)
    reqs = [tsched.Request(i, imgs[i]) for i in range(6)]
    eng.serve(reqs)
    doc = eng.export_trace(str(tmp_path / "trace.json"))
    assert json.loads((tmp_path / "trace.json").read_text()) == doc
    assert ttrace.validate_chrome_trace(doc) > 0
    assert not tracer.open_spans()
    chains = ttrace.request_chains(doc)
    assert sorted(chains) == list(range(6))
    for c in chains.values():
        assert {"queue"} <= c["children"]
        assert {"dispatch", "device", "finalize"} <= c["member_of"]
    # domain 3 dropped at the first dispatch (bucket 4 over all four);
    # every batch then ran on the survivors, 2-wide
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [e["args"].get("error") for e in spans
            if e["name"] == "dispatch"][0] == "DeviceLostError"
    assert [e["args"]["devices"] for e in spans
            if e["name"] == "device"] == [[0, 1], [0, 1]]
    assert [e["name"] for e in spans if e["cat"] == "mesh"] == \
        ["device.lost"]
    text = eng.metrics().prometheus_text()
    assert 'repro_device_lost{device="3"} 1' in text
    assert "repro_mesh_shrunk_total 1" in text
    with pytest.raises(ValueError, match="tracer"):
        tvision.VisionEngine(params_from_jax(smoke, "cpu"), tevit.B1_SMOKE,
                             device="cpu").export_trace(
                                 str(tmp_path / "x.json"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def _fill(tel):
    tel.record_dispatch((4, 32, "auto"), 3, 4, queue_depth=2,
                        wait_ms=[1.0, 2.0, 3.5])
    tel.record_dispatch((1, 64, "int8", False), 1, 1, queue_depth=0,
                        wait_ms=[0.25])
    tel.record_latency((4, 32, "auto"), [10.0, 20.0, 30.5])
    tel.record_latency((1, 64, "int8", False), [7.0])
    tel.record_error((4, 32, "auto"))
    tel.record_device_dispatch((0, 1), 3, 4)
    tel.record_device_error(1, lost=True)
    tel.count("completed", 4)
    tel.count("mesh-shrunk")
    tel.observe("host_ms", 0.5)
    tel.observe("host_ms", 1.5)
    return tel


def _registry(mod, tel):
    reg = mod.MetricsRegistry(telemetry=tel, namespace="repro")
    reg.counter("trace_exports", "trace files").inc(2, route='vis"ion\n')
    reg.gauge("mesh_alive").set(3, mesh="a\\b")
    h = reg.histogram("build_s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    return reg


def test_prometheus_text_matches_jax():
    j = _registry(jmetrics, _fill(JTelemetry()))
    t = _registry(tmetrics, _fill(Telemetry()))
    assert t.prometheus_text() == j.prometheus_text()
    assert json.dumps(t.to_json(), sort_keys=True) == \
        json.dumps(j.to_json(), sort_keys=True)
    text = t.prometheus_text()
    assert 'quantile="0.99"' in text and 'device="1"' in text
    assert tmetrics.escape_label('a\\b"c\nd') == 'a\\\\b\\"c\\nd'
    import repro_torch.obs as tobs
    assert tobs.MetricsRegistry is tmetrics.MetricsRegistry


def test_registry_text_parses_back_to_counters():
    """The rendering's counter samples parse back to the telemetry's
    counter values (the gate chip_smoke.py's [metrics] phase runs)."""
    tel = _fill(Telemetry())
    text = tmetrics.MetricsRegistry(telemetry=tel).prometheus_text()
    got = {}
    for line in text.splitlines():
        if line.startswith("#") or "{" in line:
            continue
        name, value = line.rsplit(" ", 1)
        if name.endswith("_total"):
            got[name[len("repro_"):-len("_total")]] = float(value)
    assert got == {tmetrics._sanitize(k): float(v)
                   for k, v in tel.counters.items()}


# ---------------------------------------------------------------------------
# the cycle model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def b1():
    return _trees(jevit.B1, 1)


@pytest.fixture(scope="module")
def smoke_trees(smoke):
    return smoke, jax.tree.map(np.asarray, jax.jit(jq.quantize_efficientvit)(
        jax.tree.map(jnp.asarray, smoke)))


def _rows(rows):
    """site_breakdown rows without the tile choices (``blocks``: the
    port's are the Hopper kernels', JAX's the Pallas kernels')."""
    return [{k: v for k, v in r.items() if k != "blocks"} for r in rows]


@pytest.mark.parametrize("cfg", ["B1", "B1_SMOKE"])
@pytest.mark.parametrize("plan", [None, "fp", "int8"])
def test_cycle_model_matches_jax(b1, smoke_trees, cfg, plan):
    jcfg, tcfg = (jevit.B1, tevit.B1) if cfg == "B1" else \
        (jevit.B1_SMOKE, tevit.B1_SMOKE)
    jprogram, tprogram = jprog.lower(jcfg, batch=2), tprog.lower(tcfg,
                                                                 batch=2)
    jplan = tplan = None
    if plan is not None:
        trees = b1 if cfg == "B1" else smoke_trees
        tree = trees[0] if plan == "fp" else trees[1]
        jplan = jfusion.plan_program(jprogram, jax.tree.map(jnp.asarray,
                                                            tree),
                                     autotune=False)
        tplan = tfusion.plan_program(tprogram, params_from_jax(tree, "cpu"),
                                     autotune=False)
        assert {n: (d.fused, d.precision, d.reason, d.group)
                for n, d in tplan.decisions.items()} == \
            {n: (d.fused, d.precision, d.reason, d.group)
             for n, d in jplan.decisions.items()}
        jprogram = jprogram.with_epilogues(jplan)
        tprogram = tprogram.with_epilogues(tplan)
        assert [s.epilogue for s in tprogram.sites] == \
            [tprog.Epilogue(**dataclasses.asdict(s.epilogue))
             for s in jprogram.sites]
    for head in (False, True):
        jr, js, jsched_ = jam.analyze_program(jprogram, include_head=head)
        tr, ts, tsched_ = tam.analyze_program(tprogram, include_head=head)
        assert tr.to_dict() == jr.to_dict()
        assert ts == js
        assert [dataclasses.asdict(s) for s in tsched_] == \
            [dataclasses.asdict(s) for s in jsched_]
        for prec in ("fp", "int8"):
            assert _rows(tam.site_breakdown(
                tprogram, plan=tplan, include_head=head,
                default_precision=prec)) == _rows(jam.site_breakdown(
                    jprogram, plan=jplan, include_head=head,
                    default_precision=prec))
    if cfg == "B1" and plan is None:
        assert tam.analyze(tevit.B1)[0].to_dict() == \
            jam.analyze(jevit.B1)[0].to_dict()
        assert tam.HwConfig() == tam.HwConfig(**dataclasses.asdict(
            jam.HwConfig()))


# ---------------------------------------------------------------------------
# the profiler
# ---------------------------------------------------------------------------

def _scripted_profile(pmod, program):
    ticks = iter(x * 1e-3 for x in range(10_000))
    prof = pmod.SiteProfiler(clock=lambda: next(ticks), sync=lambda out: out)
    for rep in range(2):
        for i, site in enumerate(program.sites):
            prof.begin(site)
            for _ in range(i % 3 + rep):    # windows of 1-4 ticks
                next(ticks)
            prof.end(site, out=None)
    return prof


@pytest.mark.parametrize("plan", [None, "fp"])
def test_drift_report_matches_jax(smoke, plan):
    jprogram = jprog.lower(jevit.B1_SMOKE, batch=1, image_size=32)
    tprogram = tprog.lower(tevit.B1_SMOKE, batch=1, image_size=32)
    jplan = tplan = None
    if plan is not None:
        jplan = jfusion.plan_program(jprogram, jax.tree.map(jnp.asarray,
                                                            smoke),
                                     autotune=False)
        tplan = tfusion.plan_program(tprogram, params_from_jax(smoke, "cpu"),
                                     autotune=False)
    j = jprofile.drift_report(jprogram, _scripted_profile(jprofile, jprogram),
                              plan=jplan)
    t = tprofile.drift_report(tprogram, _scripted_profile(tprofile, tprogram),
                              plan=tplan)
    assert t.to_dict() == j.to_dict()
    assert t.table() == j.table()
    assert t.finite() and t.repeats == 2
    with pytest.raises(KeyError):
        tprofile.drift_report(tprogram, tprofile.SiteProfiler(), plan=None)


def test_profiled_execute_records_every_site_groups_off(monkeypatch):
    """``profile_execute`` on a grouped plan (three super-sites) records
    each site once per repeat on the host clock; no chain kernel runs,
    and the profiled forward equals the per-site plan's."""
    from repro_torch.kernels import registry
    fp, _ = _trees(JCFG, 0)
    params = params_from_jax(fp, "cpu")
    program = tprog.lower(TCFG, batch=2)
    plan = tfusion.plan_program(program, params, autotune=False)
    assert {g.name: tuple(g.members) for g in plan.groups.values()} == GROUPS
    kinds = []
    real = registry.get_kernel

    def spy(kind, precision):
        kinds.append(kind)
        return real(kind, precision)
    monkeypatch.setattr(registry, "get_kernel", spy)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    prof = tprofile.profile_execute(program, params, x, plan=plan,
                                    repeats=2, warmup=1)
    assert not prof.events
    assert set(prof.records) == {s.name for s in program.sites}
    assert all(len(v) == 2 for v in prof.records.values())
    assert prof.repeats == 2
    assert kinds.count("supersite") == 3     # the unprofiled warm-up only
    per_site = tfusion.plan_program(program, params, autotune=False,
                                    supersites=False)
    with torch.inference_mode():
        want = tprog.execute(program, params, x, plan=per_site)
        got = tprog.execute(program, params, x, plan=plan,
                            profile=tprofile.SiteProfiler())
    assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    rep = tprofile.drift_report(program, prof, plan=plan)
    assert rep.finite() and len(rep.rows) == len(program.sites)
