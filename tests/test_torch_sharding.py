"""The port's sharded serving (``repro_torch.serving.sharding``, the
executor cache's ``devices=`` and the scheduler's ``DeviceLostError`` /
``MeshExhausted`` branches) against the JAX package, on the CPU.

The mesh is four fault domains on the CPU (``devices=("cpu",) * 4``),
the counterpart of XLA's fake host devices: a domain is a position in
the configured list.

- ``shard_width`` and ``DeviceHealth`` against JAX's over the same
  cases.
- The sharded forward on B1_SMOKE against the port's single-device
  forward (FIX8 bit-equal, fp32 within 1e-5) and against JAX's
  ``execute`` on the same numpy weights, run op by op
  (``jax.disable_jit``, ROADMAP R5), fp32 within 1e-5.
- The ``device_dropout`` and ``mesh_loss`` scenarios through the port's
  scheduler, with the outcomes JAX's ``tests/test_sharded_serving.py``
  asserts; the failover and exhaustion branches on fake executors; the
  per-device telemetry rows.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_torch_fix8 import _fp_tree
from test_torch_supersite import TCFG, _trees

from repro.common import errors as jerrors
from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro.serving import sharding as jshard
from repro.serving.telemetry import Telemetry as JTelemetry
from repro_torch.common.errors import (
    DeviceLostError, ExecutorError, KernelLaunchError, MeshExhausted)
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core.quantization import quantize_efficientvit
from repro_torch.serving import executors as tex
from repro_torch.serving import sharding as tshard
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.scheduler import (
    ManualClock, MicroBatchScheduler, Request)
from repro_torch.serving.telemetry import Telemetry

MESH = ("cpu",) * 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    """B1_SMOKE as numpy (JAX's init, BN statistics perturbed)."""
    return _fp_tree(jevit.B1_SMOKE, 0)


@pytest.fixture(scope="module")
def tsmoke(smoke):
    return params_from_jax(smoke, "cpu")


def _images(n, res=32, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, res, res, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# shard_width and DeviceHealth against JAX's
# ---------------------------------------------------------------------------

class _Dev:
    def __init__(self, did):
        self.id = did


def _health_case(mod, errs, case):
    """One scripted use of a package's ``DeviceHealth`` (its own error
    classes in ``errs``); returns what it observed, as plain values."""
    h = mod.DeviceHealth(devices=tuple(_Dev(i) for i in range(4)))
    spec = lambda s: (s.device_ids, s.local_batch)     # noqa: E731
    if case == "shard_width":
        out = [mod.shard_width(b, n) for b in (1, 2, 3, 4, 6, 8)
               for n in (1, 2, 3, 4)]
        for bad in ((0, 4), (4, 0), (-1, 2)):
            try:
                mod.shard_width(*bad)
                out.append("no error")
            except ValueError:
                out.append("ValueError")
        return out
    if case == "shrink":
        out = [spec(h.shard_for(b)) for b in (1, 2, 4, 8)]
        h.mark_dead(1)
        out += [spec(h.shard_for(b)) for b in (1, 2, 4, 8)]
        h.mark_dead(3)
        return out + [spec(h.shard_for(b)) for b in (1, 2, 4, 8)]
    if case == "epoch":
        out = [h.mark_dead(2), h.mark_dead(2), h.mark_dead(77),
               h.epoch, h.dead_ids(), h.n_alive, h.exhausted]
        out += [h.mark_dead(0), h.epoch, h.dead_ids(),
                tuple(d.id for d in h.alive())]
        return out
    if case == "exhaust":
        out = []
        for d in (3, 0, 2, 1):
            out.append((h.mark_dead(d), h.n_alive, h.exhausted, h.epoch))
        return out
    if case == "attribute":
        shard = h.shard_for(4)
        return [h.attribute(errs.DeviceLostError("gone", device=2), shard),
                h.attribute(errs.KernelLaunchError("boom"), shard),
                h.attribute(errs.KernelLaunchError("boom"), None),
                h.attribute(errs.DeviceLostError("gone"), h.shard_for(1))]
    if case == "shard_for_exhausted":
        for d in range(4):
            h.mark_dead(d)
        try:
            h.shard_for(4)
            return "no error"
        except errs.MeshExhausted as e:
            return (type(e).__name__, str(e), e.transient)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["shard_width", "shrink", "epoch",
                                  "exhaust", "attribute",
                                  "shard_for_exhausted"])
def test_health_matches_jax(case):
    import repro_torch.common.errors as terrors
    got = _health_case(tshard, terrors, case)
    assert got == _health_case(jshard, jerrors, case)
    if case == "shrink":      # 4 -> 3 -> 2 alive: batch 8 runs 2-wide
        assert got[7] == ((0, 2), 4) and got[11] == ((0, 2), 4)


def test_health_of_names_domains_by_position():
    h = tshard.DeviceHealth.of(MESH)
    assert [d.id for d in h.devices] == [0, 1, 2, 3]
    assert all(d.device == torch.device("cpu") for d in h.devices)
    assert h.shard_for(4).rows(2) == (2, 3)
    with pytest.raises(ValueError):
        tshard.DeviceHealth.of(())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tshard.DeviceHealth.of(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            tshard.DeviceHealth.of(("cuda:0",) * 4)


def test_error_taxonomy_matches_jax():
    import repro_torch.common.errors as terrors
    for name in ("DeviceLostError", "MeshExhausted"):
        t, j = getattr(terrors, name), getattr(jerrors, name)
        assert [c.__name__ for c in t.__mro__ if c is not object] == \
            [c.__name__ for c in j.__mro__ if c is not object]
        assert t("x").transient == j("x").transient
    assert DeviceLostError("x", device=3).device == \
        jerrors.DeviceLostError("x", device=3).device == 3
    assert issubclass(DeviceLostError, KernelLaunchError)
    assert issubclass(MeshExhausted, ExecutorError)


# ---------------------------------------------------------------------------
# the sharded forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_sharded_matches_single_device(tsmoke, precision):
    """One cache entry over four CPU domains (local batch 1) against the
    single-device executor: FIX8 bit for bit (per-image activation
    scales), fp32 within 1e-5."""
    tree = tsmoke if precision == "fp" else quantize_efficientvit(tsmoke)
    prec = "auto" if precision == "fp" else "int8"
    x = torch.from_numpy(_images(4))
    single = tex.ExecutorCache(tree, tevit.B1_SMOKE, buckets=(4,),
                               precision=prec, device="cpu")
    sharded = tex.ExecutorCache(tree, tevit.B1_SMOKE, buckets=(4,),
                                precision=prec, device="cpu", devices=MESH)
    ref = single.get(4, 32)(single.params, x)
    ex = sharded.get(4, 32)
    got = ex(sharded.params, x)
    assert ex.shard.local_batch == 1 and ex.device_ids == (0, 1, 2, 3)
    assert ex.program.batch == 1 and ex.fused_sites == \
        single.get(4, 32).fused_sites
    if precision == "int8":
        assert torch.equal(got, ref)
    else:
        assert_allclose(got.numpy(), ref.numpy(), **TOL)
    # a partial batch: the missing rows are zeros on their members
    part = ex(sharded.params, x[:3])
    assert torch.equal(part[:3], got[:3]) if precision == "int8" else \
        np.allclose(part[:3].numpy(), got[:3].numpy(), **TOL)


def test_sharded_fp32_matches_jax_execute(smoke, tsmoke):
    """The port's sharded fp32 forward against JAX's ``execute`` (its
    plan at the bucket, op by op) on the same weights, within 1e-5."""
    x = _images(4, seed=3)
    jparams = jax.tree.map(jnp.asarray, smoke)
    program = jprog.lower(jevit.B1_SMOKE, batch=4, image_size=32)
    plan = jfusion.plan_program(program, jparams, autotune=False)
    with jax.disable_jit():
        want = np.asarray(jprog.execute(program, jparams, jnp.asarray(x),
                                        plan=plan))
    cache = tex.ExecutorCache(tsmoke, tevit.B1_SMOKE, buckets=(4,),
                              device="cpu", devices=MESH)
    got = cache.get(4, 32)(cache.params, torch.from_numpy(x))
    assert_allclose(got.numpy(), want, **TOL)


def test_sharded_forward_splits_rows_in_order(tsmoke):
    """``sharded_forward`` on its own: member i runs rows [i*lb, (i+1)*lb)
    at the local batch, the outputs gathered in row order; one replica
    per physical device (the CPU domains share the tree)."""
    from types import SimpleNamespace
    from repro_torch.core.fusion import plan_program
    from repro_torch.core.program import execute, lower
    health = tshard.DeviceHealth.of(("cpu",) * 2)
    shard = health.shard_for(4)
    program = lower(tevit.B1_SMOKE, batch=2, image_size=32)
    plan = plan_program(program, tsmoke)
    replicas = tshard.replicate(tsmoke, shard.devices)
    assert list(replicas.values()) == [tsmoke]
    members = [SimpleNamespace(device=d.device, lo=lo, hi=hi,
                               params=replicas[d.device])
               for d, (lo, hi) in zip(shard.devices,
                                      map(shard.rows, range(2)))]
    x = torch.from_numpy(_images(4, seed=5))
    with torch.inference_mode():
        got = tshard.sharded_forward(program, members, x, plan=plan)
        halves = [execute(program, tsmoke, x[i:i + 2], plan=plan)
                  for i in (0, 2)]
    assert torch.equal(got, torch.cat(halves))
    with pytest.raises(ValueError, match="whole bucket"):
        tshard.sharded_forward(program, members, x[:3], plan=plan)


def test_weight_packs_once_per_physical_device():
    """A grouped plan over four CPU domains builds each chain's pack
    once: the domains of one device share one param tree."""
    fp, _ = _trees(jevit.EfficientViTConfig(
        name="ss-smoke", widths=(8, 16, 24, 32, 48), depths=(2, 2, 3, 1, 1),
        head_widths=(64, 64), num_classes=10, image_size=64), 0)
    cache = tex.ExecutorCache(params_from_jax(fp, "cpu"), TCFG,
                              buckets=(4, 8), device="cpu", devices=MESH)
    a, b = cache.get(4, 64), cache.get(8, 64)
    assert len(a.plan.groups) == 3 and b.shard.local_batch == 2
    c = cache.telemetry.counters
    assert c["weight_pack_built"] == 3 and c["weight_pack_hit"] == 3
    x = torch.from_numpy(_images(8, 64, seed=2))
    single = tex.ExecutorCache(cache.params, TCFG, buckets=(8,),
                               device="cpu")
    assert_allclose(b(cache.params, x).numpy(),
                    single.get(8, 64)(single.params, x).numpy(), **TOL)


# ---------------------------------------------------------------------------
# the scheduler over the sharded cache: device_dropout, mesh_loss
# ---------------------------------------------------------------------------

def _runtime(tree, faults=None, buckets=(1, 2, 4), **kw):
    tel = Telemetry()
    clock = ManualClock()
    cache = tex.ExecutorCache(tree, tevit.B1_SMOKE, buckets=buckets,
                              telemetry=tel, faults=faults, clock=clock,
                              device="cpu", devices=MESH)
    sched = MicroBatchScheduler(cache, cache.params, telemetry=tel,
                                clock=clock, faults=faults, **kw)
    return tel, cache, sched, clock


def _drain(sched, clock, rounds=64):
    for _ in range(rounds):
        if not sched.outstanding():
            return
        sched.step(drain=True)
        sched.finalize()
        clock.advance(0.05)
    raise AssertionError("scheduler failed to drain")


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_dropout_failover_completes_trace(tsmoke, precision):
    """JAX's ``test_dropout_failover_completes_trace``: domain 2 dies at
    dispatch; the mesh shrinks 4 -> 3 (the bucket of 4 runs 2-wide at
    local batch 2), the requests retry and complete on the survivors,
    the ladder never moves, and the failed-over logits match the healthy
    sharded executor (FIX8 bit for bit)."""
    tree = tsmoke if precision == "fp" else quantize_efficientvit(tsmoke)
    faults = FaultPlan(FaultSpec("device.dropout", times=1, device=2))
    tel, cache, sched, clock = _runtime(tree, faults=faults,
                                        backoff_ms=0.0)
    imgs = _images(4)
    reqs = [Request(rid=i, image=imgs[i]) for i in range(4)]
    for rq in reqs:
        sched.submit(rq)
    _drain(sched, clock)
    healthy = tex.ExecutorCache(tree, tevit.B1_SMOKE, buckets=(4,),
                                device="cpu", devices=MESH,
                                precision=cache.precision)
    ref = healthy.get(4, 32)(healthy.params, torch.from_numpy(imgs))
    got = np.stack([rq.logits for rq in reqs])
    assert sorted({rq.status for rq in reqs}) == ["completed"]
    assert cache.health.dead_ids() == (2,) and cache.health.epoch == 1
    assert cache.degradation(4, 32) is None, \
        "device loss must not move the ladder"
    if precision == "int8":
        assert np.array_equal(got, ref.numpy())
    else:
        assert np.max(np.abs(got - ref.numpy())) < 1e-5
    assert tel.counters["device_lost"] == 1
    assert tel.counters["mesh_shrunk"] == 1
    assert tel.counters["device_failover"] == 4
    assert [rq.retries for rq in reqs] == [1, 1, 1, 1]
    ex = cache.get(4, 32)
    assert ex.device_ids == (0, 1) and ex.shard.local_batch == 2
    assert faults.fired == {"device.dropout": 1}
    for k in ("degraded", "pinned_fp", "failed"):
        assert k not in tel.counters


def test_total_mesh_loss_fails_clean(tsmoke):
    """JAX's ``test_total_mesh_loss_fails_clean``: every domain dies; the
    requests end failed with ``MeshExhausted`` (no retry burn-down, no
    hang), and a late submit fails fast the same way."""
    faults = FaultPlan(*[FaultSpec("device.dropout", times=1, device=d)
                         for d in range(4)])
    tel, cache, sched, clock = _runtime(tsmoke, faults=faults,
                                        backoff_ms=0.0)
    reqs = [Request(rid=i, image=img) for i, img in enumerate(_images(4))]
    for rq in reqs:
        sched.submit(rq)
    _drain(sched, clock)
    late = Request(rid=99, image=_images(1, seed=3)[0])
    sched.submit(late)
    _drain(sched, clock)
    assert sorted({rq.status for rq in reqs}) == ["failed"]
    assert all(type(rq.error).__name__ == "MeshExhausted"
               for rq in reqs + [late])
    assert cache.mesh_exhausted and late.status == "failed"
    assert late.retries <= 1, "exhausted mesh must not burn retries"
    assert sched.outstanding() == 0
    assert cache.degradation(4, 32) is None
    # the exhausted cache raises the typed error itself, never cached
    for _ in range(2):
        with pytest.raises(MeshExhausted):
            cache.get(4, 32)
    assert tel.counters["device_lost"] == 4
    assert tel.counters["mesh_shrunk"] == 3
    assert "negative_cache_hit" not in tel.counters


def test_device_loss_evicts_only_shards_that_held_it(tsmoke):
    """``on_device_lost`` evicts every executor whose shard held the
    domain (bucket 1 runs on domain 0 alone and survives domain 3's
    loss), clears the negative cache and keeps the donor plans."""
    clock = ManualClock()
    faults = FaultPlan(FaultSpec("executor.compile", times=1,
                                 match={"batch": 2}))
    cache = tex.ExecutorCache(tsmoke, tevit.B1_SMOKE, buckets=(1, 2, 4),
                              device="cpu", devices=MESH, clock=clock,
                              faults=faults)
    one, four = cache.get(1, 32), cache.get(4, 32)
    with pytest.raises(ExecutorError):
        cache.get(2, 32)
    assert cache._neg
    assert one.device_ids == (0,) and four.device_ids == (0, 1, 2, 3)
    assert cache.on_device_lost(3) and not cache.on_device_lost(3)
    assert not cache.on_device_lost(None)
    assert cache.keys() == (tex.ExecutorKey(1, 32, "auto"),)
    assert not cache._neg and cache._donor_plans
    assert cache.get(2, 32).device_ids == (0, 1)
    assert cache.get(4, 32).device_ids == (0, 1)
    assert cache.telemetry.devices[3].lost


# ---------------------------------------------------------------------------
# the scheduler's branches on fake executors (JAX's tests, ported)
# ---------------------------------------------------------------------------

class EchoExecutor:
    shard = None
    device_ids = ()
    degraded = None

    def __init__(self, cache, bucket):
        self.cache, self.bucket = cache, bucket

    def __call__(self, params, x):
        if self.cache.call_faults:
            raise self.cache.call_faults.pop(0)
        x = np.asarray(x)
        return np.mean(x.reshape(x.shape[0], -1), axis=1,
                       keepdims=True).astype(np.float32)


class EchoCache:
    precision = "auto"

    def __init__(self, *, buckets=(1, 2, 4), call_faults=()):
        self.buckets = tuple(buckets)
        self.telemetry = Telemetry()
        self.call_faults = list(call_faults)
        self.degrades, self.pins = [], []

    def get(self, batch, resolution):
        return EchoExecutor(self, batch)

    def degrade(self, batch, resolution, *, site=None):
        self.degrades.append((batch, resolution, site))

    def pin_fp(self, batch, resolution):
        self.pins.append((batch, resolution))


def _reqs(n, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, image=rng.standard_normal(
        (8, 8, 3)).astype(np.float32)) for i in range(n)]


def test_device_lost_routes_to_failover_not_ladder():
    """A DeviceLostError from a fake executor calls the cache's
    on_device_lost hook and leaves degrade()/pin_fp() untouched."""
    class MeshCache(EchoCache):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.lost = []
            self.mesh_exhausted = False

        def on_device_lost(self, device_id):
            self.lost.append(device_id)
            return True

    cache = MeshCache(call_faults=[DeviceLostError("dev gone", device=3)])
    clock = ManualClock()
    sched = MicroBatchScheduler(cache, None, clock=clock, backoff_ms=0.0)
    reqs = _reqs(4)
    for r in reqs:
        sched.submit(r)
    sched.step(drain=True)               # dropout fires at dispatch
    assert cache.lost == [3]
    assert cache.degrades == [] and cache.pins == []
    sched.step(drain=True)
    sched.finalize()
    assert all(r.status == "completed" for r in reqs)
    assert cache.telemetry.counters["device_failover"] == 4


def test_device_lost_without_a_domain_blames_the_shard_lead():
    """A DeviceLostError naming no domain blames the dispatching shard's
    first domain (``DeviceHealth.attribute``)."""
    health = tshard.DeviceHealth.of(MESH)
    shard = health.shard_for(4)

    class Sharded(EchoExecutor):
        pass
    Sharded.shard = shard
    Sharded.device_ids = shard.device_ids

    class MeshCache(EchoCache):
        mesh_exhausted = False

        def __init__(self, **kw):
            super().__init__(**kw)
            self.health, self.lost = health, []

        def get(self, batch, resolution):
            return Sharded(self, batch)

        def on_device_lost(self, device_id):
            self.lost.append(device_id)
            return True

    cache = MeshCache(call_faults=[DeviceLostError("dev gone")])
    sched = MicroBatchScheduler(cache, None, clock=ManualClock(),
                                backoff_ms=0.0)
    for r in _reqs(4):
        sched.submit(r)
    sched.step(drain=True)
    assert cache.lost == [0]


def test_mesh_exhausted_fails_without_retry_burn():
    cache = EchoCache()
    cache.mesh_exhausted = True

    def get(batch, resolution):
        raise MeshExhausted("all dead")
    cache.get = get
    sched = MicroBatchScheduler(cache, None, clock=ManualClock(),
                                backoff_ms=0.0)
    reqs = _reqs(4)
    for r in reqs:
        sched.submit(r)
    sched.step(drain=True)
    assert all(r.status == "failed" for r in reqs)
    assert all(isinstance(r.error, MeshExhausted) for r in reqs)
    assert all(r.retries <= 1 for r in reqs)
    assert sched.outstanding() == 0
    assert "retries" not in cache.telemetry.counters


# ---------------------------------------------------------------------------
# per-device telemetry rows
# ---------------------------------------------------------------------------

def test_device_telemetry_row_attribution():
    """The same calls into the port's and JAX's ``Telemetry``: the same
    per-device rows (bucket 4 over 2 domains, 3 real rows: domain 0 holds
    rows 0-1, domain 1 rows 2-3, one of them padding)."""
    snaps = []
    for tel in (Telemetry(), JTelemetry()):
        tel.record_device_dispatch((0, 1), n_real=3, bucket_size=4)
        tel.record_device_dispatch((0, 2, 3), n_real=2, bucket_size=6)
        tel.record_device_error(1, lost=True)
        snaps.append((tel.snapshot()["devices"], tel.table()))
    assert snaps[0] == snaps[1]
    devs, table = snaps[0]
    assert devs[0]["samples"] == 4 and devs[1]["samples"] == 1
    assert devs[1]["padded"] == 1 and devs[1]["lost"]
    assert devs[3]["padded"] == 2
    assert "LOST" in table


def test_sharded_dispatch_records_device_rows(tsmoke):
    """The scheduler records each sharded dispatch's rows per domain: 3
    requests in bucket 4 over four domains, then 1 in bucket 1 (domain 0
    alone)."""
    tel, cache, sched, clock = _runtime(tsmoke, backoff_ms=0.0)
    imgs = _images(4, seed=7)
    for i in range(3):
        sched.submit(Request(rid=i, image=imgs[i]))
    sched.step(drain=True)
    sched.finalize()
    sched.submit(Request(rid=3, image=imgs[3]))
    sched.step(drain=True)
    sched.finalize()
    rows = {d: (v.dispatches, v.samples, v.padded)
            for d, v in tel.devices.items()}
    assert rows == {0: (2, 2, 0), 1: (1, 1, 0), 2: (1, 1, 0),
                    3: (1, 0, 1)}
