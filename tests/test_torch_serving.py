"""The port's serving stack (``repro_torch.serving``) against the JAX
package, on the CPU with ``device="cpu"``; the port's isolation from
JAX; and its refusal to fall back to the CPU on its own.

Logits are held to rtol = atol = 1e-5 (fp32 on both sides); bucket
choices and a ``ManualClock`` scheduler trace must be identical.
"""
import os
import pkgutil
import re
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

import repro_torch
from repro.core import efficientvit as jevit
from repro.serving import executors as jex
from repro.serving import scheduler as jsched
from repro.serving import vision as jvision
from repro_torch.common.device import to_device
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.kernels.dsconv.kernel import dsconv_fused
from repro_torch.serving import executors as tex
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import vision as tvision

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def smoke():
    init = jax.jit(jevit.init_efficientvit, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0),
                                         jevit.B1_SMOKE))
    rng = np.random.default_rng(0)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                n = node["scale"].shape[0]
                return {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                        "bias": (0.1 * rng.standard_normal(n)).astype(
                            np.float32),
                        "mean": (0.1 * rng.standard_normal(n)).astype(
                            np.float32),
                        "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [perturb(v) for v in node]
        return node

    return perturb(tree)


def _images(n, res, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (n, res, res, 3)).astype(np.float32)


def test_vision_engine_logits_match_jax(smoke):
    """Five images at microbatch 4: the tail goes to bucket 1 in both."""
    imgs = _images(5, 64)
    j = jvision.VisionEngine(smoke, jevit.B1_SMOKE, jvision.VisionServeConfig(
        microbatch=4, autotune=False))
    t = tvision.VisionEngine(params_from_jax(smoke, "cpu"), tevit.B1_SMOKE,
                             tvision.VisionServeConfig(microbatch=4),
                             device="cpu")
    got = t.logits(imgs)
    assert got.device.type == "cpu" and got.shape == (5, 10)
    assert_allclose(got.numpy(), np.asarray(j.logits(imgs)), **TOL)
    assert sorted((k.batch, k.resolution) for k in t.cache.keys()) == \
        sorted((k.batch, k.resolution) for k in j.cache.keys())
    assert t.telemetry.total("padded") == j.telemetry.total("padded") == 0
    assert np.array_equal(t.classify(imgs), got.numpy().argmax(-1))
    assert t.plan.n_fused() == len(t.program.fusible())


@pytest.mark.parametrize("buckets", [(1, 2, 4, 8), (1, 4), (3, 5), (8,)])
def test_chunks_for_matches_jax(smoke, buckets):
    t = tex.ExecutorCache({}, tevit.B1_SMOKE, buckets=buckets, device="cpu")
    j = jex.ExecutorCache(smoke, jevit.B1_SMOKE, buckets=buckets,
                          autotune=False)
    for n in range(1, 21):
        assert t.chunks_for(n) == j.chunks_for(n), n
        assert t.bucket_for(n) == j.bucket_for(n), n


def _trace(mod, cache, params, clock):
    """One fixed request trace on a ManualClock; returns what the
    scheduler did at each step."""
    sched = mod.MicroBatchScheduler(cache, params, clock=clock)
    img32, img64 = _images(7, 32), _images(1, 64, seed=2)
    reqs = [mod.Request(0, img32[0], deadline_ms=10.0),
            mod.Request(1, img32[1], timeout_ms=2.0)]
    reqs += [mod.Request(i, img32[i]) for i in range(2, 7)]
    reqs.append(mod.Request(7, img64[0], deadline_ms=0.0))
    log = []
    sched.submit(reqs[0])
    log.append(sched.step())                 # not due, not full
    clock.advance_to(0.001)
    sched.submit(reqs[1])
    log.append(sched.step())
    clock.advance_to(0.005)
    log.append(sched.step())                 # r1's hard timeout: shed
    clock.advance_to(0.011)
    log.append(sched.step())                 # r0's deadline: bucket 1
    for r in reqs[2:7]:
        sched.submit(r)
    log.append(sched.step())                 # one full bucket of 4
    sched.submit(reqs[7])
    log.append(sched.step())                 # 64 px, due at once
    log.append(sched.step(drain=True))       # the 32 px tail
    log.append(sched.finalize())
    tel = sched.telemetry
    buckets = {k: (b.dispatches, b.samples, b.padded)
               for k, b in tel.buckets.items()}
    return (log, [r.status for r in reqs], buckets, tel.total("dispatches"),
            tel.counters.get("shed", 0)), reqs


def test_manual_clock_scheduler_trace_matches_jax(smoke):
    j, jreqs = _trace(jsched, jex.ExecutorCache(
        smoke, jevit.B1_SMOKE, buckets=(1, 2, 4), autotune=False),
        smoke, jsched.ManualClock())
    tcache = tex.ExecutorCache(params_from_jax(smoke, "cpu"), tevit.B1_SMOKE,
                               buckets=(1, 2, 4), device="cpu")
    t, treqs = _trace(tsched, tcache, tcache.params, tsched.ManualClock())
    assert t == j
    assert t[0] == [0, 0, 0, 1, 4, 1, 1, 7]
    for a, b in zip(treqs, jreqs):
        if a.status == "completed":
            assert_allclose(a.logits, np.asarray(b.logits), **TOL)
    assert isinstance(treqs[1].error, tsched.DeadlineExceeded)


def test_serve_and_fixed_policy(smoke):
    eng = tvision.VisionEngine(params_from_jax(smoke, "cpu"), tevit.B1_SMOKE,
                               tvision.VisionServeConfig(microbatch=2,
                                                         policy="fixed"),
                               device="cpu")
    imgs = _images(3, 32)
    out = eng.serve([tsched.Request(i, imgs[i]) for i in range(3)])
    assert_allclose(out, eng.logits(imgs).numpy(), **TOL)
    assert {(k.batch, k.resolution) for k in eng.cache.keys()} == {(2, 32),
                                                                   (2, 64)}
    assert eng.telemetry.total("padded") == 2     # one tail per call


def test_executor_cache_lru_donor_and_warmup(smoke):
    cache = tex.ExecutorCache(params_from_jax(smoke, "cpu"), tevit.B1_SMOKE,
                              buckets=(1, 2, 4), capacity=2, device="cpu")
    cache.warmup([32])
    assert [(k.batch, k.resolution) for k in cache.keys()] == [(2, 32),
                                                                (4, 32)]
    assert cache.telemetry.counters["executor_evicted"] == 1
    assert cache.telemetry.counters["plans_built"] == 3
    # msa blocks do not follow the batch, so they come from the donor
    assert cache.telemetry.counters["plan_sites_reused"] > 0
    assert all(cache.get(b, 32).warmed for b in (2, 4))
    before = dsconv_fused.launches
    cache.get(1, 64)(cache.params, torch.zeros((1, 64, 64, 3)))
    assert dsconv_fused.launches == before   # plain versions on the CPU


# ---------------------------------------------------------------------------
# isolation and device policy
# ---------------------------------------------------------------------------

def test_to_device_keeps_cpu_inputs_on_the_cpu():
    x = to_device(np.ones((2, 3)), torch.device("cpu"))
    assert x.dtype == torch.float32 and x.device.type == "cpu"


def _port_modules():
    return [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]


def test_port_imports_neither_jax_nor_repro():
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro' "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT)


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path


def test_no_silent_cpu_without_a_card(smoke, monkeypatch):
    """Without a card, entry points that were not asked for the CPU
    raise instead of carrying on there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    params = params_from_jax(smoke, "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvision.VisionEngine(params, tevit.B1_SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tex.ExecutorCache(params, tevit.B1_SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tevit.init_efficientvit(torch.Generator().manual_seed(0),
                                tevit.B1_SMOKE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax(smoke)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    """The chip script exits non-zero, with no result line, where there
    is no card, and alone in a directory without the port."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    for cwd, script in ((tmp_path, tmp_path / "chip_smoke.py"),
                        (ROOT, os.path.join(ROOT, "chip_smoke.py"))):
        if cwd == ROOT and torch.cuda.is_available():
            continue
        r = subprocess.run([sys.executable, str(script)], cwd=cwd,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
