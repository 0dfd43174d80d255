"""The port's block autotuner (``repro_torch.kernels.autotune``) and the
fp tuners behind ``KernelImpl.tune``, on the CPU.

- The cache: round trip through the file, failing candidates
  disqualified, a corrupt file warned about and re-tuned, malformed rows
  dropped one by one, a schema mismatch rejected, an atomic save, export
  and import (mirroring JAX's ``tests/test_fusion.py`` and
  ``tests/test_fault_tolerance.py`` autotune cases).
- ``shape_key`` and ``tile_work`` give JAX's values for the same
  arguments.
- The fault hook fires at every consultation, sweep or not.
- Each fp family's candidates lead with the kernel's deterministic pick
  and fit one CTA; planning with ``autotune=True`` off the card sweeps
  nothing and freezes those picks.
- A sweep (its timer replaced: CUDA events need the card) picks the
  fastest candidate through each family's real bench, run here on the
  plain versions, and a second consultation hits the cache.
"""
import json
import os

import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.common.errors import PlanError
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.core.program import SuperSite
from repro_torch.kernels import autotune as at
from repro_torch.kernels.dsconv import ops as dsops
from repro_torch.kernels.mbconv import ops as mbops
from repro_torch.kernels.registry import SMEM_LIMIT, get_kernel
from repro_torch.kernels.relu_attn import ops as raops
from repro_torch.kernels.supersite import ops as ssops
from repro_torch.serving.faults import FaultPlan, FaultSpec


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """An isolated cache file, the in-process cache empty."""
    path = tmp_path / "at.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    at.clear_memory_cache()
    yield path
    at.clear_memory_cache()


@pytest.fixture
def fake_timer(monkeypatch):
    """Replace the CUDA-event timer: call the bench once and report the
    time ``times`` gives the candidate being timed (default 1 ms)."""
    times = {}
    current = {}

    def time_cuda(fn, calls=3, windows=5):
        fn()
        return times.get(current.get("c"), 1e-3)

    real = at.autotune

    def tracking(kind, key, candidates, bench=None):
        if bench is None:
            return real(kind, key, candidates, None)

        def wrapped(c):
            current["c"] = tuple(sorted(c.items()))
            return bench(c)
        return real(kind, key, candidates, wrapped)

    monkeypatch.setattr(at, "time_cuda", time_cuda)
    for mod in (mbops, dsops, raops, ssops):
        monkeypatch.setattr(mod, "autotune", tracking)
        monkeypatch.setattr(mod, "on_card", lambda device: True)
    return times


def _bench(calls):
    def bench(c):
        calls.append(dict(c))
        return torch.zeros(())
    return bench


def test_autotune_cache_roundtrip(cache, fake_timer):
    calls = []
    cands = [{"b": 8}, {"b": 16}]
    n = at.SWEEP_COUNT
    bench = _bench(calls)
    first = at.autotune("unit", (3, 5, "f32"), cands, bench)
    assert first in cands and calls and at.SWEEP_COUNT == n + 1
    assert cache.exists()
    # a fresh process: memory dropped, the file reloaded, no sweep
    at.clear_memory_cache()
    calls.clear()
    assert at.autotune("unit", (3, 5, "f32"), cands, bench) == first
    assert calls == [] and at.SWEEP_COUNT == n + 1
    # an unknown key without a bench -> the first candidate, no sweep
    assert at.autotune("unit", (9, 9, "f32"), cands, None) == {"b": 8}


def test_uncached_consultation_gives_the_pick(cache):
    """A tuner asked not to sweep (a planner's ``autotune=False``)
    answers its first candidate whatever the cache holds, and still
    passes the fault point."""
    shape, mid, f = (1, 16, 16, 8), 32, 16
    cands = mbops.ranked_blocks(shape, mid, f, 1, mbops.TUNE_TOP_K)
    key = at.shape_key(batch=1, spatial=(16, 16), c=8, mid=mid, f=f,
                       stride=1, dtype="f32", backend=at.backend_tag("cpu"))
    at.import_entries({"mbconv|" + ",".join(key): dict(cands[-1])})
    assert mbops.tune_blocks(shape, mid, f, device="cpu") == cands[-1]
    assert mbops.tune_blocks(shape, mid, f, allow_sweep=False,
                             device="cpu") == cands[0]
    with FaultPlan(FaultSpec("autotune")):
        with pytest.raises(PlanError):
            mbops.tune_blocks(shape, mid, f, allow_sweep=False,
                              device="cpu")


def test_sweep_picks_the_fastest(cache, monkeypatch):
    timed = {8: 3e-3, 16: 1e-3, 32: 2e-3}
    monkeypatch.setattr(at, "time_cuda",
                        lambda fn, calls=3, windows=5: timed[fn()])
    log0 = len(at.SWEEP_LOG)
    choice = at.autotune("fast", ("k",), [{"b": 8}, {"b": 16}, {"b": 32}],
                         lambda c: c["b"])
    assert choice == {"b": 16}
    entry = at.SWEEP_LOG[log0]
    assert entry["choice"] == {"b": 16} and entry["kind"] == "fast"
    assert [t for _, t, _ in entry["times"]] == [3e-3, 1e-3, 2e-3]


def test_autotune_disqualifies_failing_candidates(cache, monkeypatch):
    monkeypatch.setattr(at, "time_cuda",
                        lambda fn, calls=3, windows=5: (fn(), 1e-3)[1])

    def bench(c):
        if c["b"] == 8:
            raise ValueError("does not fit in shared memory")
        return c["b"]

    n = at.DISQUALIFIED
    assert at.autotune("unit2", (1,), [{"b": 8}, {"b": 16}],
                       bench) == {"b": 16}
    assert at.DISQUALIFIED == n + 1
    # every candidate failing: the first, uncached
    at.autotune("unit3", (1,), [{"b": 8}], bench)
    assert at.DISQUALIFIED == n + 2
    assert "unit3|1" not in at.export_entries()


def test_autotune_corrupt_cache_warns_and_retunes(cache, monkeypatch):
    monkeypatch.setattr(at, "time_cuda",
                        lambda fn, calls=3, windows=5: (fn(), 1e-3)[1])
    cache.write_text('{"truncated": ')
    with pytest.warns(RuntimeWarning, match="corrupt"):
        assert at.autotune("fam", ("k1",), [{"block": 8}]) == {"block": 8}
    at.autotune("fam", ("k1",), [{"block": 8}], bench=lambda c: None)
    on_disk = json.loads(cache.read_text())
    assert on_disk == {"fam|k1": {"block": 8}, at._SCHEMA_KEY:
                       {"version": at.AUTOTUNE_SCHEMA}}


def test_autotune_drops_malformed_entries_individually(cache):
    cache.write_text(json.dumps(
        {at._SCHEMA_KEY: {"version": at.AUTOTUNE_SCHEMA},
         "fam|good": {"block": 16}, "fam|bad": [1, 2, 3]}))
    with pytest.warns(RuntimeWarning, match="malformed"):
        choice = at.autotune("fam", ("good",), [{"block": 999}])
    assert choice == {"block": 16}


@pytest.mark.parametrize("schema", [None, at.AUTOTUNE_SCHEMA + 1, "x"])
def test_autotune_rejects_another_schema(cache, schema):
    rows = {"fam|good": {"block": 16}}
    if schema is not None:
        rows[at._SCHEMA_KEY] = {"version": schema}
    cache.write_text(json.dumps(rows))
    with pytest.warns(RuntimeWarning, match="schema version"):
        assert at.autotune("fam", ("good",), [{"block": 4}]) == {"block": 4}


def test_autotune_save_is_atomic_and_merges(cache, monkeypatch):
    monkeypatch.setattr(at, "time_cuda",
                        lambda fn, calls=3, windows=5: (fn(), 1e-3)[1])
    at.autotune("fam", ("a",), [{"block": 4}], bench=lambda c: None)
    # another process tuned another key into the same file meanwhile
    rows = json.loads(cache.read_text())
    rows["fam|other"] = {"block": 2}
    cache.write_text(json.dumps(rows))
    at.autotune("fam", ("b",), [{"block": 8}], bench=lambda c: None)
    rows = json.loads(cache.read_text())
    assert {"fam|a", "fam|b", "fam|other"} <= set(rows)
    leftovers = [f for f in os.listdir(cache.parent)
                 if f.startswith(cache.name + ".tmp")]
    assert not leftovers


def test_export_import_entries(cache):
    assert at.import_entries({"fam|x": {"b": 1}, "bad": 3,
                              at._SCHEMA_KEY: {"version": 0}},
                             persist=True) == 1
    assert at.autotune("fam", ("x",), [{"b": 9}]) == {"b": 1}
    at.clear_memory_cache()
    assert at.export_entries()["fam|x"] == {"b": 1}


def test_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE", raising=False)
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", "/elsewhere/jax.json")
    assert at.cache_path().endswith(
        os.path.join(".cache", "repro_torch", "autotune.json"))
    assert at.backend_tag("cpu") == at.backend_tag(None) == "cpu"


def test_no_sweep_while_capturing(cache, monkeypatch):
    monkeypatch.setattr(at, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="captures"):
        at.autotune("cap", ("k",), [{"b": 1}], bench=lambda c: None)
    # a consultation without a sweep still answers
    assert at.autotune("cap", ("k",), [{"b": 1}]) == {"b": 1}


@pytest.mark.parametrize("kw", [
    dict(batch=1, spatial=(56, 56), c=32, mid=128, f=32, stride=1),
    dict(batch=8, spatial=(112, 112), c=16, f=16, stride=2),
    dict(batch=96, spatial=196, d=16),
    dict(batch=2, spatial=(7,), d=32)])
@pytest.mark.parametrize("dtype,backend", [("f32", "cpu"),
                                           ("i8", "cuda:NVIDIA H100")])
def test_shape_key_matches_jax(kw, dtype, backend):
    assert at.shape_key(dtype=dtype, backend=backend, **kw) == \
        jat.shape_key(dtype=dtype, backend=backend, **kw)


@pytest.mark.parametrize("n,block", [(196, 256), (196, 64), (49, 16),
                                     (56, 8), (7, 7)])
def test_tile_work_matches_jax(n, block):
    assert at.tile_work(n, block) == jat.tile_work(n, block)


def test_fault_hook_fires_at_every_consultation(cache):
    plan = FaultPlan(FaultSpec("autotune", times=2))
    with plan:
        with pytest.raises(PlanError) as ei:
            at.autotune("fam", ("k",), [{"b": 1}])           # no bench
        assert ei.value.injected
        with pytest.raises(PlanError):
            at.autotune("fam", ("k",), [{"b": 1}], bench=lambda c: None)
        assert at.autotune("fam", ("k",), [{"b": 1}]) == {"b": 1}
    assert plan.fired == {"autotune": 2}
    assert at._FAULT_HOOK is None


# ---------------------------------------------------------------------------
# the fp tuners
# ---------------------------------------------------------------------------

def _b1_sites(batch):
    program = tprog.lower(tevit.B1, batch=batch)
    return program, program.fusible()


@pytest.mark.parametrize("cfg", ["B1", "B3"])
@pytest.mark.parametrize("batch", [1, 8])
def test_candidates_lead_with_the_pick_and_fit(cfg, batch):
    """Every fp family's candidates at every site of B1 and B3 at 224 px:
    the first is the kernel's deterministic pick, each fits one CTA, the
    tile work is >= 1, and the candidates differ."""
    from repro_torch.kernels.dsconv.kernel import choose_blocks as ds_pick
    from repro_torch.kernels.mbconv.kernel import choose_blocks as mb_pick
    program = tprog.lower(getattr(tevit, cfg), batch=batch)
    for site in program.fusible():
        impl = get_kernel(site.kind, "fp")
        cands = impl.candidates(site)
        assert cands and len(set(map(str, cands))) == len(cands)
        if site.kind == "mbconv":
            pick = mb_pick(site.in_shape, site.attrs["mid"],
                           site.out_shape[-1], site.stride)
        elif site.kind == "dsconv":
            pick = ds_pick(site.in_shape, site.out_shape[-1], site.stride)
        else:
            pick = {"block_n": raops.MSA_DEFAULT_BLOCK_N}
        assert cands[0] == pick, site.name
        for c in cands:
            assert impl.smem_bytes(site, c) <= SMEM_LIMIT, (site.name, c)
            assert impl.block_work(site, c) >= 1.0
    for names in (("S2.mb0", "S2.mb1"), ("S1.mb0", "S1.mb1")):
        sup = SuperSite.of(program, names)
        cands = get_kernel("supersite", "fp").candidates(sup)
        assert not cands or cands[0] == ssops.choose_blocks(sup)
        for c in cands:
            assert ssops.supersite_smem_bytes(
                sup, c["block_rows"], c["block_m"]) <= SMEM_LIMIT


def test_msa_candidates_follow_the_tile():
    """One candidate per distinct tile, in JAX's order, the default
    first: 196 tokens take 256 (tile 196), 128, 64; 49 tokens only one."""
    assert raops.candidate_block_n(196, 16) == (
        {"block_n": 256}, {"block_n": 128}, {"block_n": 64})
    assert raops.candidate_block_n(49, 32) == ({"block_n": 256},)


@pytest.mark.parametrize("cfg", ["B1_SMOKE", "B1"])
def test_autotune_off_the_card_plans_the_picks(cache, cfg):
    """``plan_program(autotune=True)`` on CPU params sweeps nothing and
    freezes the same blocks as ``autotune=False``."""
    cfg = getattr(tevit, cfg)
    params = tevit.init_efficientvit(torch.Generator().manual_seed(0), cfg,
                                     "cpu")
    program = tprog.lower(cfg, batch=2)
    n = at.SWEEP_COUNT
    on = tfusion.plan_program(program, params, autotune=True)
    off = tfusion.plan_program(program, params, autotune=False)
    assert at.SWEEP_COUNT == n
    assert [d.to_dict() for d in on.decisions.values()] == \
        [d.to_dict() for d in off.decisions.values()]
    assert [g.to_dict() for g in on.groups.values()] == \
        [g.to_dict() for g in off.groups.values()]


def test_each_family_sweeps_through_its_bench(cache, fake_timer):
    """Each fp tuner with a sweep (its timer faked, the benches run on
    the plain versions here): the candidate the timer calls fastest is
    frozen, the key carries the site's batch and backend, and a second
    consultation hits the cache with no sweep."""
    program = tprog.lower(tevit.B1_SMOKE, batch=2)
    sites = {s.kind: s for s in program.fusible()}
    sup = SuperSite.of(tprog.lower(tevit.EfficientViTConfig(
        name="deep", widths=(8, 16, 24, 32, 48), depths=(1, 2, 1, 1, 1),
        head_widths=(64, 64), num_classes=10, image_size=64), batch=2),
        ("S1.mb0", "S1.mb1"))
    cases = [(get_kernel(k, "fp"), s) for k, s in sites.items()]
    cases.append((get_kernel("supersite", "fp"), sup))
    for impl, site in cases:
        cands = impl.candidates(site)
        want = cands[-1]
        fake_timer[tuple(sorted(want.items()))] = 1e-4
        n = at.SWEEP_COUNT
        got = impl.tune(site, autotune=True, device="cpu")
        assert got == want and at.SWEEP_COUNT == n + (len(cands) > 0), \
            (site.name, cands, got)
        again = impl.tune(site, autotune=True, device="cpu")
        assert again == want and at.SWEEP_COUNT == n + 1
        # off the card the cached choice; autotune=False the pick
        assert impl.tune(site, autotune=True, device=None) == want
        assert impl.tune(site, autotune=False) == cands[0]
    keys = at.export_entries()
    assert any(k.startswith("mbconv|b=2,s=") and k.endswith("backend=cpu")
               for k in keys)
    assert any(k.startswith("relu_attn|b=") for k in keys)
