"""The rest of the port's planner (``SiteOverride`` and ``group_break``,
the ``epilogues`` switch, the ``"autotune"`` fault) and EfficientViT-B2 /
B3, against the JAX package on the CPU.

- Overrides: ``fused=False``, a forced precision, blocks frozen verbatim
  (no tuner consulted), ``demote`` over an override: the same decisions
  (name, fused, reason, precision) as JAX's.  A fused override whose
  blocks do not fit one CTA gets ``"vmem"``: JAX's VMEM check does not
  depend on blocks, so that case is the port's alone.
- ``group_break``: the same groups as JAX's, on B1@224 (a break on
  ``S2.mb1``), on B1_SMOKE and on a deeper smoke config.
- ``epilogues=False``: no epilogue and no int8 boundary, as JAX's
  opt-out; the FIX8 forward under it equals the epilogue dataflow's at
  batch 1, bit for bit, as JAX's does, and the opt-out engine holds the
  port's int8 reference forward's gate.
- The ``"autotune"`` fault: ``plan_program`` names the same site as
  JAX's, and one trace through the port's CPU ladder and JAX's ends in the
  same state (that site demoted, level 1).
- B2 and B3: ``lower`` equals JAX's at 224 px; B2's fp32 forward at 64 px
  within 1e-5 of JAX's reference forward (run op by op); the MSA module at
  head dim 32 within fp32 rounding; ``group_agg_int8``'s plain version at
  d = 32 bit-equal to JAX's oracle.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from test_torch_fix8 import _fp_tree, _perturb_bn
from test_torch_supersite import GROUPS, JCFG, TCFG

from repro.configs import efficientvit_b1 as jconfigs
from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro.core import relu_attention as jra
from repro.kernels.group_conv import kernel as jgk
from repro.kernels.group_conv import ops as jgo
from repro.serving import executors as jex
from repro.serving import faults as jfaults
from repro.serving import scheduler as jsched
from repro.serving.telemetry import Telemetry as JTelemetry
from repro_torch.common.errors import PlanError
from repro_torch.configs import efficientvit_b1 as tconfigs
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.core.quantization import quantize_efficientvit
from repro_torch.core.relu_attention import MSAConfig, msa
from repro_torch.kernels import autotune as tat
from repro_torch.kernels.group_conv.kernel import group_agg_int8
from repro_torch.kernels.group_conv.ops import block_diag
from repro_torch.kernels.registry import get_kernel
from repro_torch.serving import executors as tex
from repro_torch.serving import faults as tfaults
from repro_torch.serving import scheduler as tsched
from repro_torch.serving.telemetry import Telemetry
from repro_torch.serving.vision import VisionEngine, VisionServeConfig


def _np(tree):
    """A port param tree as numpy leaves (the trees share their keys)."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np(v) for v in tree]
    return tree.numpy()


def _port_tree(tcfg, seed):
    """Weights from the port's initialiser, BN statistics perturbed, as
    numpy: both planners read only the tree's precision, and both
    forwards take the same numbers."""
    tree = tevit.init_efficientvit(torch.Generator().manual_seed(seed), tcfg,
                                   "cpu")
    return _perturb_bn(_np(tree), np.random.default_rng(seed))


@pytest.fixture(scope="module")
def smoke():
    return _port_tree(tevit.B1_SMOKE, 0)


@pytest.fixture(scope="module")
def smoke_q(smoke):
    return _np(quantize_efficientvit(params_from_jax(smoke, "cpu")))


@pytest.fixture(scope="module")
def b1():
    return _port_tree(tevit.B1, 1)


@pytest.fixture(scope="module")
def deep():
    return _port_tree(TCFG, 0)


@pytest.fixture(autouse=True)
def port_cache(tmp_path, monkeypatch):
    """The port's autotune cache in a file of its own, no hook left."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(tmp_path / "t.json"))
    tat.clear_memory_cache()
    yield
    tat.set_fault_hook(None)
    tat.clear_memory_cache()


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _plans(jcfg, tcfg, tree, batch=1, **kw):
    """(JAX plan, port plan) of one config and tree; ``jov``/``tov`` are
    the two packages' overrides."""
    jov = kw.pop("jov", None)
    tov = kw.pop("tov", None)
    j = jfusion.plan_program(jprog.lower(jcfg, batch=batch), _jtree(tree),
                             autotune=False, overrides=jov, **kw)
    t = tfusion.plan_program(tprog.lower(tcfg, batch=batch),
                             params_from_jax(tree, "cpu"), overrides=tov,
                             **kw)
    return j, t


def _decisions(plan):
    return [(d.name, d.fused, d.reason, d.precision)
            for d in plan.decisions.values()]


def _groups(plan):
    return {g.name: tuple(g.members) for g in plan.groups.values()}


def _both(**fields):
    return ({k: jfusion.SiteOverride(**v) for k, v in fields.items()},
            {k: tfusion.SiteOverride(**v) for k, v in fields.items()})


# ---------------------------------------------------------------------------
# overrides
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fields", [
    {"S2.mb0": dict(fused=False)},
    {"S3.evit0.msa": dict(fused=False, reason="pinned"),
     "stem.ds0": dict(fused=False, precision="int8")},
    {"S1.mb0": dict(precision="int8"), "S4.evit0.msa": dict(precision="int8")},
    {"S2.mb0": dict(fused=True)},
])
def test_overrides_match_jax(smoke, fields):
    jov, tov = _both(**fields)
    j, t = _plans(jevit.B1_SMOKE, tevit.B1_SMOKE, smoke, jov=jov, tov=tov)
    assert _decisions(t) == _decisions(j)
    assert tfusion.launch_counts(t) == jfusion.launch_counts(j)
    for name, f in fields.items():
        if f.get("fused") is False:
            d = t.decisions[name]
            assert not d.fused and d.reason == f.get("reason", "search")


@pytest.mark.parametrize("fields", [
    {"S2.mb0": dict(precision="fp"), "S3.evit0.msa": dict(precision="fp")},
    {"stem.ds0": dict(fused=False)},
])
def test_overrides_on_a_quantized_tree_match_jax(smoke_q, fields):
    jov, tov = _both(**fields)
    j, t = _plans(jevit.B1_SMOKE, tevit.B1_SMOKE, smoke_q, jov=jov, tov=tov)
    assert _decisions(t) == _decisions(j)
    assert [(d.name, d.q_in, d.epilogue is None)
            for d in t.decisions.values()] == \
        [(d.name, d.q_in, d.epilogue is None) for d in j.decisions.values()]


def test_override_blocks_are_frozen_verbatim(smoke):
    """Blocks given for every fp conv site reach the plan as they are and
    no mbconv/dsconv tuner is consulted (a fault hook on those kinds
    would fire); JAX's planner does the same."""
    program = tprog.lower(tevit.B1_SMOKE)
    tp = params_from_jax(smoke, "cpu")
    ov = {}
    for s in program.fusible():
        if s.kind in ("mbconv", "dsconv"):
            ov[s.name] = tfusion.SiteOverride(
                blocks=get_kernel(s.kind, "fp").candidates(s)[-1])
    faults = tfaults.FaultPlan(
        tfaults.FaultSpec("autotune", times=9, match={"kind": "mbconv"}),
        tfaults.FaultSpec("autotune", times=9, match={"kind": "dsconv"}))
    with faults:
        plan = tfusion.plan_program(program, tp, overrides=ov)
    assert faults.fired == {}
    for name, o in ov.items():
        d = plan.decisions[name]
        assert d.fused and dict(d.blocks) == dict(o.blocks) and not d.reused
    jov = {n: jfusion.SiteOverride(blocks={"block_f": 64}) for n in ov}
    jfaults_ = jfaults.FaultPlan(
        jfaults.FaultSpec("autotune", times=9, match={"kind": "mbconv"}),
        jfaults.FaultSpec("autotune", times=9, match={"kind": "dsconv"}))
    with jfaults_:
        j = jfusion.plan_program(jprog.lower(jevit.B1_SMOKE), _jtree(smoke),
                                 autotune=False, overrides=jov)
    assert jfaults_.fired == {}
    assert _decisions(plan) == _decisions(j)


def test_override_that_does_not_fit_is_vmem(b1):
    """A fused override whose blocks need more shared memory than one
    CTA has is declined with ``"vmem"``: an override chooses among
    launchable schedules only."""
    tp = params_from_jax(b1, "cpu")
    program = tprog.lower(tevit.B1)
    too_big = {"block_rows": 56, "block_m": 128, "split": 1}
    site = next(s for s in program.fusible() if s.name == "S1.mb1")
    impl = get_kernel("mbconv", "fp")
    assert impl.smem_bytes(site, too_big) > impl.smem_budget
    plan = tfusion.plan_program(
        program, tp, supersites=False,
        overrides={"S1.mb1": tfusion.SiteOverride(blocks=too_big)})
    d = plan.decisions["S1.mb1"]
    assert not d.fused and d.reason == "vmem" and d.precision == "fp"
    assert all(x.fused for x in plan.decisions.values() if x is not d)


def test_demote_wins_over_an_override(smoke):
    fields = {"S2.mb0": dict(fused=True, blocks=None),
              "S3.evit0.mb": dict(fused=False)}
    jov, tov = _both(**fields)
    j, t = _plans(jevit.B1_SMOKE, tevit.B1_SMOKE, smoke, jov=jov, tov=tov,
                  demote=("S2.mb0", "S3.evit0.mb"))
    assert _decisions(t) == _decisions(j)
    assert t.decisions["S2.mb0"].reason == "fault"
    assert t.decisions["S3.evit0.mb"].reason == "fault"


def test_site_override_round_trip(smoke):
    _, t = _plans(jevit.B1_SMOKE, tevit.B1_SMOKE, smoke)
    for d in t.decisions.values():
        row = d.to_dict()
        json.dumps(row)
        ov = tfusion.SiteOverride.from_decision(d)
        jov = jfusion.SiteOverride.from_decision(row)
        assert (ov.fused, ov.precision, dict(ov.blocks), ov.reason,
                ov.group_break) == (jov.fused, jov.precision,
                                    dict(jov.blocks), jov.reason,
                                    jov.group_break)
        assert tfusion.SiteOverride.from_decision(row) == ov
        assert ov.to_dict()["blocks"] == dict(d.blocks)
    # replanning with every decision pinned reproduces the plan
    again = tfusion.plan_program(
        tprog.lower(tevit.B1_SMOKE), params_from_jax(smoke, "cpu"),
        overrides={n: tfusion.SiteOverride.from_decision(d)
                   for n, d in t.decisions.items()})
    assert [d.to_dict() for d in again.decisions.values()] == \
        [d.to_dict() for d in t.decisions.values()]


def test_report_dict_is_json_and_matches_jax(smoke_q):
    j, t = _plans(jevit.B1_SMOKE, tevit.B1_SMOKE, smoke_q)
    rows, jrows = tfusion.report_dict(t), jfusion.report_dict(j)
    json.dumps(rows)
    for r, jr in zip(rows, jrows):
        assert r["site"] == jr["site"]
        for k in ("epilogue", "q_in", "hbm_delivered", "launches_fused",
                  "group", "fused", "reason"):
            assert r[k] == jr[k], (r["site"], k)
    assert [g.to_dict()["members"] for g in t.groups.values()] == \
        [g.to_dict()["members"] for g in j.groups.values()]


def test_build_plan_lowers_then_plans(smoke):
    tp = params_from_jax(smoke, "cpu")
    a = tfusion.build_plan(tp, tevit.B1_SMOKE, batch=2, image_size=32)
    b = tfusion.plan_program(tprog.lower(tevit.B1_SMOKE, batch=2,
                                         image_size=32), tp)
    assert [d.to_dict() for d in a.decisions.values()] == \
        [d.to_dict() for d in b.decisions.values()]


# ---------------------------------------------------------------------------
# group_break
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg,breaks,want", [
    ("b1", ("S2.mb1",), {"S1.ss0": ("S1.mb0", "S1.mb1"),
                         "S2.ss0": ("S2.mb1", "S2.mb2")}),
    ("b1", ("S1.mb0", "S2.mb2"), {"S1.ss0": ("S1.mb0", "S1.mb1"),
                                  "S2.ss0": ("S2.mb0", "S2.mb1")}),
    ("b1", ("S1.mb1",), {"S2.ss0": ("S2.mb0", "S2.mb1", "S2.mb2")}),
    ("deep", ("S2.mb1", "stem.ds1"), {"S1.ss0": ("S1.mb0", "S1.mb1"),
                                      "S2.ss0": ("S2.mb1", "S2.mb2")}),
    ("smoke", ("S2.mb0",), {}),
])
def test_group_break_matches_jax(b1, deep, smoke, cfg, breaks, want):
    jcfg, tcfg, tree = {"b1": (jevit.B1, tevit.B1, b1),
                        "deep": (JCFG, TCFG, deep),
                        "smoke": (jevit.B1_SMOKE, tevit.B1_SMOKE,
                                  smoke)}[cfg]
    jov, tov = _both(**{b: dict(group_break=True) for b in breaks})
    j, t = _plans(jcfg, tcfg, tree, jov=jov, tov=tov)
    assert _groups(t) == _groups(j) == want
    assert {d.name: d.group for d in t.decisions.values()} == \
        {d.name: d.group for d in j.decisions.values()}
    assert tfusion.launch_counts(t) == jfusion.launch_counts(j)
    if cfg == "b1" and breaks == ("S2.mb1",):
        assert tfusion.launch_counts(t)["fused"] == 20


def test_group_break_without_breaks_keeps_the_groups(deep):
    j, t = _plans(JCFG, TCFG, deep,
                  jov={"S2.mb1": jfusion.SiteOverride(group_break=False)},
                  tov={"S2.mb1": tfusion.SiteOverride(group_break=False)})
    assert _groups(t) == _groups(j) == GROUPS


# ---------------------------------------------------------------------------
# the epilogues switch
# ---------------------------------------------------------------------------

def test_epilogues_opt_out_matches_jax(smoke_q):
    j, t = _plans(jevit.B1_SMOKE, tevit.B1_SMOKE, smoke_q, epilogues=False)
    assert t.epilogues == {} == dict(j.epilogues)
    assert not any(d.q_in or d.epilogue is not None
                   for d in t.decisions.values())
    assert _decisions(t) == _decisions(j)
    on = tfusion.plan_program(tprog.lower(tevit.B1_SMOKE),
                              params_from_jax(smoke_q, "cpu"))
    assert on.epilogues and any(d.q_in for d in on.decisions.values())


def test_epilogues_opt_out_forward_equals_the_dataflow(smoke_q):
    """At batch 1 the consumer-side quantize gives the epilogue
    dataflow's bits (the arithmetic only moved across the boundary), as
    JAX's ``test_epilogues_opt_out`` holds for JAX."""
    tp = params_from_jax(smoke_q, "cpu")
    program = tprog.lower(tevit.B1_SMOKE, batch=1)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (1, 64, 64, 3)).astype(np.float32))
    on = tfusion.plan_program(program, tp)
    off = tfusion.plan_program(program, tp, epilogues=False)
    assert torch.equal(tprog.execute(program, tp, x, plan=on),
                       tprog.execute(program, tp, x, plan=off))


def test_engine_epilogues_off_holds_the_int8_reference(smoke):
    """``VisionEngine.quantized(epilogues=False)`` on B1_SMOKE: the key
    carries the switch, no plan emits, and the logits of 3 images hold the
    port's int8 reference forward (top-1 equal, within 1e-3 of max|logit|)
    and equal the emitting engine's on the batch-1 tail."""
    cfg = VisionServeConfig(microbatch=2, epilogues=False)
    off = VisionEngine.quantized(params_from_jax(smoke, "cpu"),
                                 tevit.B1_SMOKE, cfg, device="cpu")
    on = VisionEngine.quantized(params_from_jax(smoke, "cpu"),
                                tevit.B1_SMOKE,
                                VisionServeConfig(microbatch=2),
                                device="cpu")
    assert all(not k.epilogues for k in off.cache.keys())
    assert all(k.epilogues for k in on.cache.keys())
    assert not off.plan.epilogues and on.plan.epilogues
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 64, 64, 3)).astype(np.float32))
    got = off.logits(x)
    ref = torch.cat([tprog.execute(tprog.lower(tevit.B1_SMOKE, batch=1),
                                   off.params, x[i:i + 1]) for i in range(3)])
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()
    assert torch.equal(got[2:], on.logits(x)[2:])


# ---------------------------------------------------------------------------
# the "autotune" fault
# ---------------------------------------------------------------------------

def test_autotune_fault_names_the_same_site_as_jax(smoke):
    names = []
    for fmod, plan_fn, tree in (
            (jfaults, lambda: jfusion.plan_program(
                jprog.lower(jevit.B1_SMOKE, batch=1, image_size=32),
                _jtree(smoke), autotune=False), None),
            (tfaults, lambda: tfusion.plan_program(
                tprog.lower(tevit.B1_SMOKE, batch=1, image_size=32),
                params_from_jax(smoke, "cpu"), autotune=False), None)):
        with fmod.FaultPlan(fmod.FaultSpec("autotune", times=1)):
            with pytest.raises(Exception) as ei:
                plan_fn()
        names.append(ei.value.site)
    assert isinstance(ei.value, PlanError) and ei.value.injected
    assert names[0] == names[1] == "stem.ds0"


def _fault_trace(emod, smod, fmod, params, cache_kw):
    """One request on a ManualClock while an ``"autotune"`` fault is
    installed: the build fails, the retry hits the negative cache, the
    ladder demotes the named site, the rebuild serves."""
    clock = smod.ManualClock()
    faults = fmod.FaultPlan(fmod.FaultSpec("autotune", times=1))
    cache = emod.ExecutorCache(params, buckets=(1,), faults=faults,
                               clock=clock, **cache_kw)
    sched = smod.MicroBatchScheduler(cache, params, clock=clock,
                                     backoff_ms=0.0, faults=faults)
    img = np.random.default_rng(6).standard_normal(
        (32, 32, 3)).astype(np.float32)
    req = smod.Request(0, img)
    with faults:
        sched.submit(req)
        for _ in range(8):
            if not sched.outstanding():
                break
            sched.step(drain=True)
            sched.finalize()
    st = cache.degradation(1, 32)
    return ((req.status, req.retries, st.level, sorted(st.demoted),
             faults.fired, dict(cache.telemetry.counters)), req)


def test_autotune_fault_demotes_through_the_ladder_like_jax(smoke):
    j, jreq = _fault_trace(jex, jsched, jfaults, _jtree(smoke),
                           dict(cfg=jevit.B1_SMOKE, autotune=False,
                                telemetry=JTelemetry()))
    t, treq = _fault_trace(tex, tsched, tfaults,
                           params_from_jax(smoke, "cpu"),
                           dict(cfg=tevit.B1_SMOKE, telemetry=Telemetry(),
                                device="cpu"))
    assert t == j
    assert t[:4] == ("completed", 2, 1, ["stem.ds0"])
    assert t[4] == {"autotune": 1}
    assert_allclose(treq.logits, np.asarray(jreq.logits), rtol=1e-5,
                    atol=1e-5)


# ---------------------------------------------------------------------------
# EfficientViT-B2 and B3
# ---------------------------------------------------------------------------

def _site_tuple(s):
    return (s.name, s.kind, s.stage, tuple(s.param_path), tuple(s.in_shape),
            tuple(s.out_shape), s.stride, s.residual,
            {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
             for k, v in s.attrs.items()})


@pytest.mark.parametrize("name", ["efficientvit-b2", "efficientvit-b3"])
def test_b2_b3_configs_and_lowering_match_jax(name):
    jcfg, tcfg = jconfigs.VISION[name], tconfigs.VISION[name]
    for field in ("name", "widths", "depths", "head_dim", "msa_scales",
                  "expand_ratio", "head_widths", "num_classes",
                  "image_size"):
        assert tuple(np.atleast_1d(getattr(tcfg, field))) == \
            tuple(np.atleast_1d(getattr(jcfg, field))), field
    for batch in (1, 8):
        t = tprog.lower(tcfg, batch=batch, image_size=224)
        j = jprog.lower(jcfg, batch=batch, image_size=224)
        assert [_site_tuple(s) for s in t.sites] == \
            [_site_tuple(s) for s in j.sites]
        assert [s.name for s in t.fusible()] == [s.name for s in j.fusible()]


def test_b2_forward_matches_jax_reference():
    """B2 at 64 px, batch 1: JAX's params load leaf for leaf, and the
    port's reference forward and its fused (plain-version) forward are
    within 1e-5 of JAX's reference forward run op by op."""
    jcfg = jconfigs.B2
    fp = _fp_tree(jcfg, 2)
    tp = params_from_jax(fp, "cpu")
    jleaves = jax.tree.leaves(fp)
    tleaves = jax.tree.leaves(jax.tree.map(
        lambda t: t.numpy(), tp, is_leaf=lambda t: isinstance(t,
                                                              torch.Tensor)))
    assert len(jleaves) == len(tleaves)
    assert all(a.shape == b.shape and np.array_equal(a, b)
               for a, b in zip(jleaves, tleaves))
    x = np.random.default_rng(2).standard_normal(
        (1, 64, 64, 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jprog.execute(jprog.lower(jcfg, batch=1,
                                                    image_size=64),
                                        _jtree(fp), jnp.asarray(x)))
    program = tprog.lower(tevit.B2, batch=1, image_size=64)
    ref = tprog.execute(program, tp, torch.from_numpy(x)).numpy()
    fused = tprog.execute(program, tp, torch.from_numpy(x),
                          plan=tfusion.plan_program(program, tp)).numpy()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(ref - want).max() <= 1e-5 * scale
    assert np.abs(fused - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("batch", [1, 2])
def test_msa_at_head_dim_32_matches_jax(batch):
    """B2's S3 MSA module (192 channels, 6 heads of 32, scale 5) at 14 x
    14: the fused module (one attention launch; its plain version here)
    and the reference module against JAX's reference, op by op."""
    jcfg = jra.MSAConfig(192, 32, (5,))
    jp = jax.tree.map(np.asarray, jra.init_msa(jax.random.PRNGKey(batch),
                                               jcfg))
    tp = params_from_jax(jp, "cpu")
    x = np.random.default_rng(batch).standard_normal(
        (batch, 14, 14, 192)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jra.msa(_jtree(jp), jnp.asarray(x), jcfg))
    xt = torch.from_numpy(x)
    ref = msa(tp, xt, MSAConfig(192, 32, (5,))).numpy()
    site = next(s for s in tprog.lower(tevit.B2, batch=batch).fusible()
                if s.name == "S3.evit0.msa")
    assert site.attrs["head_dim"] == 32 and site.attrs["heads"] == 6
    fused = get_kernel("msa", "fp").apply(tp, xt, site).numpy()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(ref - want).max() <= 1e-5 * scale
    assert np.abs(fused - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("H,heads,batch", [(14, 6, 1), (7, 12, 2),
                                           (14, 8, 2)])
def test_group_agg_int8_plain_at_d32_matches_oracle(H, heads, batch):
    """The grouped int8 aggregation at d = 32 (B2's and B3's S3 and S4
    maps): the plain version bit-equal to JAX's oracle, run op by op."""
    rng = np.random.default_rng(H * heads + batch)
    C, d = 3 * heads * 32, 32
    pw = rng.integers(-128, 128, (1, 1, d, C), dtype=np.int8)
    with jax.disable_jit():
        dense = np.asarray(jgo._block_diag(jnp.asarray(pw)))
    assert np.array_equal(block_diag(torch.from_numpy(pw)).numpy(), dense)
    sc = lambda *s: (rng.uniform(0.5, 1.5, s) * 1e-2).astype(np.float32)
    args = (rng.integers(-128, 128, (batch, H, H, C), dtype=np.int8),
            sc(batch), rng.integers(-128, 128, (5, 5, C), dtype=np.int8),
            sc(C), rng.standard_normal(C).astype(np.float32))
    tail = (sc(C), rng.standard_normal(C).astype(np.float32))
    with jax.disable_jit():
        want = np.asarray(jgk.group_agg_int8_ref(
            *(jnp.asarray(a) for a in args), jnp.asarray(dense),
            *(jnp.asarray(a) for a in tail)))
    got = group_agg_int8(*(torch.from_numpy(np.ascontiguousarray(a))
                           for a in (*args, pw[0, 0], *tail))).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
