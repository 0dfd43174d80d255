"""The port's program IR, fusion plan and forward (``repro_torch.core``)
against the JAX package, on the CPU.

Weights come from the JAX initialiser with BN statistics perturbed in
numpy, and reach the port through ``params_from_jax``.  The forward is
held to rtol = atol = 1e-5 on the smoke config and 1e-4 on B1@224 (fp32
on both sides; 30-odd layers of different summation order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro_torch.common.errors import LoweringError, PlanError
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog


def _perturb_bn(tree, rng):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape[0]
            return {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        return {k: _perturb_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturb_bn(v, rng) for v in tree]
    return tree


def _jax_params(jcfg, seed=0):
    init = jax.jit(jevit.init_efficientvit, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    return _perturb_bn(tree, np.random.default_rng(seed))


@pytest.fixture(scope="module")
def smoke():
    return _jax_params(jevit.B1_SMOKE)


@pytest.fixture(scope="module")
def b1():
    return _jax_params(jevit.B1, seed=1)


def _jax_forward(program, params, x):
    """The JAX reference forward, jitted (eager dispatch is slow)."""
    return np.asarray(jax.jit(lambda p, x: jprog.execute(program, p, x))(
        params, jnp.asarray(x)))


def _images(n, res, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, res, res, 3)).astype(np.float32)


# ---------------------------------------------------------------------------
# lowering and the manifest
# ---------------------------------------------------------------------------

def _site_tuple(s):
    return (s.name, s.kind, s.stage, tuple(s.param_path), tuple(s.in_shape),
            tuple(s.out_shape), s.stride, s.residual, s.act,
            {k: (tuple(v) if isinstance(v, (list, tuple)) else v)
             for k, v in s.attrs.items()})


@pytest.mark.parametrize("res", [192, 224, 256, 384])
def test_lower_matches_jax(res):
    t = tprog.lower(tevit.B1, batch=2, image_size=res)
    j = jprog.lower(jevit.B1, batch=2, image_size=res)
    assert [_site_tuple(s) for s in t.sites] == \
        [_site_tuple(s) for s in j.sites]
    assert [s.name for s in t.fusible()] == [s.name for s in j.fusible()]


def test_manifest_macs_match_jax():
    t = tprog.manifest(tprog.lower(tevit.B1))
    j = jprog.manifest(jprog.lower(jevit.B1))
    assert sum(op.macs for op in t) == 518_963_712
    assert [(o.stage, o.name, o.kind, o.h, o.w, o.c_in, o.c_out, o.k,
             o.fused_with_prev, o.macs) for o in t] == \
        [(o.stage, o.name, o.kind, o.h, o.w, o.c_in, o.c_out, o.k,
          o.fused_with_prev, o.macs) for o in j]
    assert [s.name for s, _ in tprog.site_records(tprog.lower(tevit.B1))] \
        == [s.name for s, _ in jprog.site_records(jprog.lower(jevit.B1))]


def test_lower_rejects_bad_geometry():
    with pytest.raises(LoweringError, match="multiples of 32"):
        tprog.lower(tevit.B1, image_size=200)
    with pytest.raises(LoweringError, match="batch"):
        tprog.lower(tevit.B1, batch=0)
    assert issubclass(LoweringError, ValueError)


# ---------------------------------------------------------------------------
# the fusion plan
# ---------------------------------------------------------------------------

def test_b1_plan_matches_jax_without_supersites(b1):
    j = jfusion.plan_program(jprog.lower(jevit.B1), b1, autotune=False,
                             supersites=False)
    tp = params_from_jax(b1, "cpu")
    t = tfusion.plan_program(tprog.lower(tevit.B1), tp, supersites=False)
    assert [(d.name, d.kind, d.fused, d.precision, tuple(d.shape))
            for d in t.decisions.values()] == \
        [(d.name, d.kind, d.fused, d.precision, tuple(d.shape))
         for d in j.decisions.values()]
    assert tfusion.launch_counts(t) == jfusion.launch_counts(j)
    assert tfusion.launch_counts(t)["fused"] == \
        tfusion.EXPECTED_B1_FUSED_LAUNCHES == 22
    kinds = [d.kind for d in t.decisions.values() if d.fused]
    assert (kinds.count("dsconv"), kinds.count("mbconv"),
            kinds.count("msa")) == (1, 14, 7)
    jrep = {r["site"]: r for r in jfusion.plan_report(j)}
    for r in tfusion.plan_report(t):
        for key in ("hbm_unfused", "hbm_fused", "hbm_w", "launches_ref",
                    "launches_fused"):
            assert r[key] == jrep[r["site"]][key], (r["site"], key)


def test_plan_flags_and_precision(smoke):
    tp = params_from_jax(smoke, "cpu")
    program = tprog.lower(tevit.B1_SMOKE)
    plan = tfusion.plan_program(program, tp, fuse_mbconv=False)
    for d in plan.decisions.values():
        assert d.fused == (d.kind != "mbconv")
        assert d.reason == ("disabled" if d.kind == "mbconv" else "ok")
    forced = tfusion.plan_program(program, tp, precision="int8")
    j = jfusion.plan_program(jprog.lower(jevit.B1_SMOKE), smoke,
                             autotune=False, supersites=False,
                             precision="int8")
    assert [(d.name, d.fused, d.reason) for d in forced.decisions.values()] \
        == [(d.name, d.fused, d.reason) for d in j.decisions.values()]
    with pytest.raises(ValueError, match="precision"):
        tfusion.plan_program(program, tp, precision="bf16")


def test_plan_reuse_and_vmem_demotion(smoke, monkeypatch):
    tp = params_from_jax(smoke, "cpu")
    donor = tfusion.plan_program(tprog.lower(tevit.B1_SMOKE, batch=4), tp)
    again = tfusion.plan_program(tprog.lower(tevit.B1_SMOKE, batch=4), tp,
                                 reuse=donor)
    assert all(d.reused for d in again.decisions.values())
    other = tfusion.plan_program(tprog.lower(tevit.B1_SMOKE, batch=1), tp,
                                 reuse=donor)
    # msa blocks do not follow the batch; the conv kernels' bands do
    assert {d.kind for d in other.decisions.values() if d.reused} == {"msa"}
    from repro_torch.kernels.registry import get_kernel
    monkeypatch.setattr(get_kernel("mbconv"), "smem_budget", 0)
    small = tfusion.plan_program(tprog.lower(tevit.B1_SMOKE), tp)
    for d in small.decisions.values():
        assert d.fused == (d.kind != "mbconv")
        if d.kind == "mbconv":
            assert d.reason == "vmem"


def test_plan_error_names_the_site(smoke):
    tp = params_from_jax(smoke, "cpu")
    del tp["stage3"]["blocks"][0]["msa"]["qkv"]
    with pytest.raises(PlanError) as exc:
        tfusion.plan_program(tprog.lower(tevit.B1_SMOKE), tp)
    assert exc.value.site == "S3.evit0.msa"


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res,batch", [(32, 1), (32, 2), (64, 1), (64, 2)])
def test_reference_forward_matches_jax_smoke(smoke, res, batch):
    x = _images(batch, res, seed=res + batch)
    ref = _jax_forward(jprog.lower(jevit.B1_SMOKE, batch=batch,
                                   image_size=res), smoke, x)
    got = tprog.execute(tprog.lower(tevit.B1_SMOKE, batch=batch,
                                    image_size=res),
                        params_from_jax(smoke, "cpu"), torch.from_numpy(x))
    assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_reference_forward_matches_jax_b1_224(b1):
    x = _images(1, 224, seed=3)
    ref = _jax_forward(jprog.lower(jevit.B1), b1, x)
    got = tprog.execute(tprog.lower(tevit.B1), params_from_jax(b1, "cpu"),
                        torch.from_numpy(x))
    assert got.shape == (1, 1000)
    assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    assert int(got.argmax()) == int(np.argmax(ref))


@pytest.mark.parametrize("res,batch", [(32, 2), (64, 1)])
def test_planned_forward_matches_jax_smoke(smoke, res, batch):
    """``execute(plan)`` routes every fusible site through the registry
    (the kernels' plain versions on CPU tensors)."""
    x = _images(batch, res, seed=7)
    ref = _jax_forward(jprog.lower(jevit.B1_SMOKE, batch=batch,
                                   image_size=res), smoke, x)
    tp = params_from_jax(smoke, "cpu")
    program = tprog.lower(tevit.B1_SMOKE, batch=batch, image_size=res)
    plan = tfusion.plan_program(program, tp)
    assert plan.n_fused() == len(program.fusible())
    got = tprog.execute(program, tp, torch.from_numpy(x), plan=plan)
    assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_init_efficientvit_tree_matches_jax():
    t = tevit.init_efficientvit(torch.Generator().manual_seed(0),
                                tevit.B1_SMOKE, device="cpu")
    j = jax.eval_shape(lambda key: jevit.init_efficientvit(
        key, jevit.B1_SMOKE), jax.random.PRNGKey(0))
    leaf = lambda a: isinstance(a, torch.Tensor)
    assert jax.tree.map(lambda a: tuple(a.shape), t, is_leaf=leaf) == \
        jax.tree.map(lambda a: tuple(a.shape), j)
    for site in tprog.lower(tevit.B1_SMOKE).sites:
        if site.param_path:
            tprog.params_at(t, site.param_path)
