"""The port's super-site slice (``SuperSite``, the grouping pass, the weight
pack, ``kernels/supersite``) against the JAX package, on the CPU.

On the CPU the chain wrappers take their plain versions, which are held
against the JAX package:
- fp32: within 1e-5 of JAX's kernel in interpret mode (both fp32; the
  plain chain and the Pallas bands sum in their own orders);
- FIX8: BIT FOR BIT against JAX's chain of its own jnp oracles in the
  kernel's order, run op by op (``jax.disable_jit``: jitted XLA
  contracts ``a*b+c`` into an FMA and turns ``x / 6`` into a reciprocal
  multiply, which eager torch never does).  JAX's interpret-mode
  ``supersite_op_int8`` runs its kernel body compiled even under
  ``disable_jit``, so it is not bit-equal to those oracles either (ROADMAP
  R5); the tests print how far it is and where it first differs.
The fp32 packs match within rtol 1e-6 (BN folding uses rsqrt, and
``lax.rsqrt`` and ``torch.rsqrt`` differ); the int8 packs are equal.
The config is ``tests/test_supersite.py``'s: deep enough that the default
plan groups stem.ss0 (a residual first member), S1.ss0 and S2.ss0.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_fix8 import _fp_tree

from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro.core import quantization as jq
from repro.kernels.dsconv import ref as jdr
from repro.kernels.mbconv import ref as jmr
from repro.kernels.supersite import kernel as jsk
from repro.kernels.supersite import ops as jso
from repro.kernels.supersite import pack as jpack
from repro_torch.common.errors import LoweringError
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.kernels.supersite import kernel as tsk
from repro_torch.kernels.supersite import ops as tso
from repro_torch.kernels.supersite import pack as tpack
from repro_torch.serving.executors import ExecutorCache

JCFG = jevit.EfficientViTConfig(
    name="ss-smoke", widths=(8, 16, 24, 32, 48), depths=(2, 2, 3, 1, 1),
    head_widths=(64, 64), num_classes=10, image_size=64)
TCFG = tevit.EfficientViTConfig(
    name="ss-smoke", widths=(8, 16, 24, 32, 48), depths=(2, 2, 3, 1, 1),
    head_widths=(64, 64), num_classes=10, image_size=64)
GROUPS = {"stem.ss0": ("stem.ds0", "stem.ds1"),
          "S1.ss0": ("S1.mb0", "S1.mb1"),
          "S2.ss0": ("S2.mb0", "S2.mb1", "S2.mb2")}
B1_GROUPS = {k: v for k, v in GROUPS.items() if k != "stem.ss0"}
TOL = 1e-5


def _trees(jcfg, seed):
    """(fp tree, quantized tree) as numpy; both sides consume the same
    quantized tree, so JAX may quantize it jitted."""
    fp = _fp_tree(jcfg, seed)
    q = jax.jit(jq.quantize_efficientvit)(jax.tree.map(jnp.asarray, fp))
    return fp, jax.tree.map(np.asarray, q)


@pytest.fixture(scope="module")
def deep():
    return _trees(JCFG, 0)


@pytest.fixture(scope="module")
def b1():
    return _trees(jevit.B1, 1)


@pytest.fixture(autouse=True)
def fresh_pack_caches():
    tpack.clear_pack_cache()
    tpack.reset_pack_stats()
    jpack.clear_pack_cache()
    yield
    tpack.clear_pack_cache()
    tpack.reset_pack_stats()
    jpack.clear_pack_cache()


def _configs(name):
    return (JCFG, TCFG) if name == "deep" else (jevit.B1, tevit.B1)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _groups(plan):
    return {g.name: tuple(g.members) for g in plan.groups.values()}


def _sups(jcfg, tcfg, batch, names):
    res = tcfg.image_size
    return (jprog.SuperSite.of(jprog.lower(jcfg, batch=batch,
                                           image_size=res), names),
            tprog.SuperSite.of(tprog.lower(tcfg, batch=batch,
                                           image_size=res), names))


# ---------------------------------------------------------------------------
# (a) SuperSite validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("names", [("S2.mb0",), ("S2.mb0", "S2.mb2"),
                                   ("S1.mb1", "S2.mb0")])
def test_supersite_of_rejects_bad_chains_like_jax(names):
    """< 2 members, not consecutive, across a stage boundary."""
    with pytest.raises(LoweringError):
        tprog.SuperSite.of(tprog.lower(TCFG, image_size=64), names)
    with pytest.raises(jprog.LoweringError):
        jprog.SuperSite.of(jprog.lower(JCFG, image_size=64), names)
    good = tprog.SuperSite.of(tprog.lower(TCFG, image_size=64),
                              GROUPS["S2.ss0"])
    assert good.stage == "S2" and good.members == GROUPS["S2.ss0"]
    assert good.in_shape == (1, 16, 16, 16)
    assert good.out_shape == (1, 8, 8, 24)


# ---------------------------------------------------------------------------
# (b) the grouping pass and its accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", ["deep", "b1"])
@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_grouping_matches_jax(deep, b1, cfg, precision, tmp_autotune_cache):
    jcfg, tcfg = _configs(cfg)
    fp, q = deep if cfg == "deep" else b1
    tree = fp if precision == "fp" else q
    j = jfusion.plan_program(jprog.lower(jcfg), _jtree(tree),
                             autotune=False)
    t = tfusion.plan_program(tprog.lower(tcfg), params_from_jax(tree, "cpu"))
    want = GROUPS if cfg == "deep" else B1_GROUPS
    assert _groups(t) == _groups(j) == want
    assert all(g.precision == precision for g in t.groups.values())
    print(f"{cfg} {precision} blocks: port "
          f"{ {g.name: dict(g.blocks) for g in t.groups.values()} }, JAX "
          f"{ {g.name: dict(g.blocks) for g in j.groups.values()} }")
    assert {d.name: d.group for d in t.decisions.values()} == \
        {d.name: d.group for d in j.decisions.values()}
    assert tfusion.launch_counts(t) == jfusion.launch_counts(j)
    if cfg == "b1":
        assert tfusion.launch_counts(t)["fused"] == (
            tfusion.EXPECTED_B1_SUPERSITE_LAUNCHES if precision == "fp"
            else tfusion.EXPECTED_B1_SUPERSITE_LAUNCHES_INT8)
        assert (tfusion.EXPECTED_B1_SUPERSITE_LAUNCHES,
                tfusion.EXPECTED_B1_SUPERSITE_LAUNCHES_INT8) == (19, 26)
    jrep = {r["site"]: r for r in jfusion.plan_report(j)}
    for r in tfusion.plan_report(t):
        for k in ("hbm_unfused", "hbm_fused", "hbm_w", "hbm_delivered",
                  "q_in", "launches_ref", "launches_fused", "group"):
            assert r[k] == jrep[r["site"]][k], (r["site"], k)


def test_group_blocks_follow_the_batch_from_a_donor(deep):
    tp = params_from_jax(deep[0], "cpu")
    donor = tfusion.plan_program(tprog.lower(TCFG, batch=4), tp)
    again = tfusion.plan_program(tprog.lower(TCFG, batch=4), tp,
                                 reuse=donor)
    other = tfusion.plan_program(tprog.lower(TCFG, batch=1), tp,
                                 reuse=donor)
    assert _groups(again) == _groups(other) == GROUPS
    assert all(g.reused and g.blocks == donor.groups[g.name].blocks
               for g in again.groups.values())
    assert not any(g.reused for g in other.groups.values())


# ---------------------------------------------------------------------------
# (c) band geometry, (d) the weight packs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_band_geometry_matches_jax(rows):
    for names in B1_GROUPS.values():
        js, ts = _sups(jevit.B1, tevit.B1, 1, names)
        jn, jm = jsk.band_geometry(jso._member_specs(js), rows,
                                   js.out_shape[1])
        tn, tm = tsk.band_geometry(tso._member_specs(ts), rows,
                                   ts.out_shape[1])
        assert tn == jn
        assert [tuple(m)[:12] for m in tm] == [tuple(m)[:12] for m in jm]


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_packs_match_jax(deep, b1, precision):
    for cfg, groups in (("deep", GROUPS), ("b1", B1_GROUPS)):
        jcfg, tcfg = _configs(cfg)
        fp, q = deep if cfg == "deep" else b1
        tree = fp if precision == "fp" else q
        jt, tt = _jtree(tree), params_from_jax(tree, "cpu")
        for names in groups.values():
            js, ts = _sups(jcfg, tcfg, 1, names)
            jp = jpack.pack_weights(jt, js, precision)
            tp = tpack.pack_weights(tt, ts, precision)
            assert tp.fp_offsets == jp.fp_offsets
            assert tp.q_offsets == jp.q_offsets
            assert tp.nbytes == jp.nbytes
            if precision == "int8":
                np.testing.assert_array_equal(tp.q.numpy(), np.asarray(jp.q))
                np.testing.assert_array_equal(tp.fp.numpy(),
                                              np.asarray(jp.fp))
            else:
                assert tp.q is None and jp.q is None
                np.testing.assert_allclose(tp.fp.numpy(), np.asarray(jp.fp),
                                           rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# (e) fp32: the plain chain and the grouped forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 2])
def test_fp_chain_matches_jax_supersite_op(deep, batch):
    jt = _jtree(deep[0])
    tt = params_from_jax(deep[0], "cpu")
    rng = np.random.default_rng(batch)
    for names in GROUPS.values():
        js, ts = _sups(JCFG, TCFG, batch, names)
        x = rng.standard_normal(ts.in_shape).astype(np.float32)
        jp = jpack.pack_weights(jt, js, "fp")
        want = np.asarray(jso.supersite_op(
            jnp.asarray(x), jp.fp,
            geom=jso.make_fp_geom(js, jp, jso.choose_block_rows(js)),
            interpret=True))
        tp = tpack.pack_weights(tt, ts, "fp")
        blocks = tso.choose_blocks(ts)
        got = tsk.supersite_fused(
            torch.from_numpy(x), tp.fp,
            geom=tso.make_fp_geom(ts, tp, blocks["block_rows"],
                                  blocks["block_m"])).numpy()
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= TOL, names


@pytest.mark.parametrize("batch", [1, 2])
def test_fp_grouped_forward(deep, batch, tmp_autotune_cache):
    """Grouped against the port's per-site forward and JAX's grouped
    forward, within 1e-5."""
    x = np.random.default_rng(10 + batch).standard_normal(
        (batch, 64, 64, 3)).astype(np.float32)
    jprogram = jprog.lower(JCFG, batch=batch)
    jt = _jtree(deep[0])
    jplan = jfusion.plan_program(jprogram, jt, autotune=False)
    want = np.asarray(jprog.execute(jprogram, jt, jnp.asarray(x),
                                    plan=jplan))
    program = tprog.lower(TCFG, batch=batch)
    tt = params_from_jax(deep[0], "cpu")
    plan = tfusion.plan_program(program, tt)
    assert _groups(plan) == GROUPS
    got = tprog.execute(program, tt, torch.from_numpy(x), plan=plan)
    flat = tprog.execute(program, tt, torch.from_numpy(x),
                         plan=tfusion.plan_program(program, tt,
                                                   supersites=False))
    assert (got - flat).abs().max().item() <= TOL
    assert np.abs(got.numpy() - want).max() <= TOL


# ---------------------------------------------------------------------------
# (f) FIX8: the plain chain bit for bit against JAX
# ---------------------------------------------------------------------------

def _take(flat, off, shape):
    return flat[0, off:off + math.prod(shape)].reshape(shape)


def _jax_oracle_chain(geom, pack, x_q, x_s, x_fp, exit_emit):
    """``_supersite_int8_kernel``'s order over JAX's per-site jnp oracles
    and per-image ``quantize_act``, op by op."""
    with jax.disable_jit():
        cur_q, cur_s, cur_fp = x_q, x_s, x_fp
        last = len(geom.members) - 1
        for k, m in enumerate(geom.members):
            C, F, qo, fo = m.c_in, m.f_out, m.q_offs, m.fp_offs
            if m.kind == "mbconv":
                M = m.mid
                s1, b1, dws, dwb, s2, b2 = (_take(pack.fp, o, (n,)) for o, n
                                            in zip(fo, (M, M, M, M, F, F)))
                out = jmr.mbconv_int8_ref(
                    cur_q, cur_s, _take(pack.q, qo[0], (C, M)), s1, b1,
                    _take(pack.q, qo[1], (3, 3, M)), dws, dwb,
                    _take(pack.q, qo[2], (M, F)), s2, b2, stride=m.stride)
            else:
                dws, dwb, pws, pwb = (_take(pack.fp, o, (n,)) for o, n in
                                      zip(fo, (C, C, F, F)))
                out = jdr.dsconv_int8_ref(
                    cur_q, cur_s, _take(pack.q, qo[0], (3, 3, C)), dws, dwb,
                    _take(pack.q, qo[1], (C, F)), pws, pwb, stride=m.stride)
            cur_fp = cur_fp + out if m.residual else out
            if k < last or exit_emit:
                qt = jq.quantize_act(cur_fp)
                cur_q, cur_s = qt.q, qt.scale
    return (cur_q, cur_s, cur_fp) if exit_emit else cur_fp


def _prefix(geom, k):
    """The chain's first k members as a chain of its own."""
    m = geom.members[k - 1]
    return geom._replace(members=geom.members[:k], h_out=m.h_in // m.stride,
                         w_out=m.w_in // m.stride, f_out=m.f_out)


def _int8_chain_case(jt, tt, jcfg, tcfg, batch, names, seed):
    rng = np.random.default_rng(seed)
    js, ts = _sups(jcfg, tcfg, batch, names)
    x_q = rng.integers(-128, 128, ts.in_shape, dtype=np.int8)
    x_s = (rng.uniform(0.5, 1.5, batch) * 1e-2).astype(np.float32)
    x_fp = (rng.standard_normal(ts.in_shape).astype(np.float32)
            if ts.sites[0].residual else None)
    jp = jpack.pack_weights(jt, js, "int8")
    tp = tpack.pack_weights(tt, ts, "int8")
    jgeom, tgeom = jso.make_int8_geom(js, jp), tso.make_int8_geom(ts, tp)
    jx = [None if a is None else jnp.asarray(a) for a in (x_q, x_s, x_fp)]
    tx = [None if a is None else torch.from_numpy(a) for a in (x_q, x_s, x_fp)]
    # the int8 exit's fp map is the fp32 exit: one oracle run serves all
    want = [np.asarray(w) for w in _jax_oracle_chain(jgeom, jp, *jx, True)]
    for emit, keep in ((False, False), (True, False), (True, True)):
        got = tsk.supersite_fused_int8(*tx[:2], tp.q, tp.fp, geom=tgeom,
                                       x_fp=tx[2], exit_emit=emit,
                                       keep_fp=keep)
        got = got if emit else (got,)
        exp = want[:3 if keep else 2] if emit else want[2:]
        assert len(got) == len(exp)
        for g, w in zip(got, exp):
            g = g.numpy()
            assert g.dtype == w.dtype and g.shape == w.shape
            n = int(np.sum(g != w))
            assert n == 0, f"{names} emit={emit}: {n} of {w.size} differ"
    # JAX's interpret-mode kernel, fp32 exit: how far it lands from the
    # port (and from JAX's own oracles), and the first member that differs
    def kernel(k):
        with jax.disable_jit():
            return np.asarray(jso.supersite_op_int8(
                jx[0], jx[1], jp.q, jp.fp, jx[2] if ts.sites[0].residual
                else None, geom=_prefix(jgeom, k), interpret=True))

    kern = kernel(len(names))
    d = np.abs(kern - want[2]).max() / max(1.0, np.abs(want[2]).max())
    first = None
    for k in range(1, len(names) + 1):
        out = kern if k == len(names) else kernel(k)
        mine = tsk.supersite_fused_int8(*tx[:2], tp.q, tp.fp,
                                        geom=_prefix(tgeom, k),
                                        x_fp=tx[2]).numpy()
        n = int(np.sum(out != mine))
        if n:
            first = (names[k - 1], n, out.size)
            break
    print(f"{names} batch {batch}: JAX interpret kernel vs port, first "
          f"differing member {first}; chain output max|d| {d:.3e} of "
          f"max|out|")


@pytest.mark.parametrize("group", list(B1_GROUPS))
def test_int8_chain_bit_equal_jax_b1_224(b1, group):
    _int8_chain_case(_jtree(b1[1]), params_from_jax(b1[1], "cpu"), jevit.B1,
                     tevit.B1, 1, B1_GROUPS[group], seed=len(group))


@pytest.mark.parametrize("batch", [1, 2])
def test_int8_chain_bit_equal_jax_deep(deep, batch):
    jt, tt = _jtree(deep[1]), params_from_jax(deep[1], "cpu")
    for i, names in enumerate(GROUPS.values()):
        _int8_chain_case(jt, tt, JCFG, TCFG, batch, names, seed=i + batch)


# ---------------------------------------------------------------------------
# (g) FIX8: grouped forward bit-equal to per-site, row by row
# ---------------------------------------------------------------------------

def test_int8_grouped_forward_bit_equal_per_site(deep):
    tt = params_from_jax(deep[1], "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 64, 64, 3)).astype(np.float32))
    program = tprog.lower(TCFG, batch=2)
    plan = tfusion.plan_program(program, tt)
    assert _groups(plan) == GROUPS
    got = tprog.execute(program, tt, x, plan=plan)
    flat = tprog.execute(program, tt, x, plan=tfusion.plan_program(
        program, tt, supersites=False))
    assert torch.equal(got, flat)
    one = tprog.lower(TCFG, batch=1)
    plan1 = tfusion.plan_program(one, tt)
    for i in range(2):
        assert torch.equal(tprog.execute(one, tt, x[i:i + 1], plan=plan1),
                           got[i:i + 1])


# ---------------------------------------------------------------------------
# (h) weight-pack residency across buckets
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_executor_cache_builds_each_pack_once(deep, precision):
    tree = deep[0] if precision == "fp" else deep[1]
    cache = ExecutorCache(params_from_jax(tree, "cpu"), TCFG,
                          buckets=(1, 2), device="cpu")
    t = cache.telemetry.counters
    cache.get(1, 64)
    assert t["weight_pack_built"] == 3 and t.get("weight_pack_hit", 0) == 0
    cache.get(2, 64)                   # another bucket: the same packs
    assert t["weight_pack_built"] == 3 and t["weight_pack_hit"] == 3
    cache.get(1, 32)                   # another resolution: the same packs
    assert t["weight_pack_built"] == 3 and t["weight_pack_hit"] == 6
    assert tpack.pack_stats() == {"built": 3, "hits": 6}
