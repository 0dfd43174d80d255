"""The port's MoE layer (``repro_torch/layers/moe.py``) on the CPU, held
against JAX's ``repro/layers/moe.py`` on the same weights (JAX's init
carried over by ``params_from_jax``) and inputs (numpy, from a seed).

JAX runs op by op (``jax.disable_jit()``): routes, slots and the valid
mask are compared as integers.  Tolerance: fp32 y within 1e-5 * max(1,
max|y|), aux within 1e-6 of |aux|; bf16 compute y within two bf16
steps, 2^-7 * max(1, max|y|) (the expert products round to bf16 after
summing in another order).  A route that differs from JAX's is printed
with its top-k gap; only a gap within fp32 rounding of the router
probabilities may cause one.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantization import quantize_lm_params as jquantize
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.core.quantization import quantize_lm_params
from repro_torch.layers import moe as tmoe
from repro_torch.models.lm import moe_cfg

jmoe = importlib.import_module("repro.layers.moe")

Y_TOL = 1e-5
AUX_TOL = 1e-6
BF16_TOL = 2.0 ** -7

# JAX's three tests/test_moe.py configurations, the same without a gate,
# and the smoke MoE of kimi-k2 (grok-1's smoke differs only in capacity)
CASES = {
    "basics": (dict(d_model=32, d_ff=64, n_experts=4, top_k=2,
                    capacity_factor=2.0), (2, 16)),
    "drops": (dict(d_model=16, d_ff=32, n_experts=64, top_k=1,
                   capacity_factor=1e-9), (1, 2048)),
    "top1": (dict(d_model=16, d_ff=32, n_experts=1, top_k=1,
                  capacity_factor=4.0), (2, 8)),
    "nongated": (dict(d_model=32, d_ff=64, n_experts=4, top_k=2,
                      capacity_factor=1.25, gated=False), (2, 16)),
    "kimi": (dict(d_model=64, d_ff=128, n_experts=4, top_k=2,
                  capacity_factor=1.0), (3, 24)),
}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def close(got, ref, tol):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


def aux_close(got, ref):
    got, ref = _np(got), _np(ref)
    assert got.shape == ref.shape
    assert np.all(np.abs(got - ref) <= AUX_TOL * np.abs(ref)), (got, ref)


def configs(name, **kw):
    base, shape = CASES[name]
    base = dict(base, **kw)
    tdt = base.pop("dtype", None)
    jc = jmoe.MoeConfig(**base, **({"dtype": jnp.dtype(tdt)} if tdt else {}))
    tc = tmoe.MoeConfig(**base, **({"dtype": getattr(torch, tdt)}
                                   if tdt else {}))
    return jc, tc, shape


def setup(name, seed=0, **kw):
    jc, tc, (B, S) = configs(name, **kw)
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jc)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, jc.d_model)).astype(np.float32)
    return jc, tc, jp, tp, x


def check_routes(jidx, tidx, probs, k):
    """The top-k indices equal JAX's; any token that differs is printed
    with its gap between the k-th and (k+1)-th probability, which must
    lie within fp32 rounding."""
    jidx, tidx = np.asarray(jidx), tidx.numpy()
    bad = np.argwhere((jidx != tidx).any(-1))
    for t in bad:
        p = np.sort(_np(probs)[tuple(t)])[::-1]
        gap = p[k - 1] - p[k] if k < p.size else np.inf
        print(f"route differs at token {tuple(t)}: JAX {jidx[tuple(t)]}, "
              f"port {tidx[tuple(t)]}, top-k gap {gap:.3e}")
        assert gap <= 4 * np.finfo(np.float32).eps, gap
    return bad.size == 0


# ---------------------------------------------------------------------------
# capacity, rules, init
# ---------------------------------------------------------------------------

GRID_T = (1, 2, 7, 8, 9, 16, 100, 255, 256, 1024, 1025, 4096, 32768)


@pytest.mark.parametrize("k,E,cf", [
    (2, 8, 1.25), (8, 384, 1.0), (2, 8, 4.0), (8, 384, 48.0), (2, 4, 2.0),
    (2, 4, 1.0), (1, 64, 1e-9), (1, 1, 4.0), (3, 7, 0.3)])
def test_capacity_equals_jax(k, E, cf):
    """``_capacity`` on a grid of token counts, with grok-1's and
    kimi-k2's published (k, E, capacity factor), their no-drop factors
    (E / k) and JAX's test values: the same Python float arithmetic."""
    for T in GRID_T:
        jc = jmoe.MoeConfig(8, 8, E, k, cf)
        tc = tmoe.MoeConfig(8, 8, E, k, cf)
        got = tmoe._capacity(tc, T)
        assert got == jmoe._capacity(jc, T), (T, got)
        assert got >= 8 and got % 8 == 0
        if cf == E / k:
            assert got >= T


def test_rules_and_config_fields_equal_jax():
    assert tmoe.MOE_RULES == jmoe.MOE_RULES
    jf = {f.name: f.default for f in dataclasses.fields(jmoe.MoeConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tmoe.MoeConfig)}
    assert set(jf) == set(tf)
    assert {k: v for k, v in jf.items() if k != "dtype"} == \
        {k: v for k, v in tf.items() if k != "dtype"}
    for name in ("grok-1-314b", "kimi-k2-1t-a32b"):
        c = moe_cfg(get_arch(name))
        assert (c.n_experts, c.top_k, c.dtype) == (
            get_arch(name).n_experts, get_arch(name).top_k, torch.bfloat16)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_tree_matches_jax(gated, dtype):
    """Leaf names, shapes and dtypes (the router stays fp32); the draws
    have JAX's scales."""
    jc, tc, _ = configs("basics", gated=gated, dtype=dtype)
    jshapes = jax.eval_shape(lambda: jmoe.init_moe(jax.random.PRNGKey(0),
                                                   jc))
    tp = tmoe.init_moe(torch.Generator().manual_seed(0), tc, "cpu")
    assert set(tp) == set(jshapes)
    assert tuple(tp["router"]["w"].shape) == jshapes["router"]["w"].shape
    assert tp["router"]["w"].dtype == torch.float32
    for k in set(tp) - {"router"}:
        assert tuple(tp[k].shape) == jshapes[k].shape, k
        assert str(tp[k].dtype).split(".")[-1] == str(jshapes[k].dtype)
    std = {"w_in": 32 ** -0.5, "w_out": 64 ** -0.5}
    for k, s in std.items():
        assert abs(tp[k].float().std().item() / s - 1) < 0.1, k


# ---------------------------------------------------------------------------
# routing, slotting, the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CASES))
def test_routes_slots_and_valid_equal_jax(name):
    """Route indices, slot ranks and the valid mask equal JAX's as
    integers (JAX's stable argsort order: token-major, then k); the gates
    within 1e-6."""
    jc, tc, jp, tp, x = setup(name)
    T = x.shape[0] * x.shape[1]
    xf = x.reshape(T, -1)
    C = jmoe._capacity(jc, T)
    with jax.disable_jit():
        jg, jidx, jprobs = jmoe._route(jnp.asarray(xf), jp["router"]["w"],
                                       jc)
        jslot, jvalid = jmoe._slot_assign(jidx, jc.n_experts, C)
    tg, tidx, tprobs = tmoe._route(torch.from_numpy(xf)[None],
                                   tp["router"]["w"], tc)
    assert check_routes(jidx, tidx[0], tprobs[0], jc.top_k)
    close(tg[0], jg, 1e-6)
    close(tprobs[0], jprobs, 1e-6)
    tslot, tvalid = tmoe._slot_assign(tidx, tc.n_experts, C)
    assert np.array_equal(tslot[0].numpy(), np.asarray(jslot))
    assert np.array_equal(tvalid[0].numpy(), np.asarray(jvalid))


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_dense_matches_jax(name):
    """y within 1e-5 * max(1, max|y|), aux within 1e-6 of |aux|."""
    jc, tc, jp, tp, x = setup(name)
    with jax.disable_jit():
        yj, aj = jmoe.moe_dense(jp, jnp.asarray(x), jc)
    yt, at = tmoe.moe_dense(tp, torch.from_numpy(x), tc)
    close(yt, yj, Y_TOL)
    aux_close(at, aj)
    yd, ad = tmoe.moe(tp, torch.from_numpy(x), tc)
    assert torch.equal(yd, yt) and torch.equal(ad, at)


def test_capacity_drops_zero_the_same_rows():
    """capacity factor 1e-9 (the capacity floor of 8 slots an expert):
    most of 2048 tokens drop, and the port zeroes exactly JAX's rows."""
    jc, tc, jp, tp, x = setup("drops")
    with jax.disable_jit():
        yj, _ = jmoe.moe_dense(jp, jnp.asarray(x), jc)
    yt, _ = tmoe.moe_dense(tp, torch.from_numpy(x), tc)
    zj = set(np.flatnonzero(np.all(np.asarray(yj)[0] == 0.0, axis=-1)))
    zt = set(np.flatnonzero((yt[0] == 0).all(-1).numpy()))
    assert zt == zj
    assert len(zt) / 2048 > 0.5


def test_top1_is_plain_ffn():
    """One expert, top-1, ample capacity: the expert's gated MLP."""
    _, tc, _, tp, x = setup("top1")
    y, _ = tmoe.moe_dense(tp, torch.from_numpy(x), tc)
    xt = torch.from_numpy(x).reshape(16, 16)
    h = xt @ tp["w_in"][0]
    g = xt @ tp["w_gate"][0]
    ref = (torch.nn.functional.silu(g) * h) @ tp["w_out"][0]
    close(y.reshape(16, 16), ref, Y_TOL)


@pytest.mark.parametrize("name", ["basics", "kimi"])
def test_bf16_compute_matches_jax(name):
    """bf16 params and activations (the router in fp32): routes equal,
    y within 2^-7 * max(1, max|y|)."""
    jc, tc, jp, tp, x = setup(name, dtype="bfloat16")
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with jax.disable_jit():
        yj, aj = jmoe.moe_dense(jp, xb, jc)
        _, jidx, _ = jmoe._route(xb.reshape(-1, jc.d_model),
                                 jp["router"]["w"], jc)
    _, tidx, tprobs = tmoe._route(xt.reshape(1, -1, tc.d_model),
                                  tp["router"]["w"], tc)
    assert check_routes(jidx, tidx[0], tprobs[0], jc.top_k)
    yt, at = tmoe.moe_dense(tp, xt, tc)
    assert yt.dtype == torch.bfloat16
    close(yt, yj, BF16_TOL)
    aux_close(at, aj)


def test_w8_stacked_experts_match_jax():
    """Experts stacked over 3 layers and quantized by both packages'
    ``quantize_lm_params`` (``{"q", "scale"}``, bit-equal): each layer's
    slice through ``moe_dense`` (dequantized on use) against JAX's."""
    jc, tc, _ = configs("kimi")
    keys = jax.random.split(jax.random.PRNGKey(3), 3)
    jstack = jax.vmap(lambda k: jmoe.init_moe(k, jc))(keys)
    with jax.disable_jit():
        jq = jquantize({"moe": jstack})["moe"]
    tq = quantize_lm_params({"moe": params_from_jax(
        jax.tree.map(np.asarray, jstack), "cpu")})["moe"]
    for k in ("w_in", "w_gate", "w_out"):
        assert set(tq[k]) == {"q", "scale"}
        assert np.array_equal(tq[k]["q"].numpy(), np.asarray(jq[k]["q"]))
        assert np.array_equal(tq[k]["scale"].numpy(),
                              np.asarray(jq[k]["scale"]))
    x = np.random.default_rng(4).standard_normal((2, 10, 64)).astype(
        np.float32)
    for i in range(3):
        jp = jax.tree.map(lambda a: a[i], jq)
        tp = jax.tree.map(lambda a: a[i], tq)
        with jax.disable_jit():
            yj, aj = jmoe.moe_dense(jp, jnp.asarray(x), jc)
        yt, at = tmoe.moe_dense(tp, torch.from_numpy(x), tc)
        close(yt, yj, Y_TOL)
        aux_close(at, aj)


# ---------------------------------------------------------------------------
# groups: the engine's decode against JAX's vmapped batch-1 calls
# ---------------------------------------------------------------------------

def _kimi_smoke():
    cfg = smoke_variant(get_arch("kimi-k2-1t-a32b"))
    tc = moe_cfg(cfg)
    jc = jmoe.MoeConfig(tc.d_model, tc.d_ff, tc.n_experts, tc.top_k,
                        tc.capacity_factor)
    jp = jmoe.init_moe(jax.random.PRNGKey(5), jc)
    return jc, tc, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def test_slot_isolation_equals_jax_vmap_of_batch1():
    """Kimi-K2's smoke MoE (4 experts, top-2, capacity factor 1.0) on 16
    identical rows (the engine's decode input with one prompt in every
    slot): one group per row equals ``jax.vmap`` of JAX's batch-1
    ``moe_dense`` (y and the per-row aux), no row zero; the ungrouped
    call equals JAX's batched ``moe_dense``, which shares capacity 8
    among 32 assignments and zeroes rows 8-15."""
    jc, tc, jp, tp = _kimi_smoke()
    row = np.random.default_rng(6).standard_normal((1, 1, 64)).astype(
        np.float32)
    x = np.repeat(row, 16, axis=0)
    with jax.disable_jit():
        yv, av = jax.vmap(lambda xi: jmoe.moe_dense(jp, xi[None], jc))(
            jnp.asarray(x))
        yb, ab = jmoe.moe_dense(jp, jnp.asarray(x), jc)
    yg, ag = tmoe.moe_dense(tp, torch.from_numpy(x), tc, groups=16)
    close(yg, np.asarray(yv)[:, 0], Y_TOL)
    aux_close(ag, av)
    assert bool((yg.reshape(16, -1) != 0).any(-1).all())
    y1, a1 = tmoe.moe_dense(tp, torch.from_numpy(x), tc)
    close(y1, yb, Y_TOL)
    aux_close(a1, ab)
    zero = np.flatnonzero(np.all(np.asarray(yb)[:, 0] == 0.0, axis=-1))
    assert list(zero) == list(range(8, 16))
    assert list(np.flatnonzero((y1[:, 0] == 0).all(-1).numpy())) == \
        list(zero)


@pytest.mark.parametrize("groups,S", [(4, 6), (3, 1), (1, 12)])
def test_groups_equal_jax_vmap(groups, S):
    """Random rows: ``groups`` consecutive groups of the B*S tokens each
    equal JAX's ``moe_dense`` of that group alone (``jax.vmap`` over the
    groups), drops included (capacity factor 1.0)."""
    jc, tc, jp, tp = _kimi_smoke()
    x = np.random.default_rng(groups + S).standard_normal(
        (groups, S, 64)).astype(np.float32) * 3
    with jax.disable_jit():
        yv, av = jax.vmap(lambda xi: jmoe.moe_dense(jp, xi[None], jc))(
            jnp.asarray(x))
    yt, at = tmoe.moe_dense(tp, torch.from_numpy(x), tc, groups=groups)
    close(yt, np.asarray(yv)[:, 0], Y_TOL)
    aux_close(at.reshape(-1), np.asarray(av).reshape(-1))
    with pytest.raises(ValueError, match="groups"):
        tmoe.moe_dense(tp, torch.from_numpy(x), tc, groups=5)
