"""The port's layers and MSA (``repro_torch.layers``, ``core.relu_attention``)
against the JAX package, on the CPU.

Inputs and weights are drawn with numpy from a seed and fed to both
frameworks; BN statistics are perturbed away from the identity init so
BN and its folding are exercised.  Tolerance rtol = atol = 1e-5: both
sides compute in fp32 and differ only in summation order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import quantization as jq
from repro.core import relu_attention as jra
from repro.layers import conv as jconv
from repro.layers import norms as jnorms
from repro_torch.convert import params_from_jax
from repro_torch.core import quantization as tq
from repro_torch.core import relu_attention as tra
from repro_torch.layers import conv as tconv
from repro_torch.layers import norms as tnorms

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _bn(rng, n):
    return {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
            "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}


def _perturb_bn(tree, rng):
    """Replace every BN leaf dict of a numpy tree with random stats."""
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            return _bn(rng, tree["scale"].shape[0])
        return {k: _perturb_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturb_bn(v, rng) for v in tree]
    return tree


@pytest.mark.parametrize("k,stride,groups,size", [
    (1, 1, 1, 8), (1, 2, 1, 8), (3, 1, 1, 9), (3, 2, 1, 8), (3, 2, 1, 7),
    (3, 1, "dw", 8), (3, 2, "dw", 8), (5, 1, "dw", 7), (5, 2, "dw", 8),
    (1, 1, 3, 8), (5, 1, 6, 6)])
def test_conv2d_matches_jax(k, stride, groups, size):
    """XLA SAME (a 3x3 stride 2 on an even extent pads (0, 1)), HWIO
    weights and grouped convs with contiguous output groups."""
    rng = np.random.default_rng(k * 100 + stride * 10 + size)
    c_in = 12
    g = c_in if groups == "dw" else groups
    c_out = c_in if groups == "dw" else 18
    x = rng.standard_normal((2, size, size, c_in)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, c_in // g, c_out)).astype(
        np.float32), "b": rng.standard_normal(c_out).astype(np.float32)}
    ref = jconv.conv2d(p, jnp.asarray(x), stride=stride, groups=g)
    got = tconv.conv2d(params_from_jax(p, "cpu"), torch.from_numpy(x),
                       stride=stride, groups=g)
    assert tuple(got.shape) == ref.shape
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("size,k,stride", [(8, 3, 2), (7, 3, 2), (8, 5, 1),
                                           (224, 3, 2), (9, 5, 2)])
def test_same_pads_match_xla(size, k, stride):
    lo, hi = tconv.same_pads(size, k, stride)
    out = (size + lo + hi - k) // stride + 1
    assert out == -(-size // stride)
    if (size, k, stride) == (224, 3, 2):
        assert (lo, hi) == (0, 1)


def test_pwconv_and_dwconv_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 6, 16)).astype(np.float32)
    pw = {"w": rng.standard_normal((1, 1, 16, 24)).astype(np.float32),
          "b": rng.standard_normal(24).astype(np.float32)}
    dw = {"w": rng.standard_normal((3, 3, 1, 16)).astype(np.float32)}
    xt = torch.from_numpy(x)
    assert_allclose(tconv.pwconv(params_from_jax(pw, "cpu"), xt).numpy(),
                    np.asarray(jconv.pwconv(pw, jnp.asarray(x))), **TOL)
    assert_allclose(
        tconv.dwconv2d(params_from_jax(dw, "cpu"), xt, stride=2).numpy(),
        np.asarray(jconv.dwconv2d(dw, jnp.asarray(x), stride=2)), **TOL)


def test_init_shapes_match_jax():
    gen = torch.Generator().manual_seed(0)
    key = jax.random.PRNGKey(0)
    for args, kw in (((3, 12, 12), {"groups": 12}), ((1, 8, 24), {}),
                     ((5, 6, 6), {"groups": 3, "bias": False})):
        t = tconv.init_conv2d(gen, *args, **kw)
        j = jconv.init_conv2d(key, *args, **kw)
        assert {k: tuple(v.shape) for k, v in t.items()} == \
            {k: v.shape for k, v in j.items()}
    t = tnorms.init_batchnorm(7)
    j = jnorms.init_batchnorm(7)
    for name in ("scale", "bias", "mean", "var"):
        assert_allclose(t[name].numpy(), np.asarray(j[name]))


def test_batchnorm_and_fold_match_jax():
    rng = np.random.default_rng(2)
    bn = _bn(rng, 10)
    x = rng.standard_normal((3, 4, 4, 10)).astype(np.float32)
    tbn = params_from_jax(bn, "cpu")
    assert_allclose(tnorms.batchnorm(tbn, torch.from_numpy(x)).numpy(),
                    np.asarray(jnorms.batchnorm(bn, jnp.asarray(x))), **TOL)
    for got, ref in zip(tnorms.bn_fold_scale_bias(tbn),
                        jnorms.bn_fold_scale_bias(bn)):
        assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for bias in (False, True):
        conv = {"w": rng.standard_normal((3, 3, 1, 10)).astype(np.float32)}
        if bias:
            conv["b"] = rng.standard_normal(10).astype(np.float32)
        tw, tb = tq.fold_bn_into_conv(params_from_jax(conv, "cpu"), tbn)
        jw, jb = jq.fold_bn_into_conv(conv, bn)
        assert_allclose(tw.numpy(), np.asarray(jw), **TOL)
        assert_allclose(tb.numpy(), np.asarray(jb), **TOL)


def test_folded_conv_equals_conv_then_bn():
    """The identity the fused kernels rely on: conv(x; w', b') ==
    BN(conv(x; w))."""
    rng = np.random.default_rng(3)
    conv = params_from_jax(
        {"w": rng.standard_normal((3, 3, 1, 8)).astype(np.float32)}, "cpu")
    bn = params_from_jax(_bn(rng, 8), "cpu")
    x = torch.from_numpy(rng.standard_normal((1, 6, 6, 8)).astype(np.float32))
    w, b = tq.fold_bn_into_conv(conv, bn)
    folded = tconv.conv2d({"w": w, "b": b}, x, groups=8)
    assert_allclose(folded.numpy(),
                    tnorms.batchnorm(bn, tconv.conv2d(conv, x,
                                                      groups=8)).numpy(),
                    **TOL)


def test_relu_global_attention_matches_jax():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 37, 4, 16)).astype(np.float32)
               for _ in range(3))
    ref = jra.relu_global_attention(*map(jnp.asarray, (q, k, v)))
    got = tra.relu_global_attention(*map(torch.from_numpy, (q, k, v)))
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("channels,scales,size", [(32, (5,), 7), (48, (3, 5),
                                                                   4)])
def test_msa_matches_jax(channels, scales, size):
    """The reference MSA module: QKV 1x1, per-scale DW + grouped 1x1
    aggregation, ReLU attention per branch, projection + BN."""
    rng = np.random.default_rng(channels)
    jcfg = jra.MSAConfig(channels, 16, scales)
    p = _perturb_bn(_np_tree(jra.init_msa(jax.random.PRNGKey(channels),
                                          jcfg)), rng)
    x = rng.standard_normal((2, size, size, channels)).astype(np.float32)
    ref = jra.msa(p, jnp.asarray(x), jcfg)
    got = tra.msa(params_from_jax(p, "cpu"), torch.from_numpy(x),
                  tra.MSAConfig(channels, 16, scales))
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_init_msa_tree_matches_jax():
    cfg = (32, 16, (5,))
    t = tra.init_msa(torch.Generator().manual_seed(0), tra.MSAConfig(*cfg))
    j = jra.init_msa(jax.random.PRNGKey(0), jra.MSAConfig(*cfg))
    shapes = lambda tree: jax.tree.map(lambda a: tuple(a.shape), tree)
    assert shapes(_np_tree(j)) == jax.tree.map(
        lambda a: tuple(a.shape), {k: v for k, v in t.items()},
        is_leaf=lambda a: isinstance(a, torch.Tensor))
