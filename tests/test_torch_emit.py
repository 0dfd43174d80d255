"""The port's FIX8 emitting epilogues (``repro_torch``) on the CPU.

An int8 ``Epilogue`` given to a registered impl with ``emits_q`` makes
it return a ``QTensor`` (the registry's contract).  Each emitting op is
held BIT FOR BIT against the JAX package on numpy-seeded inputs, JAX run
op by op (``jax.disable_jit``, R5):

- ``dsconv_apply_int8(epilogue=)``: codes, scales and the kept fp map
  equal JAX's ``quantize_act`` of JAX's jnp oracle ``dsconv_int8_ref``.
  JAX's own interpret-mode ``dsconv_fused_int8`` runs its body compiled,
  and XLA contracts the dequant ``acc * s + b`` into FMAs, so its fp32
  output is not the oracle's to the bit (R5).
- ``conv1x1_w8a8(epilogue=)``, dynamic and static ``x_scale``: equal to
  JAX's ``quantize_act`` of JAX's non-emitting ``conv1x1_w8a8``.  JAX's
  emitting op is not the gate: its interpret-mode GEMM contracts
  ``(acc * xs) * ws + b`` into an FMA (R5).
- The MSA int8 impl: equal to its own non-emitting output quantized per
  image (JAX's MSA uses another attention core, R6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.dsconv import ref as jdr
from repro.kernels.int8_matmul import ops as jio
from repro_torch.core import quantization as tq
from repro_torch.core.efficientvit import (
    EfficientViTConfig, init_efficientvit)
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import Epilogue, SuperSite, lower, params_at
from repro_torch.kernels import registry
from repro_torch.kernels.dsconv.kernel import (
    dsconv_fused_int8, dsconv_fused_int8_emit)
from repro_torch.kernels.dsconv.ops import dsconv_apply_int8
from repro_torch.kernels.int8_matmul.kernel import (
    int8_matmul, int8_matmul_emit)
from repro_torch.kernels.int8_matmul.ops import conv1x1_w8a8, linear_w8a8

EMITTING_KINDS = ("dsconv", "mbconv", "msa", "supersite")
# B1_SMOKE's widths with depths that form super-site groups
DEEP = EfficientViTConfig(name="ss-smoke", widths=(8, 16, 24, 32, 48),
                          depths=(2, 2, 3, 1, 1), head_widths=(64, 64),
                          num_classes=10, image_size=64)
RESIDUALS = ("none", "keep-fp")


def _eager(fn, *args, **kw):
    """A JAX function run op by op, its result(s) as numpy."""
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args), **kw)
    return jax.tree.map(np.asarray, out)


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    n = int(np.sum(got != want))
    assert n == 0, f"{n} of {want.size} elements differ"


def _qconv(rng, k, c, f, *, depthwise=False):
    shape = (k, k, 1, c) if depthwise else (k, k, c, f)
    return {"q": rng.integers(-127, 128, shape).astype(np.int8),
            "scale": rng.uniform(0.005, 0.05, shape[-1]).astype(np.float32),
            "bias": rng.standard_normal(shape[-1]).astype(np.float32)}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), tree)


# ---------------------------------------------------------------------------
# the registry's contract
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_int8():
    """``DEEP`` quantized by the port, lowered at batch 2, 64 px, with
    the default (grouping) plan."""
    params = init_efficientvit(torch.Generator().manual_seed(0), DEEP, "cpu")
    qparams = tq.quantize_efficientvit(params)
    program = lower(DEEP, batch=2, image_size=64)
    plan = plan_program(program, qparams)
    return program, qparams, plan


def _site_call(kind, program, qparams, plan):
    """(params, site) of the first site of ``kind`` (a super-site: the
    plan's first group)."""
    if kind == "supersite":
        g = next(iter(plan.groups.values()))
        return qparams, SuperSite.of(program, g.members, name=g.name)
    site = program.by_kind(kind)[0]
    return params_at(qparams, site.param_path), site


def test_emitting_impls_are_the_int8_conv_and_msa_kinds():
    registry.get_kernel("dsconv", "int8")     # loads the built-ins
    got = sorted(k for (k, _), impl in registry._REGISTRY.items()
                 if impl.emits_q)
    assert got == sorted(EMITTING_KINDS)


@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("kind", EMITTING_KINDS)
def test_emitting_impl_returns_a_qtensor(smoke_int8, kind, residual):
    """Every registered impl with ``emits_q`` returns a ``QTensor`` for an
    int8 epilogue: int8 codes of the site's output shape, one scale per
    image, the fp map exactly when the residual policy keeps it."""
    program, qparams, plan = smoke_int8
    impl = registry.get_kernel(kind, "int8")
    assert impl.emits_q
    p, site = _site_call(kind, program, qparams, plan)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        site.in_shape).astype(np.float32))
    with torch.inference_mode():
        out = impl.apply(p, x, site, None,
                         epilogue=Epilogue("int8", "dynamic", residual))
    assert isinstance(out, tq.QTensor)
    assert out.q.dtype == torch.int8
    assert tuple(out.q.shape) == tuple(site.out_shape)
    assert tuple(out.scale.shape) == (site.in_shape[0],)
    if residual == "keep-fp":
        assert out.fp is not None and out.fp.shape == out.q.shape
    else:
        assert out.fp is None


# ---------------------------------------------------------------------------
# dsconv_fused_int8_emit through dsconv_apply_int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
def test_dsconv_emit_equals_jax_quantize(stride, batch, residual):
    rng = np.random.default_rng(100 * stride + batch)
    C, F = 8, 24
    p = {"dw": {"qconv": _qconv(rng, 3, C, C, depthwise=True)},
         "pw": {"qconv": _qconv(rng, 1, C, F)}}
    x = rng.standard_normal((batch, 12, 12, C)).astype(np.float32)
    xq = _eager(jq.quantize_act, x)
    qd, qp = p["dw"]["qconv"], p["pw"]["qconv"]
    base = _eager(jdr.dsconv_int8_ref, xq.q, xq.scale, qd["q"][:, :, 0, :],
                  qd["scale"], qd["bias"], qp["q"][0, 0], qp["scale"],
                  qp["bias"], stride=stride)
    want = _eager(jq.quantize_act, base)
    got = dsconv_apply_int8(_torch_tree(p), torch.from_numpy(x),
                            stride=stride,
                            epilogue=Epilogue("int8", "dynamic", residual))
    assert isinstance(got, tq.QTensor)
    _equal(got.q, want.q)
    _equal(got.scale, want.scale)
    if residual == "keep-fp":
        _equal(got.fp, base)
    else:
        assert got.fp is None


def test_dsconv_emit_keep_fp_is_the_plain_output():
    """The emitting kernel's fp map is ``dsconv_fused_int8``'s output, and
    its codes are that output quantized per image (wrapper level)."""
    rng = np.random.default_rng(7)
    B, C, F = 2, 16, 16
    args = [torch.from_numpy(a) for a in (
        rng.integers(-128, 128, (B, 8, 8, C)).astype(np.int8),
        rng.uniform(5e-3, 1.5e-2, B).astype(np.float32),
        rng.integers(-128, 128, (3, 3, C)).astype(np.int8),
        rng.uniform(5e-3, 1.5e-2, C).astype(np.float32),
        rng.standard_normal(C).astype(np.float32),
        rng.integers(-128, 128, (C, F)).astype(np.int8),
        rng.uniform(5e-3, 1.5e-2, F).astype(np.float32),
        rng.standard_normal(F).astype(np.float32))]
    base = dsconv_fused_int8(*args, stride=2)
    q, scales, fp = dsconv_fused_int8_emit(*args, stride=2, keep_fp=True)
    want = tq.quantize_act(base)
    assert torch.equal(fp, base)
    assert torch.equal(q, want.q) and torch.equal(scales, want.scale)
    assert len(dsconv_fused_int8_emit(*args, stride=2)) == 2


# ---------------------------------------------------------------------------
# int8_matmul_emit through conv1x1_w8a8, dynamic and static x_scale
# ---------------------------------------------------------------------------

def _conv1x1_case(seed, B=2, H=6, W=6, C=16, F=32):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return x, _qconv(rng, 1, C, F)


@pytest.mark.parametrize("residual", RESIDUALS)
@pytest.mark.parametrize("x_scale", [None, 0.021])
def test_conv1x1_emit_equals_jax_quantize(x_scale, residual):
    x, qp = _conv1x1_case(11)
    xs = None if x_scale is None else np.float32(x_scale)
    base = _eager(jio.conv1x1_w8a8, qp, x, x_scale=xs)
    want = _eager(jq.quantize_act, base)
    got = conv1x1_w8a8(_torch_tree(qp), torch.from_numpy(x),
                       x_scale=None if xs is None else torch.tensor(xs),
                       epilogue=Epilogue("int8", "dynamic", residual))
    assert isinstance(got, tq.QTensor)
    _equal(got.q, want.q)
    _equal(got.scale, want.scale)
    if residual == "keep-fp":
        _equal(got.fp, base)
    else:
        assert got.fp is None


@pytest.mark.parametrize("x_scale", [None, 0.021])
def test_conv1x1_non_emitting_equals_jax(x_scale):
    x, qp = _conv1x1_case(12)
    xs = None if x_scale is None else np.float32(x_scale)
    want = _eager(jio.conv1x1_w8a8, qp, x, x_scale=xs)
    got = conv1x1_w8a8(_torch_tree(qp), torch.from_numpy(x),
                       x_scale=None if xs is None else torch.tensor(xs))
    _equal(got, want)


def test_conv1x1_emit_takes_a_producers_qtensor():
    x, qp = _conv1x1_case(13)
    xq = _eager(jq.quantize_act, x)
    want = _eager(jq.quantize_act, _eager(
        jio.conv1x1_w8a8, qp, jq.QTensor(jnp.asarray(xq.q),
                                         jnp.asarray(xq.scale))))
    x_qt = tq.QTensor(torch.from_numpy(np.array(xq.q)),
                      torch.from_numpy(np.array(xq.scale)))
    got = conv1x1_w8a8(_torch_tree(qp), x_qt,
                       epilogue=Epilogue("int8", "dynamic", "none"))
    _equal(got.q, want.q)
    _equal(got.scale, want.scale)


@pytest.mark.parametrize("rows,groups", [(49, 3), (196, 1), (5, 4)])
def test_int8_matmul_emit_groups_straddle_tiles(rows, groups):
    """Per-group act-quant equals ``quantize_act`` of the bias-added
    ``int8_matmul`` output per row group, with per-group and per-tensor
    activation scales."""
    rng = np.random.default_rng(rows)
    K, N = 24, 40
    M = rows * groups
    x_q = torch.from_numpy(rng.integers(-128, 128, (M, K)).astype(np.int8))
    w_q = torch.from_numpy(rng.integers(-128, 128, (K, N)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(5e-3, 1.5e-2, N).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    for xs in (torch.from_numpy(rng.uniform(5e-3, 1.5e-2, groups)
                                .astype(np.float32)), torch.tensor(0.01)):
        base = int8_matmul(x_q, w_q, xs.expand(groups).repeat_interleave(
            rows), ws) + b
        want = tq.quantize_act(base.reshape(groups, rows, N))
        q, s, fp = int8_matmul_emit(x_q, w_q, xs, ws, rows_per_group=rows,
                                    bias=b, keep_fp=True)
        assert torch.equal(fp, base)
        assert torch.equal(q, want.q.reshape(M, N))
        assert torch.equal(s, want.scale)


def test_linear_w8a8_static_scale_equals_jax():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((3, 5, 16)).astype(np.float32)
    w_q = rng.integers(-127, 128, (16, 8)).astype(np.int8)
    ws = rng.uniform(5e-3, 5e-2, 8).astype(np.float32)
    xs = _eager(jq.calibrate_act_scale, [x[:1], x[1:]])
    _equal(tq.calibrate_act_scale([torch.from_numpy(x[:1]),
                                   torch.from_numpy(x[1:])]), xs)
    want = _eager(jio.linear_w8a8, x, w_q, ws, x_scale=xs)
    got = linear_w8a8(torch.from_numpy(x), torch.from_numpy(w_q),
                      torch.from_numpy(ws), x_scale=torch.tensor(xs))
    _equal(got, want)


# ---------------------------------------------------------------------------
# the MSA int8 impl's emitting output projection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residual", RESIDUALS)
def test_msa_int8_emit_quantizes_its_own_output(smoke_int8, residual):
    program, qparams, _ = smoke_int8
    impl = registry.get_kernel("msa", "int8")
    site = program.by_kind("msa")[0]
    p = params_at(qparams, site.param_path)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        site.in_shape).astype(np.float32))
    with torch.inference_mode():
        base = impl.apply(p, x, site, None)
        got = impl.apply(p, x, site, None,
                         epilogue=Epilogue("int8", "dynamic", residual))
    want = tq.quantize_act(base)
    assert torch.equal(got.q, want.q) and torch.equal(got.scale, want.scale)
    if residual == "keep-fp":
        assert torch.equal(got.fp, base)
    else:
        assert got.fp is None
