"""The port's FIX8 kernels and quantization (``repro_torch``) on the CPU.

On the CPU each int8 kernel wrapper takes its plain PyTorch version,
which is held BIT FOR BIT against the JAX package's jnp oracle on the
same numpy-seeded int8 inputs: int32 sums are exact on both sides, and
every fp32 epilogue rounds after each multiply and add in the same
order.  The JAX side runs op by op (``jax.disable_jit``): a jitted JAX
helper lets XLA contract ``a*b+c`` into an FMA and turn a division by a
constant into a reciprocal multiply, which eager torch never does.  The
CUDA kernels are held against these plain versions, also bit for bit,
by ``test_torch_cuda.py`` on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantization as jq
from repro.kernels.dsconv import ref as jdr
from repro.kernels.group_conv import kernel as jgk
from repro.kernels.group_conv import ops as jgo
from repro.kernels.int8_matmul import ref as jir
from repro.kernels.mbconv import ref as jmr
from repro_torch.core import quantization as tq
from repro_torch.core.efficientvit import B1, dsconv, mbconv
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import SuperSite, lower
from repro_torch.kernels.dsconv.kernel import (
    dsconv_fused_int8, dsconv_int8_cluster_smem, dsconv_int8_path,
    dsconv_int8_ranks)
from repro_torch.kernels.dsconv.ops import dsconv_apply_int8
from repro_torch.kernels.group_conv.kernel import (
    group_agg_cluster_smem, group_agg_int8, group_agg_path, group_agg_ranks)
from repro_torch.kernels.group_conv.ops import (
    GroupAggInt8Kernel, block_diag, group_agg_apply_int8)
from repro_torch.kernels.int8_matmul.kernel import (
    EMIT_MAX_RANKS, emit_cells, emit_tiles, gemm_cells, gemm_ctas,
    int8_emit_plan, int8_emit_smem, int8_gemm_plan, int8_gemm_smem,
    int8_matmul)
from repro_torch.kernels.int8_matmul.ops import conv1x1_w8a8
from repro_torch.kernels.mbconv.kernel import (
    int8_fslice, int8_mslice, int8_ranks, mbconv_fused_int8,
    mbconv_fused_int8_emit, mbconv_int8_cluster_smem, mbconv_int8_path)
from repro_torch.kernels.mbconv.ops import mbconv_apply_int8
from repro_torch.kernels.registry import (
    N_SM, SMEM_2_PER_SM, SMEM_LIMIT, get_kernel)
from repro_torch.kernels.relu_attn.kernel import relu_attn_plan
from repro_torch.kernels.supersite.ops import int8_smem_bytes


def _eager(fn, *args, **kw):
    """A JAX function run op by op, its result(s) as numpy."""
    with jax.disable_jit():
        out = fn(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                   for a in args), **kw)
    return jax.tree.map(np.asarray, out)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _equal(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.dtype == want.dtype and got.shape == want.shape
    n = int(np.sum(got != want))
    assert n == 0, f"{n} of {want.size} elements differ"


def _i8(rng, *shape):
    return rng.integers(-128, 128, shape, dtype=np.int8)


def _scales(rng, *shape):
    return (rng.uniform(0.5, 1.5, shape) * 1e-2).astype(np.float32)


def _x_scale(rng, kind, B):
    return (_scales(rng) if kind == "tensor"
            else _scales(rng, B))


# ---------------------------------------------------------------------------
# quantization primitives against core/quantization.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, -1, 0])
def test_quantize_tensor_bit_equal(axis):
    x = np.random.default_rng(1).standard_normal((3, 3, 8, 24)).astype(
        np.float32)
    q, s = tq.quantize_tensor(torch.from_numpy(x), axis=axis)
    jqv, js = _eager(jq.quantize_tensor, x, axis=axis)
    _equal(q, jqv)
    _equal(s, js)


def test_quantize_act_and_with_scale_bit_equal():
    x = (np.random.default_rng(2).standard_normal((3, 5, 5, 7)) * 3).astype(
        np.float32)
    x[1] = 0.0                                   # the 1e-8 floor
    qt = tq.quantize_act(torch.from_numpy(x), keep_fp=True)
    jqt = _eager(jq.quantize_act, x)
    _equal(qt.q, jqt.q)
    _equal(qt.scale, jqt.scale)
    assert qt.fp is not None
    _equal(tq.quantize_with_scale(torch.from_numpy(x), 0.02),
           _eager(jq.quantize_with_scale, x, 0.02))


@pytest.mark.parametrize("k,stride,groups", [(3, 2, 1), (3, 1, 12), (1, 1, 1),
                                             (5, 1, 12)])
@pytest.mark.parametrize("batch", [1, 2])
def test_conv2d_int8_bit_equal(k, stride, groups, batch):
    rng = np.random.default_rng(k * 10 + stride + groups)
    C, F = 12, 12 if groups > 1 else 20
    x = rng.standard_normal((batch, 10, 10, C)).astype(np.float32)
    w = (rng.standard_normal((k, k, C // groups, F)) * 0.3).astype(
        np.float32)
    qp = {"q": tq.quantize_tensor(torch.from_numpy(w), axis=-1)[0],
          "scale": torch.from_numpy(_scales(rng, F)),
          "bias": torch.from_numpy(rng.standard_normal(F).astype(np.float32))}
    got = tq.conv2d_int8(qp, torch.from_numpy(x), stride=stride,
                         groups=groups)
    want = _eager(jq.conv2d_int8, {k_: v.numpy() for k_, v in qp.items()},
                  x, stride=stride, groups=groups)
    _equal(got, want)


def test_matmul_int8_bit_equal():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 40)).astype(np.float32)
    qw = _i8(rng, 40, 17)
    ws = _scales(rng, 17)
    _equal(tq.matmul_int8(*_t(x, qw, ws)), _eager(jq.matmul_int8, x, qw, ws))


# ---------------------------------------------------------------------------
# each kernel's plain version against its JAX oracle, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,N", [(37, 50, 29), (196, 128, 384),
                                   (98, 512, 256)])
@pytest.mark.parametrize("scale", ["tensor", "row"])
def test_int8_matmul_plain_matches_oracle(M, K, N, scale):
    rng = np.random.default_rng(M + K + N)
    x, w, ws = _i8(rng, M, K), _i8(rng, K, N), _scales(rng, N)
    xs = _scales(rng) if scale == "tensor" else _scales(rng, M)
    want = _eager(jir.int8_matmul_ref, x, w,
                  xs if scale == "tensor" else xs[:, None], ws)
    _equal(int8_matmul(*_t(x, w, xs, ws)), want)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("batch,scale", [(1, "tensor"), (2, "image"),
                                         (2, "tensor")])
def test_dsconv_int8_plain_matches_oracle(stride, batch, scale):
    rng = np.random.default_rng(10 * stride + batch)
    C, F = 16, 24
    args = (_i8(rng, batch, 12, 12, C), _x_scale(rng, scale, batch),
            _i8(rng, 3, 3, C), _scales(rng, C),
            rng.standard_normal(C).astype(np.float32), _i8(rng, C, F),
            _scales(rng, F), rng.standard_normal(F).astype(np.float32))
    want = _eager(jdr.dsconv_int8_ref, *args, stride=stride)
    _equal(dsconv_fused_int8(*_t(*args), stride=stride), want)


def _mbconv_args(rng, batch, H, C, M, F, scale):
    return (_i8(rng, batch, H, H, C), _x_scale(rng, scale, batch),
            _i8(rng, C, M), _scales(rng, M) * 0.2,
            rng.standard_normal(M).astype(np.float32), _i8(rng, 3, 3, M),
            _scales(rng, M), rng.standard_normal(M).astype(np.float32),
            _i8(rng, M, F), _scales(rng, F),
            rng.standard_normal(F).astype(np.float32))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("batch,scale", [(1, "tensor"), (2, "image")])
def test_mbconv_int8_plain_matches_oracle(stride, batch, scale):
    rng = np.random.default_rng(20 * stride + batch)
    args = _mbconv_args(rng, batch, 10, 8, 32, 12, scale)
    want = _eager(jmr.mbconv_int8_ref, *args, stride=stride)
    _equal(mbconv_fused_int8(*_t(*args), stride=stride), want)
    # the emitting variant: the same output, quantized per image
    q, s, out = mbconv_fused_int8_emit(*_t(*args), stride=stride)
    _equal(out, want)
    jq_, js = zip(*[_eager(jq.quantize_tensor, w) for w in want])
    _equal(q, np.stack(jq_))
    _equal(s, np.stack(js))


@pytest.mark.parametrize("H,heads,batch,scale", [(6, 2, 1, "tensor"),
                                                 (7, 4, 2, "image")])
def test_group_agg_int8_plain_matches_oracle(H, heads, batch, scale):
    rng = np.random.default_rng(H * heads)
    C, d = 3 * heads * 16, 16
    pw = _i8(rng, 1, 1, d, C)
    dense = _eager(jgo._block_diag, pw)
    _equal(block_diag(torch.from_numpy(pw)), dense)
    args = (_i8(rng, batch, H, H, C), _x_scale(rng, scale, batch),
            _i8(rng, 5, 5, C), _scales(rng, C),
            rng.standard_normal(C).astype(np.float32))
    tail = (_scales(rng, C), rng.standard_normal(C).astype(np.float32))
    want = _eager(jgk.group_agg_int8_ref, *args, dense, *tail)
    _equal(group_agg_int8(*_t(*args, pw[0, 0], *tail)), want)


# ---------------------------------------------------------------------------
# the param-tree wrappers against the reference FIX8 blocks
# ---------------------------------------------------------------------------

def _qconv(rng, k, c_in, c_out, groups=1):
    w = rng.standard_normal((k, k, c_in // groups, c_out)) * (
        k * k * c_in // groups) ** -0.5
    return {"qconv": {
        "q": tq.quantize_tensor(torch.from_numpy(w.astype(np.float32)),
                                axis=-1)[0],
        "scale": torch.from_numpy(_scales(rng, c_out) * 5),
        "bias": torch.from_numpy(
            (0.1 * rng.standard_normal(c_out)).astype(np.float32))}}


@pytest.mark.parametrize("stride,batch", [(1, 1), (2, 2)])
def test_mbconv_apply_int8_equals_reference_block(stride, batch):
    """Same arithmetic as the ``conv2d_int8`` chain of the reference
    ``mbconv``, so equal bit for bit at any batch (per-image scales)."""
    rng = np.random.default_rng(stride)
    p = {"pw1": _qconv(rng, 1, 8, 32), "dw": _qconv(rng, 3, 32, 32, 32),
         "pw2": _qconv(rng, 1, 32, 12)}
    x = torch.from_numpy(rng.standard_normal((batch, 8, 8, 8)).astype(
        np.float32))
    ref = mbconv(p, x, stride=stride)
    _equal(mbconv_apply_int8(p, x, stride=stride), ref.numpy())
    from repro_torch.core.program import Epilogue
    qt = mbconv_apply_int8(p, tq.quantize_act(x), stride=stride,
                           epilogue=Epilogue("int8", "dynamic", "keep-fp"))
    want = tq.quantize_act(ref)
    _equal(qt.q, want.q.numpy())
    _equal(qt.scale, want.scale.numpy())
    _equal(qt.fp, ref.numpy())


def test_dsconv_and_group_agg_apply_equal_reference_blocks():
    rng = np.random.default_rng(4)
    p = {"dw": _qconv(rng, 3, 16, 16, 16), "pw": _qconv(rng, 1, 16, 16)}
    x = torch.from_numpy(rng.standard_normal((2, 9, 9, 16)).astype(
        np.float32))
    _equal(dsconv_apply_int8(p, x), dsconv(p, x).numpy())
    C = 96
    agg = {"dw": _qconv(rng, 5, C, C, C), "pw": _qconv(rng, 1, C, C, 6)}
    qkv = torch.from_numpy(rng.standard_normal((2, 7, 7, C)).astype(
        np.float32))
    _equal(group_agg_apply_int8(agg, qkv),
           GroupAggInt8Kernel().ref(agg, qkv, None).numpy())


def test_conv1x1_w8a8_against_conv2d_int8():
    """The GEMM route of the MSA projections: int8 codes and int32 sums
    identical to ``conv2d_int8``; only the dequant order differs
    ((acc * xs) * ws against acc * (xs * ws)), by at most an ulp."""
    rng = np.random.default_rng(5)
    qp = _qconv(rng, 1, 32, 48)["qconv"]
    x = torch.from_numpy(rng.standard_normal((2, 5, 5, 32)).astype(
        np.float32))
    got = conv1x1_w8a8(qp, x)
    ref = tq.conv2d_int8(qp, x)
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=2.4e-7, atol=1e-6)
    _equal(conv1x1_w8a8(qp, tq.quantize_act(x)), got.numpy())


@pytest.mark.parametrize("image_size", [192, 224, 256, 384])
def test_int8_fit_model_fits_every_b1_site(image_size):
    """Every B1 int8 site fits one CTA's shared memory at 192/224/256/384
    px and batch 1/2/4/8, as JAX's VMEM model fits every site, and so
    does every FIX8 chain the default plan groups.  An MBConv site on the
    cluster path has a legal rank count whose slices cover M, and the fit
    model reads the path mirror; an MSA site's fit is the largest of its
    attention core, its two projection GEMMs' plans and its aggregation
    branch's cluster path, and the group-agg kind reads the same path."""
    for batch in (1, 2, 4, 8):
        program = lower(B1, batch=batch, image_size=image_size)
        for site in program.fusible():
            impl = get_kernel(site.kind, "int8")
            smem = impl.smem_bytes(site, impl.tune(site))
            assert smem <= SMEM_LIMIT
            if site.kind == "msa":
                b, h, w, c = site.in_shape
                d, heads = site.attrs["head_dim"], site.attrs["heads"]
                qkv = int8_gemm_plan(b * h * w, 3 * heads * d, c)
                proj = int8_gemm_plan(b * h * w, site.out_shape[-1],
                                      site.attrs["n_branches"] * heads * d)
                agg = group_agg_path(h, w, 3 * heads * d, d, 5)
                assert agg["path"] == "cluster"
                assert smem == max(
                    relu_attn_plan(h * w, d,
                                   impl.tune(site)["block_n"])["smem"],
                    qkv["smem"], proj["smem"], agg["smem"])
                branch = dataclasses.replace(
                    site, kind="group_agg", in_shape=(b, h, w, 3 * heads * d),
                    out_shape=(b, h, w, 3 * heads * d))
                assert get_kernel("group_agg", "int8").smem_bytes(
                    branch, {}) == agg["smem"]
            if site.kind != "mbconv":
                continue
            b, h, w, c = site.in_shape
            m, f = site.attrs["mid"], site.out_shape[-1]
            path = mbconv_int8_path(h, w, c, m, f, site.stride, b)
            assert smem == path["smem"]
            if path["path"] == "cluster":
                r = path["ranks"]
                assert r in int8_ranks(m)
                assert int8_mslice(m, r) * r >= m
                assert int8_mslice(m, r) * (r - 1) < m
                assert int8_fslice(f, r) * r >= f
                assert path["smem"] == mbconv_int8_cluster_smem(
                    h, w, c, m, f, site.stride, r)
        for names in (("S1.mb0", "S1.mb1"),
                      ("S2.mb0", "S2.mb1", "S2.mb2")):
            assert int8_smem_bytes(SuperSite.of(program, names)) \
                <= SMEM_LIMIT


def _msa_gemms(image_size, batch):
    """(M, K, N) of the QKV and output projection GEMMs of every B1 MSA
    site at ``image_size`` and ``batch``."""
    out = set()
    for site in lower(B1, batch=batch, image_size=image_size).fusible():
        if site.kind == "msa":
            b, h, w, c = site.in_shape
            total = site.attrs["heads"] * site.attrs["head_dim"]
            out.add((b * h * w, c, 3 * total))
            out.add((b * h * w, site.attrs["n_branches"] * total,
                     site.out_shape[-1]))
    return sorted(out)


@pytest.mark.parametrize("image_size", [192, 224, 256, 384])
def test_int8_gemm_plan_fills_the_card(image_size):
    """At every MSA projection of B1 (192-384 px, batch 1/2/4/8) the GEMM
    plan stages K whole (one chunk: K <= 512) and its grid keeps at least half the SMs busy wherever the output alone
    has that many 16 x 32 tiles (a full card's worth did not pay on the
    H100: chip_smoke.py's [int8_matmul sweep]); its shared memory is the
    mirror's and fits a CTA.  Every legal cell fits as well."""
    for batch in (1, 2, 4, 8):
        for M, K, N in _msa_gemms(image_size, batch):
            plan = int8_gemm_plan(M, N, K)
            cell = (plan["bm"], plan["bn"])
            cells = gemm_cells(M, N, K)
            assert cell in cells and K <= 512
            if -(-M // 16) * -(-N // 32) >= N_SM // 2:
                assert gemm_ctas(M, N, *cell) >= N_SM // 2
            assert plan["smem"] == int8_gemm_smem(K, *cell) <= SMEM_LIMIT
            assert all(int8_gemm_smem(K, *c) <= SMEM_LIMIT for c in cells)


@pytest.mark.parametrize("M,K,N", [(37, 50, 29), (5, 1000, 8),
                                   (64, 448, 64), (1, 64, 1), (37, 30000, 29),
                                   (4096, 25000, 4096)])
def test_int8_gemm_smem_and_cells_at_any_k(M, K, N):
    """The shared memory of each cell on ragged and long K: one stage of
    K whole up to 512 bytes, else a two-stage ring of 512-byte chunks;
    per stage the A panel at a pitch of 64 (mod 128) and the weights' raw
    rows, then the transposed B panel, the int32 tile [bm][bn + 8] and
    the tile's scales.  Every K has a legal cell, the 16 x 32 tile among
    them, and a plan within ``SMEM_LIMIT``."""
    kc = min(-(-K // 64) * 64, 512)
    pitch = kc if kc % 128 else kc + 64
    stages = 1 if K <= 512 else 2
    cells = gemm_cells(M, N, K)
    assert (16, 32) in cells
    for bm, bn in cells:
        assert int8_gemm_smem(K, bm, bn) == stages * (bm * pitch + kc * bn) \
            + bn * pitch + 4 * bm * (bn + 8) + 4 * (bm + bn) <= SMEM_LIMIT
    plan = int8_gemm_plan(M, N, K)
    assert (plan["bm"], plan["bn"]) in cells
    assert plan["smem"] == int8_gemm_smem(K, plan["bm"], plan["bn"])


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_emit_plan_takes_the_cluster(batch):
    """The library's 24 ``int8_matmul_emit`` cases (the four MSA
    projections of B1@224, 196 or 49 rows an image, batch 1 and 8; keep-fp
    and the scale's form do not enter the plan) take the cluster path: a
    group's tiles, at most 16, cover its rows and columns, every tile
    holds rows and columns, and the CTA's shared memory is the mirror's
    and fits."""
    for rows, K, N in ((196, 128, 384), (196, 256, 128), (49, 256, 768),
                       (49, 512, 256)):
        plan = int8_emit_plan(batch * rows, N, K, rows)
        bm, bn = plan["bm"], plan["bn"]
        assert plan["path"] == "cluster" and (bm, bn) in emit_cells(rows, N,
                                                                    K)
        assert plan["ranks"] == plan["tiles"] == emit_tiles(rows, N, bm, bn)
        assert 1 <= plan["ranks"] <= EMIT_MAX_RANKS
        assert bm % 16 == 0 and bn % 16 == 0
        assert (-(-rows // bm) - 1) * bm < rows <= -(-rows // bm) * bm
        assert (-(-N // bn) - 1) * bn < N <= -(-N // bn) * bn
        assert plan["smem"] == int8_emit_smem(K, bm, bn) <= SMEM_LIMIT
        assert plan == int8_emit_plan(batch * rows, N, K, rows)


@pytest.mark.parametrize("rows,K,N", [(4096, 128, 256), (1600, 128, 384),
                                      (2304, 512, 256)])
def test_int8_emit_plan_falls_back_past_the_cluster(rows, K, N):
    """Where no split of a group into at most 16 tiles fits a CTA's shared
    memory (large images), the plan takes the plain grid with
    ``int8_gemm_plan``'s tile, which fits; ranks 0."""
    assert not emit_cells(rows, N, K)
    for bm in range(16, -(-rows // 16) * 16 + 1, 16):
        for bn in range(16, -(-N // 16) * 16 + 1, 16):
            if emit_tiles(rows, N, bm, bn) <= EMIT_MAX_RANKS:
                assert int8_emit_smem(K, bm, bn) > SMEM_LIMIT
    plan = int8_emit_plan(2 * rows, N, K, rows)
    gemm = int8_gemm_plan(2 * rows, N, K)
    assert plan["path"] == "grid" and plan["ranks"] == 0
    assert (plan["bm"], plan["bn"]) == (gemm["bm"], gemm["bn"])
    assert plan["tiles"] == emit_tiles(rows, N, plan["bm"], plan["bn"])
    assert plan["smem"] == int8_emit_smem(K, plan["bm"], plan["bn"]) \
        <= SMEM_LIMIT


@pytest.mark.parametrize("K,bm,bn", [(128, 112, 48), (512, 32, 32),
                                     (3001, 16, 16), (50, 48, 32)])
def test_int8_emit_smem_formula(K, bm, bn):
    """The mirror of ``em_layout`` (``csrc/int8_matmul.cu``) against a
    hand count: the GEMM tile's regions (per stage the A panel at a
    pitch of 64 (mod 128) and the weights' raw rows, the transposed B
    panel, the int32 sums [bm][bn + 8], the row and column scales), then
    the bias [bn] and 64 reduction words."""
    kc = min(-(-K // 64) * 64, 512)
    pitch = kc if kc % 128 else kc + 64
    stages = 1 if K <= 512 else 2
    want = stages * (bm * pitch + kc * bn) + bn * pitch \
        + 4 * bm * (bn + 8) + 4 * (bm + bn) + 4 * bn + 256
    assert int8_emit_smem(K, bm, bn) == want


@pytest.mark.parametrize("image_size", [192, 224, 256, 288, 320, 384])
def test_group_agg_path_takes_the_cluster(image_size):
    """Every B1 aggregation branch at 192-384 px takes the cluster kernel
    (the rule reads the map's shape, not the batch): its ranks hold whole
    groups of 16 channels (ranks x groups per rank x 16 = C) and one
    rank's CTA leaves room for two a SM.  Fewer ranks only give each a
    larger slice."""
    for site in lower(B1, image_size=image_size).fusible():
        if site.kind != "msa":
            continue
        _, h, w, _ = site.in_shape
        d = site.attrs["head_dim"]
        C = 3 * site.attrs["heads"] * d
        path = group_agg_path(h, w, C, d)
        r = path["ranks"]
        assert path["path"] == "cluster" and r == max(group_agg_ranks(C, d))
        assert r * (C // d // r) * d == C
        assert path["smem"] == group_agg_cluster_smem(h, w, C, d, 5, r)
        assert path["smem"] <= SMEM_2_PER_SM
        assert all(group_agg_cluster_smem(h, w, C, d, 5, q)
                   >= path["smem"] for q in group_agg_ranks(C, d))


def test_group_agg_path_rule_edges():
    """A map too large for any cluster keeps the two launches (S3 of B1
    at 640 px), and so does a group size that is not a multiple of 16;
    the rank counts divide the groups."""
    assert group_agg_path(40, 40, 384, 16)["path"] == "two-launch"
    assert group_agg_path(36, 36, 384, 16)["path"] == "cluster"
    assert group_agg_path(7, 7, 96, 8)["path"] == "two-launch"
    assert group_agg_ranks(384, 16) == (1, 2, 3, 4, 6, 8, 12)
    assert group_agg_ranks(768, 16) == (1, 2, 3, 4, 6, 8, 12, 16)
    assert group_agg_ranks(96, 16) == (1, 2, 3, 6)
    assert group_agg_ranks(96, 8) == ()


@pytest.mark.parametrize("image_size", [192, 224, 256, 288, 320, 384])
def test_dsconv_int8_path_takes_the_cluster(image_size):
    """stem.ds0 of B1 at 192-384 px (any batch: the rule reads the map's
    shape) takes the cluster kernel at 16 ranks, whose bands split the
    image's rows evenly, one rank's CTA within ``SMEM_LIMIT``; the
    site's fit reads the path."""
    for batch in (1, 8):
        for site in lower(B1, batch=batch, image_size=image_size).fusible():
            if site.kind != "dsconv":
                continue
            _, h, w, c = site.in_shape
            f, s = site.out_shape[-1], site.stride
            path = dsconv_int8_path(h, w, c, f, s)
            assert path == {"path": "cluster", "ranks": 16,
                            "smem": dsconv_int8_cluster_smem(h, w, c, f, s,
                                                             16)}
            assert (h // s) % 16 == 0 and path["smem"] <= SMEM_LIMIT
            assert get_kernel("dsconv", "int8").smem_bytes(site, {}) \
                == path["smem"]


def test_dsconv_int8_path_rule_edges():
    """A map whose band fits no CTA (stem.ds0 at 640 px) keeps the
    passes, and so do channel counts the cluster kernel does not take (C
    not a multiple of 16, F not of 8); ranks never outnumber output
    rows, and a rank count whose CTA does not fit is not legal."""
    assert dsconv_int8_path(320, 320, 16, 16, 1)["path"] == "passes"
    assert dsconv_int8_path(12, 12, 8, 16, 1)["path"] == "passes"
    assert dsconv_int8_path(12, 12, 16, 12, 1)["path"] == "passes"
    assert dsconv_int8_ranks(9, 13, 16, 8, 1) == tuple(range(1, 10))
    assert dsconv_int8_path(9, 13, 16, 8, 1)["ranks"] == 9
    assert dsconv_int8_ranks(12, 12, 32, 32, 2) == tuple(range(1, 7))
    assert dsconv_int8_ranks(112, 112, 16, 16, 1) == tuple(range(5, 17))


def test_dsconv_int8_cluster_smem_formula():
    """The mirror of ``ds_layout`` (``csrc/dsconv_int8.cu``) in bytes:
    the input rows with their halo and zero end pixels, or the codes if
    larger, then the fp32 DW band, the raw and transposed 1x1 weights,
    the taps, four scale and bias arrays and 64 reduction words."""
    # stem.ds0 at 224 px, 16 ranks: bands of 7 rows, 9 input rows of 114
    # pixels x 16 bytes; codes of 784 pixels at a pitch of 16
    assert dsconv_int8_cluster_smem(112, 112, 16, 16, 1, 16) == (
        9 * 114 * 16 + 4 * 784 * 16 + 256 + 16 * 16 + 144 + 8 * 32 + 256)
    # C = 32 (a pitch of 48), stride 2, 10 ranks: bands of 3 rows of 28
    # pixels (the last rank 1 row); 7 input rows of 58 pixels x 32 bytes
    # outgrow the codes (84 pixels, padded to 96, x 48)
    assert dsconv_int8_cluster_smem(56, 56, 32, 32, 2, 10) == (
        max(7 * 58 * 32, 96 * 48) + 4 * 84 * 32 + 1024 + 32 * 48 + 288
        + 8 * 64 + 256)


@pytest.mark.parametrize("H,C,stride,budget", [
    (112, 16, 1, SMEM_LIMIT // 2), (56, 32, 2, SMEM_LIMIT // 2),
    (96, 16, 1, SMEM_LIMIT), (192, 16, 1, SMEM_LIMIT)])
def test_dsconv_int8_emit_path_follows_the_rule(H, C, stride, budget):
    """The emitting DSConv's path is ``dsconv_int8_path``'s (the
    library's two shapes, and stem.ds0 at 192 and 384 px): the cluster at
    the same rank count, its emitting layout 256 bytes (64 reduction
    words) over the plain form where F <= C, within half of
    ``SMEM_LIMIT`` (two CTAs an SM) at the library's shapes."""
    plain = dsconv_int8_path(H, H, C, C, stride)
    emit = dsconv_int8_path(H, H, C, C, stride, emit=True)
    assert emit["path"] == plain["path"] == "cluster"
    assert emit["ranks"] == plain["ranks"] == 16
    assert emit["smem"] == dsconv_int8_cluster_smem(H, H, C, C, stride, 16,
                                                    emit=True)
    assert emit["smem"] == plain["smem"] + 256 <= budget
    assert dsconv_int8_ranks(H, H, C, C, stride, emit=True) \
        == dsconv_int8_ranks(H, H, C, C, stride)


def test_dsconv_int8_emit_smem_formula():
    """The emitting form of ``ds_layout``: the fp32 band region holds
    max(C, F) floats a pixel (the band's outputs), and 128 reduction
    words; C = 8 takes the passes, emitting or not."""
    # C = 16 -> F = 48 at 12 x 12, 4 ranks: bands of 3 rows of 12 pixels;
    # 5 input rows of 14 pixels x 16 bytes outgrow the codes (36 pixels,
    # padded to 48, at a pitch of 16); the outputs 36 x 48 floats
    assert dsconv_int8_cluster_smem(12, 12, 16, 48, 1, 4, emit=True) == (
        max(5 * 14 * 16, 48 * 16) + 4 * 36 * 48 + 16 * 48 + 48 * 16 + 144
        + 8 * 64 + 512)
    assert dsconv_int8_path(12, 12, 8, 8, 1, emit=True)["path"] == "passes"


def test_served_int8_mbconv_sites_take_the_cluster_path():
    """At B1@224, batch 1, 2, 4 and 8, the nine MBConv sites the FIX8 plan
    launches one at a time (S3/S4's seven evit blocks and the two
    downsamplers) each take one cluster launch of 16 ranks, two CTAs a
    SM; the chain members S1.mb* and S2.mb0 do not fit a cluster."""
    for batch in (1, 2, 4, 8):
        program = lower(B1, batch=batch)
        grouped = {"S1.mb0", "S1.mb1", "S2.mb0", "S2.mb1", "S2.mb2"}
        served = [s for s in program.fusible()
                  if s.kind == "mbconv" and s.name not in grouped]
        assert len(served) == 9
        for site in served:
            _, h, w, c = site.in_shape
            path = mbconv_int8_path(h, w, c, site.attrs["mid"],
                                    site.out_shape[-1], site.stride, batch)
            assert path["path"] == "cluster" and path["ranks"] == 16, \
                site.name
            assert path["smem"] <= SMEM_2_PER_SM
        for name in ("S1.mb0", "S1.mb1", "S2.mb0"):
            site = program.site(name)
            _, h, w, c = site.in_shape
            assert mbconv_int8_path(h, w, c, site.attrs["mid"],
                                    site.out_shape[-1], site.stride,
                                    batch)["path"] == "passes"


def test_int8_plan_fuses_a_quantized_smoke_tree():
    from repro_torch.core.efficientvit import B1_SMOKE, init_efficientvit
    params = tq.quantize_efficientvit(init_efficientvit(
        torch.Generator().manual_seed(0), B1_SMOKE, device="cpu"))
    plan = plan_program(lower(B1_SMOKE), params)
    assert all(d.fused and d.precision == "int8"
               for d in plan.decisions.values())
    forced = plan_program(lower(B1_SMOKE), params, precision="fp")
    assert {d.reason for d in forced.decisions.values()} == {"quantized",
                                                             "ok"}
