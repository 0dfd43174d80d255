"""The port's three kernels (``repro_torch.kernels``) on the CPU.

On the CPU each wrapper takes its plain PyTorch version, which is held
against the JAX package's ``ref.py`` oracle and its Pallas kernel in
interpret mode, on numpy-seeded inputs (tolerance 1e-5: fp32 on both
sides, summation order differs).  The CUDA kernels themselves are held
against these plain versions on the card by ``test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.core import efficientvit as jevit
from repro.core import relu_attention as jra
from repro.kernels.dsconv import kernel as jdk
from repro.kernels.dsconv import ref as jdr
from repro.kernels.mbconv import kernel as jmk
from repro.kernels.mbconv import ref as jmr
from repro.kernels.relu_attn import kernel as jak
from repro.kernels.relu_attn import ref as jar
from repro_torch.convert import params_from_jax
from repro_torch.core import relu_attention as tra
from repro_torch.core.efficientvit import B1
from repro_torch.core.fusion import decision_shape
from repro_torch.core.program import lower
from repro_torch.kernels.dsconv.kernel import (
    DSF_SM_CTAS, choose_blocks as ds_blocks, dsconv_fused, dsconv_smem_bytes)
from repro_torch.kernels.dsconv.ops import dsconv_apply
from repro_torch.kernels.mbconv.kernel import (
    SPLITS, choose_blocks as mb_blocks, legal_splits, mbconv_fused,
    mbconv_slice, mbconv_smem_bytes)
from repro_torch.kernels.mbconv.ops import mbconv_apply
from repro_torch.kernels.mbconv_fp import BLOCK_M
from repro_torch.kernels.registry import (
    N_SM, SMEM_LIMIT, SMEM_PER_SM, get_kernel)
from repro_torch.kernels.relu_attn.kernel import (
    relu_attn_noncausal, relu_attn_plan, relu_attn_smem_bytes)
from repro_torch.kernels.relu_attn.ops import msa_fused_apply
from repro_torch.kernels.relu_attn.ref import relu_attn_noncausal_ref

TOL = dict(rtol=1e-5, atol=1e-5)


def _bn(rng, n):
    return {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
            "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
            "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
            "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}


def _conv_bn(rng, k, c_in, c_out, groups=1):
    w = rng.standard_normal((k, k, c_in // groups, c_out)) * (
        k * k * c_in // groups) ** -0.5
    return {"conv": {"w": w.astype(np.float32)}, "bn": _bn(rng, c_out)}


def _dsconv_args(rng, B, H, C, F):
    return (rng.standard_normal((B, H, H, C)).astype(np.float32),
            (rng.standard_normal((3, 3, C)) / 3).astype(np.float32),
            rng.standard_normal(C).astype(np.float32),
            (rng.standard_normal((C, F)) * C ** -0.5).astype(np.float32),
            rng.standard_normal(F).astype(np.float32))


def _mbconv_args(rng, B, H, C, M, F):
    return (rng.standard_normal((B, H, H, C)).astype(np.float32),
            (rng.standard_normal((C, M)) * C ** -0.5).astype(np.float32),
            rng.standard_normal(M).astype(np.float32),
            (rng.standard_normal((3, 3, M)) / 3).astype(np.float32),
            rng.standard_normal(M).astype(np.float32),
            (rng.standard_normal((M, F)) * M ** -0.5).astype(np.float32),
            rng.standard_normal(F).astype(np.float32))


def _torch(args):
    return [torch.from_numpy(a) for a in args]


# ---------------------------------------------------------------------------
# plain versions against the JAX oracles and Pallas kernels (interpret)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,C,F", [(1, 8, 8, 8), (2, 6, 16, 24),
                                     (2, 8, 6, 10)])
def test_dsconv_plain_matches_jax(B, H, C, F):
    args = _dsconv_args(np.random.default_rng(H * C), B, H, C, F)
    jargs = [jnp.asarray(a) for a in args]
    got = dsconv_fused(*_torch(args)).numpy()
    assert_allclose(got, np.asarray(jdr.dsconv_ref(*jargs)), **TOL)
    assert_allclose(got, np.asarray(jdk.dsconv_fused(*jargs, interpret=True)),
                    **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_planner_fuses_a_dsconv_of_any_width(stride):
    """A DSConv site of C = 6 -> F = 10 (no multiple of 4): JAX's planner
    fuses it (its kernel takes any C and pads F to its block), and so does
    the port's, whose band kernel stages zero-padded channel quads; the
    port's fused path on the CPU matches JAX's ``dsconv`` within
    1e-5."""
    from repro.core import fusion as jfusion
    from repro.core import program as jprogram
    from repro_torch.core import program as tprogram
    from repro_torch.core.fusion import plan_program
    from repro_torch.kernels.registry import get_kernel
    rng = np.random.default_rng(6)
    C, F, H = 6, 10, 8
    p = {"dw": _conv_bn(rng, 3, C, C, groups=C), "pw": _conv_bn(rng, 1, C, F)}
    shapes = dict(in_shape=(2, H, H, C),
                  out_shape=(2, H // stride, H // stride, F), stride=stride)
    jsite = jprogram.Site("stem.ds0", "dsconv", "stem", ("stem_ds", 0),
                          **shapes)
    tsite = tprogram.Site("stem.ds0", "dsconv", "stem", ("stem_ds", 0),
                          **shapes)
    jplan = jfusion.plan_program(
        jprogram.Program(jevit.B1, 2, H, (jsite,)), {"stem_ds": [p]},
        autotune=False)
    tparams = params_from_jax(p, "cpu")
    tplan = plan_program(tprogram.Program(B1, 2, H, (tsite,)),
                         {"stem_ds": [tparams]})
    jd, td = jplan.get("stem.ds0"), tplan.get("stem.ds0")
    assert jd.fused and td.fused and (jd.reason, td.reason) == ("ok", "ok")
    assert dsconv_smem_bytes(H, C, F, stride, td.blocks["block_rows"]) \
        == dsconv_smem_bytes(H, 8, 12, stride, td.blocks["block_rows"])
    x = rng.standard_normal((2, H, H, C)).astype(np.float32)
    got = get_kernel("dsconv", "fp").apply(tparams, torch.from_numpy(x),
                                           tsite, td)
    ref = jevit.dsconv(p, jnp.asarray(x), stride=stride)
    assert tuple(got.shape) == ref.shape
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_dsconv_stride2_matches_jax_reference_forward():
    """Stride 2 follows the reference dsconv (XLA SAME: offset s - 1),
    not the JAX kernel's ``[::s]`` sampling."""
    rng = np.random.default_rng(7)
    C, F = 8, 12
    p = {"dw": _conv_bn(rng, 3, C, C, groups=C), "pw": _conv_bn(rng, 1, C, F)}
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    ref = jevit.dsconv(p, jnp.asarray(x), stride=2)
    got = dsconv_apply(params_from_jax(p, "cpu"), torch.from_numpy(x),
                       stride=2)
    assert tuple(got.shape) == ref.shape == (2, 4, 4, F)
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,H,C,M,F,stride", [
    (1, 8, 8, 32, 16, 1), (2, 8, 8, 32, 16, 2), (1, 6, 12, 48, 12, 2)])
def test_mbconv_plain_matches_jax(B, H, C, M, F, stride):
    args = _mbconv_args(np.random.default_rng(H * M + stride), B, H, C, M, F)
    jargs = [jnp.asarray(a) for a in args]
    got = mbconv_fused(*_torch(args), stride=stride).numpy()
    assert_allclose(got, np.asarray(jmr.mbconv_ref(*jargs, stride=stride)),
                    **TOL)
    assert_allclose(got, np.asarray(jmk.mbconv_fused(
        *jargs, stride=stride, interpret=True)), **TOL)


@pytest.mark.parametrize("stride", [1, 2])
def test_mbconv_apply_matches_jax_reference_forward(stride):
    """BN folded into all three convs == the reference block."""
    rng = np.random.default_rng(11 + stride)
    C, M, F = 8, 32, 16
    p = {"pw1": _conv_bn(rng, 1, C, M), "dw": _conv_bn(rng, 3, M, M, M),
         "pw2": _conv_bn(rng, 1, M, F)}
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    ref = jevit.mbconv(p, jnp.asarray(x), stride=stride)
    got = mbconv_apply(params_from_jax(p, "cpu"), torch.from_numpy(x),
                       stride=stride)
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def _to_rows(t):
    """(G, N, h, d) -> the JAX kernel's (G*h, N, d) rows."""
    G, N, h, d = t.shape
    return jnp.asarray(np.ascontiguousarray(
        np.transpose(t, (0, 2, 1, 3)).reshape(G * h, N, d)))


@pytest.mark.parametrize("G,N,h,block_n", [(2, 49, 2, 16), (3, 20, 1, 256)])
def test_relu_attn_plain_matches_jax(G, N, h, block_n):
    """A ragged token count (49 over tiles of 16): the port masks the
    tail, the JAX kernel zero-pads it; both are exact."""
    rng = np.random.default_rng(N)
    q, k, v = (rng.standard_normal((G, N, h, 16)).astype(np.float32)
               for _ in range(3))
    got = relu_attn_noncausal(*_torch((q, k, v)), block_n=block_n).numpy()
    rows = np.transpose(got, (0, 2, 1, 3)).reshape(G * h, N, 16)
    jq, jk, jv = _to_rows(q), _to_rows(k), _to_rows(v)
    assert_allclose(rows, np.asarray(jar.relu_attn_noncausal_ref(jq, jk, jv)),
                    **TOL)
    assert_allclose(rows, np.asarray(jak.relu_attn_noncausal(
        jq, jk, jv, block_n=block_n, interpret=True)), **TOL)


def test_relu_attn_takes_strided_qkv_views():
    """The q/k/v split of a stacked QKV tensor reaches the wrapper as
    views, as ``msa_fused_apply`` passes it."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.standard_normal((2, 10, 3, 4, 16)).astype(
        np.float32))
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    assert not q.is_contiguous()
    got = relu_attn_noncausal(q, k, v)
    ref = relu_attn_noncausal_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous())
    assert_allclose(got.numpy(), ref.numpy(), **TOL)


@pytest.mark.parametrize("B,S,N,h,d,block_n", [
    (2, 2, 49, 2, 16, 16), (1, 3, 20, 1, 8, 256), (3, 2, 37, 4, 16, 16)])
def test_relu_attn_out_view_matches_jax(B, S, N, h, d, block_n):
    """``out=`` a strided (branches, images, N, h, d) view of the
    (images, H, W, branches*h*d) map the MSA projection reads: the call
    fills it in place with the values it returns without ``out=``, and
    those rows hold against JAX's oracle and its Pallas kernel in
    interpret mode (ragged N over the token tile included)."""
    rng = np.random.default_rng(N + S)
    t = torch.from_numpy(rng.standard_normal((S * B, N, 3, h, d)).astype(
        np.float32))
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    buf = torch.full((B, N, S * h * d), float("nan"))
    view = buf.view(B, N, S, h, d).permute(2, 0, 1, 3, 4)
    got = relu_attn_noncausal(q, k, v, block_n=block_n, out=view)
    assert got.data_ptr() == buf.data_ptr() and not buf.isnan().any()
    plain = relu_attn_noncausal(q, k, v, block_n=block_n)
    assert torch.equal(view.reshape(plain.shape), plain)
    with pytest.raises(ValueError, match="out must be"):
        relu_attn_noncausal(q, k, v, out=buf.view(N, B, S, h, d))
    rows = np.transpose(plain.numpy(), (0, 2, 1, 3)).reshape(S * B * h, N, d)
    jq, jk, jv = (_to_rows(x.contiguous().numpy()) for x in (q, k, v))
    assert_allclose(rows, np.asarray(jar.relu_attn_noncausal_ref(jq, jk, jv)),
                    **TOL)
    assert_allclose(rows, np.asarray(jak.relu_attn_noncausal(
        jq, jk, jv, block_n=block_n, interpret=True)), **TOL)


def test_relu_attn_plan_reads_the_shape_only():
    """The plan stages a tile of min(N, block_n) tokens for a CTA that
    takes one (g, head) row, from the shape alone, never the batch.  The
    shared memory is the source's layout: Q, K and V tiles at a pitch of
    20 floats (d = 16), then the partial states (16 x 16 + 16 floats),
    one per warp after its shuffles (16)."""
    assert relu_attn_plan(196, 16) == {"tile": 196,
                                       "smem": 4 * (3 * 196 * 20 + 16 * 272)}
    assert relu_attn_plan(49, 16) == {"tile": 49,
                                      "smem": 4 * (3 * 49 * 20 + 16 * 272)}
    assert relu_attn_plan(1000, 16, 64)["tile"] == 64
    # d = 6 stages rows of 8 floats at a pitch of 12; 128 token sets, 8
    # a warp, leave 16 partials
    assert relu_attn_smem_bytes(6, 10) == 4 * (3 * 10 * 12 + 16 * 72)
    # d = 64: 256 tiles, two sets of 256 threads, one tile a thread
    assert relu_attn_smem_bytes(64, 32) == 4 * (3 * 32 * 68 + 2 * 4160)
    # d = 96: 576 tiles outnumber the threads, one set (a thread takes
    # tiles in turn); pitch 100
    assert relu_attn_smem_bytes(96, 32) == 4 * (3 * 32 * 100 + 9312)


def test_msa_fused_apply_matches_jax_msa():
    """All branches x batch x heads in one attention call == the JAX
    reference module."""
    rng = np.random.default_rng(9)
    jcfg = jra.MSAConfig(32, 16, (5,))
    p = jax.tree.map(np.asarray, jra.init_msa(jax.random.PRNGKey(1), jcfg))
    p["proj_bn"] = _bn(rng, 32)
    x = rng.standard_normal((2, 7, 7, 32)).astype(np.float32)
    ref = jra.msa(p, jnp.asarray(x), jcfg)
    tp = params_from_jax(p, "cpu")
    before = relu_attn_noncausal.launches
    got = msa_fused_apply(tp, torch.from_numpy(x), 2, 16, block_n=16)
    assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert_allclose(got.numpy(), tra.msa(tp, torch.from_numpy(x),
                                         tra.MSAConfig(32, 16, (5,))).numpy(),
                    **TOL)
    assert relu_attn_noncausal.launches == before   # no kernel on the CPU


# ---------------------------------------------------------------------------
# wrappers: no silent fallback, counts only real launches
# ---------------------------------------------------------------------------

def test_cpu_path_counts_no_launch():
    rng = np.random.default_rng(0)
    counts = (dsconv_fused.launches, mbconv_fused.launches)
    dsconv_fused(*_torch(_dsconv_args(rng, 1, 4, 8, 8)))
    mbconv_fused(*_torch(_mbconv_args(rng, 1, 4, 8, 16, 8)))
    assert (dsconv_fused.launches, mbconv_fused.launches) == counts


def test_other_devices_raise():
    """Only a CPU tensor takes the plain version; anything else launches
    the kernel or raises."""
    rng = np.random.default_rng(0)
    ds = [t.to("meta") for t in _torch(_dsconv_args(rng, 1, 4, 8, 8))]
    mb = [t.to("meta") for t in _torch(_mbconv_args(rng, 1, 4, 8, 16, 8))]
    qkv = [torch.empty((1, 4, 1, 16), device="meta") for _ in range(3)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        dsconv_fused(*ds)
    with pytest.raises(ValueError, match="cuda or cpu"):
        mbconv_fused(*mb)
    with pytest.raises(ValueError, match="cuda or cpu"):
        relu_attn_noncausal(*qkv)


@pytest.mark.parametrize("res", [192, 224, 256, 384])
@pytest.mark.parametrize("batch", [1, 2, 4, 8])
def test_blocks_fit_shared_memory_on_b1(res, batch):
    """Every B1 site gets blocks whose CTA fits the 227 KB limit, with
    bands, mid-channel slices (one per cluster rank) and chunks that
    cover the site, at a legal cluster size."""
    for site in lower(B1, batch=batch, image_size=res).fusible():
        B, H, W, C, M, F, s = (decision_shape(site) if site.kind != "msa"
                               else (0,) * 7)
        if site.kind == "dsconv":
            b = ds_blocks(site.in_shape, F, s)
            assert set(b) == {"block_rows"}
            assert 1 <= b["block_rows"] <= H // s
            assert dsconv_smem_bytes(W, C, F, s,
                                     b["block_rows"]) <= SMEM_LIMIT
        elif site.kind == "mbconv":
            b = mb_blocks(site.in_shape, M, F, s)
            assert set(b) == {"block_rows", "block_m", "split"}
            assert 1 <= b["block_rows"] <= H // s
            assert mbconv_smem_bytes(W, F, s, b["block_rows"],
                                     b["block_m"]) <= SMEM_LIMIT
            # the cluster's slices cover M, every rank owns channels, and
            # the chunks cover each slice
            sl = mbconv_slice(M, b["split"])
            assert b["split"] in legal_splits(M) and b["split"] in SPLITS
            assert (b["split"] - 1) * sl < M <= b["split"] * sl
            assert b["block_m"] in BLOCK_M
            assert b["block_m"] <= max(16, -(-sl // 16) * 16)


@pytest.mark.parametrize("res", [192, 224, 256, 288, 384, 576])
def test_dsconv_plan_reads_the_shape_only(res):
    """stem.ds0 of B1 at 192-576 px, batch 1-16: the fp32 band height is a
    function of the site's shape (the planner's and the wrapper's pick
    agree, on every call), its CTA fits ``SMEM_LIMIT``, and it is the
    fewest rows whose grid the card holds in one wave at most
    ``DSF_SM_CTAS`` CTAs an SM, where one exists (all of its input in
    flight at once)."""
    impl = get_kernel("dsconv", "fp")
    for batch in range(1, 17):
        (site,) = [s for s in lower(B1, batch=batch, image_size=res)
                   .fusible() if s.kind == "dsconv"]
        B, H, W, C = site.in_shape
        F, s = site.out_shape[-1], site.stride
        plan = ds_blocks(site.in_shape, F, s)
        assert plan == impl.tune(site) == ds_blocks((B, H, W, C), F, s)
        rows = plan["block_rows"]
        smem = dsconv_smem_bytes(W, C, F, s, rows)
        assert impl.smem_bytes(site, plan) == smem <= SMEM_LIMIT
        one_wave = [r for r in range(1, H // s + 1)
                    if dsconv_smem_bytes(W, C, F, s, r) <= SMEM_LIMIT
                    and B * -(-(H // s) // r) <= N_SM * min(
                        DSF_SM_CTAS, SMEM_PER_SM // (
                            dsconv_smem_bytes(W, C, F, s, r) + 1024))]
        if one_wave:
            assert rows == one_wave[0]


@pytest.mark.parametrize("W,C,F,stride,rows,want", [
    # stem.ds0 at 224 px, 2 rows a CTA: 4 input rows of 114 pixels at a
    # pitch of 20 floats, two DW rows of 112, weights 16x16, 9x16 taps,
    # 16 + 16 biases
    (112, 16, 16, 1, 2, 4 * (4 * 114 * 20 + 2 * 112 * 20 + 256 + 144
                             + 16 + 16)),
    # one row a CTA keeps one DW row; C = 8 keeps its pitch; stride 2
    (112, 16, 16, 1, 1, 4 * (3 * 114 * 20 + 112 * 20 + 256 + 144 + 32)),
    (8, 8, 12, 2, 3, 4 * (7 * 10 * 8 + 2 * 4 * 8 + 96 + 72 + 8 + 12))])
def test_dsconv_smem_formula(W, C, F, stride, rows, want):
    """The mirror of ``dsf_layout`` (``csrc/dsconv.cu``) against a hand
    count; the served C = 16 pads a staged pixel to 20 floats."""
    assert dsconv_smem_bytes(W, C, F, stride, rows) == want


@pytest.mark.parametrize("batch", [1, 8])
def test_mbconv_blocks_follow_the_sweep_on_b1(batch):
    """At B1@224 the block model picks what the card's block sweep found
    fastest (``chip_smoke.py``'s [mbconv sweep]): S4 as one band per
    image at batch 8, so PW1 recomputes no halo row, split over a
    cluster of 16; S3 in bands of 2 output rows over 4 or 16 ranks,
    whose 1 CTA per SM at a whole 14x14 map (a 100 KB partial tile)
    left half the card idle."""
    got = {}
    for site in lower(B1, batch=batch).fusible():
        if site.kind == "mbconv":
            B, H, W, C, M, F, s = decision_shape(site)
            got[(H, s)] = mb_blocks(site.in_shape, M, F, s)
    s4, s3 = got[(7, 1)], got[(14, 1)]
    if batch == 8:
        assert s4 == {"block_rows": 7, "block_m": 64, "split": 16}
        assert s3 == {"block_rows": 2, "block_m": 128, "split": 4}
    else:
        assert s4 == {"block_rows": 1, "block_m": 64, "split": 16}
        assert s3 == {"block_rows": 2, "block_m": 32, "split": 16}
    # input rows each image's PW1 computes, over all its bands' windows
    def pw1_rows(H, s, rows):
        ho = H // s
        return sum(min(H, i * s + s - 2 + (min(rows, ho - i) - 1) * s + 3)
                   - max(0, i * s + s - 2) for i in range(0, ho, rows))
    if batch == 8:   # S4 recomputes no halo row; S3's bands do
        assert pw1_rows(7, 1, s4["block_rows"]) == 7
        assert pw1_rows(14, 1, s3["block_rows"]) == 26


def test_mbconv_smem_model_is_the_sources_layout():
    """The Python mirror of ``mb_layout`` at B1@224's S3 shapes, in
    floats: the partial tile [P][F], then max(PW1 staging, DW result),
    then max(mid window, PW2 staging) (``csrc/mbconv.cu``)."""
    # S3 whole map, chunk 32: P = 196, F = 128, window 16 x 16
    assert mbconv_smem_bytes(14, 128, 1, 14, 32) == 4 * (
        196 * 128 + max(3 * (128 * 20 + 16 * 32), 32 * 196)
        + max(16 * 16 * 32, 3 * 16 * 128))
    # S3 bands of 2, chunk 128: P = 28, window 4 x 16; PW2 tiles 128 wide
    assert mbconv_smem_bytes(14, 128, 1, 2, 128) == 4 * (
        28 * 128 + max(3 * (32 * 20 + 16 * 128), 128 * 28)
        + max(4 * 16 * 128, 3 * 16 * 128))
