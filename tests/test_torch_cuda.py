"""The port's CUDA kernels on the card, held against their plain PyTorch
versions; without a card every test here skips.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: the fp32 kernels, max|kernel - plain| <= 1e-4 * max(1,
max|plain|) (both fp32 with TF32 off; they differ in summation order
only, and the SSD scan also in the order of its in-chunk cumsum).  The
int8 kernels: EQUAL, int8 codes and fp32 outputs alike (exact int32
sums, and every fp32 step rounded in the plain version's order).
"""
import ctypes
import time

import numpy as np
import pytest
import torch

from repro_torch.core.efficientvit import (
    B1, B1_SMOKE, B3, EfficientViTConfig, init_efficientvit)
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import SuperSite, execute, lower
from repro_torch.common import device as port_device
from repro_torch.common.errors import ExecutorError, KernelLaunchError
from repro_torch.core.quantization import quantize_act, quantize_efficientvit
from repro_torch.kernels.dsconv.kernel import (
    _dsconv_int8, _dsconv_int8_emit, choose_blocks as ds_blocks,
    dsconv_fused, dsconv_fused_int8, dsconv_fused_int8_emit,
    dsconv_int8_cluster_smem, dsconv_int8_path, dsconv_int8_ranks,
    dsconv_smem_bytes)
from repro_torch.kernels.dsconv.ref import (
    dsconv_int8_emit_ref, dsconv_int8_ref, dsconv_ref)
from repro_torch.kernels.group_conv.kernel import (
    _group_agg, group_agg_cluster_smem, group_agg_int8, group_agg_path,
    group_agg_ranks)
from repro_torch.kernels.group_conv.ref import block_diag, group_agg_int8_ref
from repro_torch.kernels.int8_matmul.kernel import (
    _int8_matmul, _int8_matmul_emit, emit_cells, gemm_cells, int8_emit_plan,
    int8_emit_smem, int8_gemm_smem, int8_matmul, int8_matmul_emit)
from repro_torch.kernels.int8_matmul.ref import (
    int8_matmul_emit_ref, int8_matmul_ref)
from repro_torch.kernels.build import check, library
from repro_torch.kernels.mbconv.kernel import (
    _mbconv_int8, choose_blocks as mb_blocks, int8_mslice, int8_ranks,
    legal_splits, mbconv_fused, mbconv_fused_int8, mbconv_fused_int8_emit,
    mbconv_int8_cluster_smem, mbconv_int8_pass_smem, mbconv_int8_path,
    mbconv_smem_bytes)
from repro_torch.kernels.mbconv.ref import mbconv_int8_ref, mbconv_ref
from repro_torch.kernels.mbconv_fp import BLOCK_M
from repro_torch.kernels.registry import SMEM_LIMIT, kernel_wrappers
from repro_torch.kernels.relu_attn.kernel import (
    _relu_attn, relu_attn_causal, relu_attn_causal_plan,
    relu_attn_causal_smem_bytes, relu_attn_noncausal, relu_attn_plan,
    relu_attn_smem_bytes)
from repro_torch.kernels.relu_attn.ref import (
    relu_attn_causal_chunked, relu_attn_causal_scan, relu_attn_noncausal_ref)
from repro_torch.kernels.ssd.kernel import (
    ssd_chunked, ssd_plan, ssd_smem_bytes)
from repro_torch.kernels.ssd.ref import ssd_chunked_ref, ssd_scan_ref
from repro_torch.kernels.supersite.kernel import (
    supersite_fused, supersite_fused_int8)
from repro_torch.kernels.supersite.ops import (
    choose_blocks, make_fp_geom, make_int8_geom, supersite_smem_bytes)
from repro_torch.kernels.supersite.pack import pack_weights
from repro_torch.kernels.supersite.ref import (
    supersite_int8_ref, supersite_ref)
from repro_torch.serving import executors as port_executors
from repro_torch.serving.executors import ExecutorCache
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.scheduler import (
    ManualClock, MicroBatchScheduler, Request)
from repro_torch.serving.vision import VisionEngine, VisionServeConfig

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True, scope="module")
def autotune_cache(tmp_path_factory):
    """The engines and plans of this file tune into a cache file of their
    own (a cold build sweeps once per shape), not the user's."""
    import os
    from repro_torch.kernels import autotune
    old = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(
        tmp_path_factory.mktemp("autotune") / "at.json")
    autotune.clear_memory_cache()
    yield
    if old is None:
        os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
    else:
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = old
    autotune.clear_memory_cache()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, device, *shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
        np.float32)).to(device)


def _close(got, ref):
    torch.cuda.synchronize()
    scale = max(1.0, ref.abs().max().item())
    assert (got - ref).abs().max().item() <= 1e-4 * scale


# stem.ds0 of B1 at 192-384 px, batch 1 and 8, on the plan's bands
DS_STEM = [(B, px // 2, 16, 16, 1, None) for px in (192, 256, 288, 384)
           for B in (1, 8)] + [(8, 112, 16, 16, 1, None)]


@pytest.mark.parametrize("B,H,C,F,stride,rows", [
    (1, 112, 16, 16, 1, None), (2, 9, 8, 72, 1, 4), (2, 8, 8, 12, 2, 3)]
    + DS_STEM + [(2, 112, 16, 16, 1, 5), (2, 112, 16, 16, 1, 1),
                 (3, 56, 16, 16, 2, None), (1, 10, 12, 20, 1, 3),
                 (2, 6, 8, 520, 1, None), (1, 6, 520, 8, 2, None)])
def test_dsconv_kernel_matches_plain(cuda, B, H, C, F, stride, rows):
    """The served instance (C = F = 16, stride 1) at stem.ds0 of B1,
    192-384 px, on the plan's bands, on a ragged last band (5 rows) and
    on bands of one row; the generic instance at C = 8 over 72 and 12
    outputs, C = 12 over 20, stride 2 (C = 8, and the served C = 16), and
    more channel quads than a CTA has threads (F = 520, C = 520)."""
    rng = np.random.default_rng(H)
    args = (_rand(rng, cuda, B, H, H, C), _rand(rng, cuda, 3, 3, C, scale=.3),
            _rand(rng, cuda, C), _rand(rng, cuda, C, F, scale=C ** -0.5),
            _rand(rng, cuda, F))
    n = dsconv_fused.launches
    got = dsconv_fused(*args, stride=stride, block_rows=rows)
    assert dsconv_fused.launches == n + 1
    _close(got, dsconv_ref(*args, stride=stride))


@pytest.mark.parametrize("B,H,C,F,stride", [
    (2, 28, 6, 10, 1), (2, 28, 6, 10, 2), (1, 14, 3, 7, 1), (2, 9, 5, 16, 1),
    (1, 10, 16, 6, 2), (1, 7, 1, 1, 1)])
def test_dsconv_kernel_any_channel_count(cuda, B, H, C, F, stride):
    """C and F no multiple of 4 (the planner fuses such a site, as JAX's
    does): the pad channels of the staged quads are zeros, the output is
    stored channel by channel; within fp32 rounding of the plain
    version at stride 1 and 2, on the plan's bands and on one-row
    bands."""
    rng = np.random.default_rng(H * C + F)
    args = (_rand(rng, cuda, B, H, H, C), _rand(rng, cuda, 3, 3, C, scale=.3),
            _rand(rng, cuda, C), _rand(rng, cuda, C, F, scale=C ** -0.5),
            _rand(rng, cuda, F))
    ref = dsconv_ref(*args, stride=stride)
    for rows in (None, 1):
        n = dsconv_fused.launches
        got = dsconv_fused(*args, stride=stride, block_rows=rows)
        assert dsconv_fused.launches == n + 1
        _close(got, ref)


def test_dsconv_smem_mirror_matches_the_source(cuda):
    """``dsconv_smem_bytes`` equals the CUDA layout (``dsconv_smem_c``) at
    stem.ds0 of B1 (192-576 px) and the generic shapes, at band heights
    1-16; the plan's band fits at batch 1-16."""
    fn = library("dsconv").dsconv_smem_c
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    for (W, C, F, stride) in [(px // 2, 16, 16, 1)
                              for px in (192, 224, 256, 288, 384, 576)] \
            + [(9, 8, 72, 1), (8, 8, 12, 2), (10, 12, 20, 1), (56, 16, 16, 2),
               (28, 6, 10, 1), (28, 6, 10, 2), (14, 3, 7, 1)]:
        for rows in range(1, 17):
            assert fn(W, C, F, stride, rows) == \
                dsconv_smem_bytes(W, C, F, stride, rows)
        for B in (1, 8, 16):
            r = ds_blocks((B, W, W, C), F, stride)["block_rows"]
            assert dsconv_smem_bytes(W, C, F, stride, r) <= SMEM_LIMIT


def test_dsconv_hswish_is_bit_exact(cuda):
    """``common.cuh``'s ``hswish``, whose r / 6 takes no branch, gives the
    bits of x * (relu6(x + 3) / 6) with the IEEE division at every one of
    the 2^32 fp32 inputs."""
    lib = library("dsconv")
    fn = lib.dsconv_hswish_mismatches
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = torch.zeros(1, dtype=torch.int64, device=cuda)
    check(lib, fn(n.data_ptr(), torch.cuda.current_stream().cuda_stream),
          "hswish_check")
    torch.cuda.synchronize()
    assert n.item() == 0


# every distinct mbconv shape of B1@224: (H, C, M, F, stride)
B1_MBCONV = [(112, 16, 64, 32, 2), (56, 32, 128, 32, 1), (56, 32, 128, 64, 2),
             (28, 64, 256, 64, 1), (28, 64, 256, 128, 2),
             (14, 128, 512, 128, 1), (14, 128, 512, 256, 2),
             (7, 256, 1024, 256, 1)]


def _mbconv_args(rng, device, B, H, C, M, F):
    return (_rand(rng, device, B, H, H, C),
            _rand(rng, device, C, M, scale=C ** -0.5), _rand(rng, device, M),
            _rand(rng, device, 3, 3, M, scale=.3), _rand(rng, device, M),
            _rand(rng, device, M, F, scale=M ** -0.5), _rand(rng, device, F))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,C,M,F,stride", B1_MBCONV)
def test_mbconv_kernel_matches_plain(cuda, batch, H, C, M, F, stride):
    """The planner's blocks, then the same band and chunk at split 1 and
    at the largest legal split; two calls give equal bits (the cluster
    sums its partials in rank order)."""
    args = _mbconv_args(np.random.default_rng(H * M + batch), cuda, batch,
                        H, C, M, F)
    ref = mbconv_ref(*args, stride=stride)
    n = mbconv_fused.launches
    got = mbconv_fused(*args, stride=stride)
    assert mbconv_fused.launches == n + 1
    _close(got, ref)
    assert torch.equal(got, mbconv_fused(*args, stride=stride))
    b = mb_blocks(args[0].shape, M, F, stride)
    for split in sorted({1, max(legal_splits(M))}):
        _close(mbconv_fused(*args, stride=stride, block_rows=b["block_rows"],
                            block_m=b["block_m"], split=split), ref)


@pytest.mark.parametrize("B,H,C,M,F,stride,rows,bm,split", [
    (1, 10, 8, 40, 24, 2, 2, 16, 2), (2, 9, 8, 36, 8, 1, 4, 16, 4),
    (2, 7, 16, 40, 24, 1, 7, 32, 8), (1, 14, 32, 48, 24, 2, 7, 16, 16),
    (2, 9, 12, 44, 20, 1, 9, 64, 1), (1, 9, 12, 42, 22, 1, 4, 32, 2)])
def test_mbconv_kernel_ragged_blocks(cuda, B, H, C, M, F, stride, rows, bm,
                                     split):
    """Ragged splits and edges: M = 40 in slices of 20 and chunks of 16;
    F = 24, 8 and 20 (not a tile width); W = 7 and 9; a ragged band (9
    rows in bands of 4); stride 2; ranks that own no channel (40 over 8
    ranks of 8, 48 over 16 of 4); a cluster of 16; C = 12 and M = 44 (a
    chunk of 44 in a tile of 64); M = 42 and F = 22, whose weight rows
    are not float4-aligned (the 4-byte copies and scalar sums)."""
    args = _mbconv_args(np.random.default_rng(H * M), cuda, B, H, C, M, F)
    got = mbconv_fused(*args, stride=stride, block_rows=rows, block_m=bm,
                       split=split)
    _close(got, mbconv_ref(*args, stride=stride))
    assert torch.equal(got, mbconv_fused(*args, stride=stride,
                                         block_rows=rows, block_m=bm,
                                         split=split))


def test_mbconv_refused_launch_raises(cuda):
    """A launch CUDA refuses raises ``KernelLaunchError`` and leaves no
    error behind: a whole 56-row band at chunk 128 needs more than
    227 KB (the wrapper itself rejects it first, so the C entry point is
    called directly), and a cluster of 32 is beyond the card."""
    args = _mbconv_args(np.random.default_rng(1), cuda, 1, 56, 32, 128, 32)
    out = torch.empty((1, 56, 56, 32), device=cuda)
    lib = library("mbconv")
    fn = lib.mbconv_fused_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in args] + [out.data_ptr()]
    stream = torch.cuda.current_stream().cuda_stream
    assert mbconv_smem_bytes(56, 32, 1, 56, 128) > SMEM_LIMIT
    for rows, bm, split in ((56, 128, 1), (2, 32, 32)):
        status = fn(*ptrs, 1, 56, 56, 32, 128, 32, 1, rows, bm, split,
                    stream)
        with pytest.raises(KernelLaunchError):
            check(lib, status, "mbconv_fused")
    _close(mbconv_fused(*args), mbconv_ref(*args))


def test_mbconv_smem_mirror_matches_the_source(cuda):
    """``mbconv_smem_bytes`` equals the CUDA source's own layout, byte for
    byte, at every B1 site's blocks and every chunk."""
    lib = library("mbconv")
    fn = lib.mbconv_smem_bytes_c
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    for H, C, M, F, stride in B1_MBCONV + [(9, 8, 36, 24, 1)]:
        for rows in range(1, H // stride + 1):
            for bm in BLOCK_M:
                assert fn(H, F, stride, rows, bm) == \
                    mbconv_smem_bytes(H, F, stride, rows, bm)


@pytest.mark.parametrize("G,N,h,block_n", [(16, 196, 8, 256), (4, 49, 16, 16),
                                           (2, 1000, 2, 64)])
def test_relu_attn_kernel_matches_plain(cuda, G, N, h, block_n):
    """Strided q/k/v views of one stacked tensor, ragged token tails."""
    t = _rand(np.random.default_rng(N), cuda, G, N, 3, h, 16)
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    n = relu_attn_noncausal.launches
    got = relu_attn_noncausal(q, k, v, block_n=block_n)
    assert relu_attn_noncausal.launches == n + 1
    _close(got, relu_attn_noncausal_ref(q, k, v))


# the MSA attention of B1@224: (tokens, heads, branches); d = 16
B1_ATTN = [(196, 8, 2), (49, 16, 2)]


def _msa_qkv(rng, device, B, N, h, S, d=16):
    """The stacked QKV of S branches x B images as the MSA passes it:
    strided q/k/v views of one (S*B, N, 3, h, d) tensor."""
    t = _rand(rng, device, S * B, N, 3, h, d)
    return t[:, :, 0], t[:, :, 1], t[:, :, 2]


def _proj_view(buf, B, N, S, h, d):
    """The (S, B, N, h, d) view of a (B, H, W, S*h*d) map: branch s of
    image b in channels [s*h*d, (s+1)*h*d)."""
    return buf.view(B, N, S, h, d).permute(2, 0, 1, 3, 4)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("N,h,S", B1_ATTN)
def test_relu_attn_b1_shapes_with_and_without_out(cuda, batch, N, h, S):
    """Every B1@224 attention shape, batch 1 and 8: the served call
    (written into the projection's (B, H, W, S*T) map through ``out=``)
    and the call that allocates, each one launch, within 1e-4 of the
    plain version with and without ``out=``; equal bits on two calls
    and between the two forms."""
    q, k, v = _msa_qkv(np.random.default_rng(N + batch), cuda, batch, N, h,
                       S)
    ref = relu_attn_noncausal_ref(q, k, v)
    buf = torch.full((batch, N, S * h * 16), float("nan"), device=cuda)
    n = relu_attn_noncausal.launches
    got = relu_attn_noncausal(q, k, v, out=_proj_view(buf, batch, N, S, h,
                                                       16))
    assert relu_attn_noncausal.launches == n + 1
    want = torch.empty_like(buf)
    relu_attn_noncausal_ref(q, k, v, out=_proj_view(want, batch, N, S, h,
                                                     16))
    assert got.data_ptr() == buf.data_ptr()
    _close(buf, want)
    plain = relu_attn_noncausal(q, k, v)
    _close(plain, ref)
    assert torch.equal(plain, relu_attn_noncausal(q, k, v))
    assert torch.equal(buf.view(batch, N, S, h, 16).permute(2, 0, 1, 3, 4)
                       .reshape(plain.shape), plain)


@pytest.mark.parametrize("G,N,h,d,tile", [
    (4, 49, 16, 16, 49), (3, 1000, 2, 16, 64), (2, 37, 3, 12, 16),
    (2, 20, 2, 6, 20), (2, 33, 2, 32, 33), (1, 70, 2, 64, 32),
    (5, 9, 1, 8, 9), (2, 45, 2, 96, 16)])
def test_relu_attn_ragged_tiles_and_head_dims(cuda, G, N, h, d, tile):
    """Ragged token tiles (1000 over 64, 37 over 16, 45 over 16), d = 6
    (4-byte staging), 8, 12, 32, 64 and 96 (one token set: the state's
    tiles outnumber the threads): within 1e-4 of the plain version,
    through ``_relu_attn`` and through the wrapper."""
    t = _rand(np.random.default_rng(N * d), cuda, G, N, 3, h, d)
    q, k, v = t[:, :, 0], t[:, :, 1], t[:, :, 2]
    ref = relu_attn_noncausal_ref(q, k, v)
    _close(_relu_attn(q, k, v, tile, 1e-6, None), ref)
    _close(relu_attn_noncausal(q, k, v, block_n=tile), ref)


@pytest.mark.parametrize("N,h,S", B1_ATTN)
def test_relu_attn_rows_are_batch_invariant(cuda, N, h, S):
    """Row g of a batch-8 call equals row g of a call on that row alone
    and of a batch-1 call bit for bit, at the plan's tile and at a
    smaller one: a row's arithmetic depends on (N, d, tile) only."""
    q, k, v = _msa_qkv(np.random.default_rng(N), cuda, 8, N, h, S)
    eight = relu_attn_noncausal(q, k, v)
    for g in range(q.shape[0]):
        one = relu_attn_noncausal(q[g:g + 1], k[g:g + 1], v[g:g + 1])
        assert torch.equal(one[0], eight[g])
    for tile in (relu_attn_plan(N, 16)["tile"], 32):
        full = _relu_attn(q, k, v, tile, 1e-6, None)
        for g in (0, 5, q.shape[0] - 1):
            one = _relu_attn(q[g:g + 1], k[g:g + 1], v[g:g + 1], tile,
                             1e-6, None)
            assert torch.equal(one[0], full[g])


def test_relu_attn_smem_mirror_matches_the_source(cuda):
    """``relu_attn_smem_bytes`` equals the CUDA layout; the plan's CTA
    fits at the B1 shapes and a tile that fits no CTA is refused."""
    lib = library("relu_attn")
    fn = lib.relu_attn_smem_c
    fn.argtypes = [ctypes.c_int] * 2
    fn.restype = ctypes.c_longlong
    for d in (6, 8, 12, 16, 32, 64, 96):
        for tile in (1, 49, 196, 256):
            assert fn(d, tile) == relu_attn_smem_bytes(d, tile)
    for N in (49, 196):
        assert relu_attn_plan(N, 16)["smem"] <= SMEM_LIMIT
    t = _rand(np.random.default_rng(0), cuda, 1, 1024, 3, 1, 64)
    with pytest.raises(ValueError, match="does not fit"):
        relu_attn_noncausal(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                            block_n=1024)


def test_kernel_wrappers_reject_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    args = [_rand(rng, cuda, 1, 8, 8, 8), _rand(rng, cuda, 8, 16),
            _rand(rng, cuda, 16), _rand(rng, cuda, 3, 3, 16),
            _rand(rng, cuda, 16), _rand(rng, cuda, 16, 8), _rand(rng, cuda, 8)]
    with pytest.raises(ValueError, match="contiguous"):
        mbconv_fused(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError, match="float32"):
        mbconv_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="is on cpu"):
        mbconv_fused(args[0], args[1].cpu(), *args[2:])


def test_planned_forward_on_the_card(cuda):
    """``execute(plan)`` launches one kernel per fused site and matches
    the reference forward on the card; the engine defaults to the card."""
    params = init_efficientvit(torch.Generator().manual_seed(0), B1_SMOKE)
    program = lower(B1_SMOKE, batch=2)
    plan = plan_program(program, params)
    x = _rand(np.random.default_rng(1), cuda, 2, 64, 64, 3)
    kernels = {"dsconv": dsconv_fused, "mbconv": mbconv_fused,
               "msa": relu_attn_noncausal}
    before = {k: f.launches for k, f in kernels.items()}
    with torch.inference_mode():
        got = execute(program, params, x, plan=plan)
        ref = execute(program, params, x)
    for kind, f in kernels.items():
        assert f.launches - before[kind] == len(program.by_kind(kind))
    _close(got, ref)
    engine = VisionEngine(params, B1_SMOKE, VisionServeConfig(microbatch=2))
    assert engine.device.type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    _close(engine.logits(x), ref)


def _check_dispatch_does_not_wait(engine, cuda):
    engine.warmup()
    img = np.random.default_rng(2).standard_normal((64, 64, 3))
    ref = engine.logits(img[None])
    torch.cuda.synchronize()
    sched = engine.scheduler()
    req = Request(0, img)
    torch.cuda._sleep(1_000_000_000)        # ~0.5 s of queued device work
    t0 = time.perf_counter()
    sched.submit(req)
    assert sched.step() == 1
    assert time.perf_counter() - t0 < 0.25
    assert sched.finalize() == 1
    _close(torch.from_numpy(req.logits).to(cuda), ref[0])


def test_dispatch_does_not_wait_on_the_card(cuda):
    """``step()`` copies the batch in and launches it without waiting for
    the work already queued; ``finalize()`` is where the host waits."""
    params = init_efficientvit(torch.Generator().manual_seed(0), B1_SMOKE)
    _check_dispatch_does_not_wait(
        VisionEngine(params, B1_SMOKE, VisionServeConfig(microbatch=1)),
        cuda)


def test_fix8_dispatch_does_not_wait_on_the_card(cuda):
    """The same for the int8 dataflow: no quantize, scale or scratch
    allocation on the FIX8 path waits for the card."""
    params = init_efficientvit(torch.Generator().manual_seed(0), B1_SMOKE)
    _check_dispatch_does_not_wait(
        VisionEngine.quantized(params, B1_SMOKE,
                               VisionServeConfig(microbatch=1)), cuda)


# ---------------------------------------------------------------------------
# FIX8 kernels: equal to their plain versions at the B1@224 shapes
# ---------------------------------------------------------------------------

def _i8(gen, device, *shape):
    return torch.randint(-128, 128, shape, generator=gen,
                         dtype=torch.int8).to(device)


def _sc(gen, device, *shape, base=1e-2):
    return (base * (0.5 + torch.rand(shape, generator=gen))).to(device)


def _bias(gen, device, n):
    return torch.randn(n, generator=gen).to(device)


def _same(got, ref):
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        assert int((g != r).sum()) == 0


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("rows,K,N", [(196, 128, 384), (196, 256, 128),
                                      (49, 256, 768), (49, 512, 256)])
def test_int8_matmul_equals_plain(cuda, batch, rows, K, N):
    g = torch.Generator().manual_seed(rows + K + N)
    args = (_i8(g, cuda, batch * rows, K), _i8(g, cuda, K, N),
            _sc(g, cuda, batch * rows), _sc(g, cuda, N))
    n = int8_matmul.launches
    got = int8_matmul(*args)
    assert int8_matmul.launches == n + 1
    _same((got,), (int8_matmul_ref(*args),))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("rows,K,N", [(196, 128, 384), (196, 256, 128),
                                      (49, 256, 768), (49, 512, 256)])
def test_int8_matmul_every_cell_equals_plain(cuda, batch, rows, K, N):
    """Every legal (bm, bn) of the tensor-core GEMM at the four MSA
    projections of B1@224: EQUAL to the plain version."""
    g = torch.Generator().manual_seed(rows * K + N + batch)
    args = (_i8(g, cuda, batch * rows, K), _i8(g, cuda, K, N),
            _sc(g, cuda, batch * rows), _sc(g, cuda, N))
    ref = int8_matmul_ref(*args)
    for bm, bn in gemm_cells(batch * rows, N, K):
        got = _int8_matmul(*args, {"bm": bm, "bn": bn})
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (bm, bn)


@pytest.mark.parametrize("M,K,N", [(37, 50, 29), (45, 100, 40), (3, 520, 8),
                                   (130, 16, 200), (1, 64, 1),
                                   (37, 3001, 29), (70, 25000, 96)])
def test_int8_matmul_ragged(cuda, M, K, N):
    """Ragged M, N and K through the same kernel at every legal cell: rows
    and columns that fill no tile, K tails that are no multiple of 16 or 4
    (the 4-byte and byte staging), N no multiple of 4 (the scalar
    epilogue), K past one 512-byte chunk (the two-stage ring, a partial
    last chunk, and K far beyond anything served); the served call is one
    launch on the counter."""
    g = torch.Generator().manual_seed(M * K + N)
    args = (_i8(g, cuda, M, K), _i8(g, cuda, K, N), _sc(g, cuda, M),
            _sc(g, cuda, N))
    ref = int8_matmul_ref(*args)
    n = int8_matmul.launches
    _same((int8_matmul(*args),), (ref,))
    assert int8_matmul.launches == n + 1
    for bm, bn in gemm_cells(M, N, K):
        got = _int8_matmul(*args, {"bm": bm, "bn": bn})
        torch.cuda.synchronize()
        assert torch.equal(got, ref), (bm, bn)


def test_int8_matmul_smem_mirror_matches_the_source(cuda):
    """``int8_gemm_smem`` equals the CUDA layout at every cell of the B1
    projection shapes (192-384 px) and ragged K; a refused plan raises
    and leaves no error behind."""
    lib = library("int8_matmul")
    fn = lib.int8_matmul_smem_c
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    shapes = {(37, 50, 29), (3, 520, 8), (70, 25000, 96)}
    for size in (192, 224, 256, 384):
        for site in lower(B1, batch=8, image_size=size).fusible():
            if site.kind == "msa":
                b, h, w, c = site.in_shape
                total = site.attrs["heads"] * site.attrs["head_dim"]
                shapes |= {(b * h * w, c, 3 * total),
                           (b * h * w, 2 * total, c)}
    for M, K, N in sorted(shapes):
        for cell in gemm_cells(M, N, K):
            assert fn(K, *cell) == int8_gemm_smem(K, *cell)
    g = torch.Generator().manual_seed(3)
    args = (_i8(g, cuda, 64, 128), _i8(g, cuda, 128, 64), _sc(g, cuda, 64),
            _sc(g, cuda, 64))
    with pytest.raises(KernelLaunchError):   # no 48-column tile
        _int8_matmul(*args, {"bm": 16, "bn": 48})
    _same((int8_matmul(*args),), (int8_matmul_ref(*args),))


@pytest.mark.parametrize("R,K,N", [(64, 16, 64), (37, 32, 24), (16, 64, 8),
                                   (50, 48, 40)])
def test_int8_mma16816_equals_dp4a(cuda, R, K, N):
    """The m16n8k16 fragment of the grouped 1x1 (``mma16816``, K-contiguous
    rows and weights as the cluster kernel stages them) against
    ``__dp4a`` sums of the same panels and exact int64 sums on the host."""
    g = torch.Generator().manual_seed(R * K + N)
    A, W = _i8(g, cuda, R, K), _i8(g, cuda, K, N)
    out = torch.empty((2, R, N), dtype=torch.int32, device=cuda)
    lib = library("group_agg")
    fn = lib.int8_mma16816_selftest_i8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(lib, fn(A.data_ptr(), W.data_ptr(), out[0].data_ptr(),
                  out[1].data_ptr(), R, K, N,
                  torch.cuda.current_stream().cuda_stream), "mma16816")
    want = (A.cpu().long() @ W.cpu().long()).int()
    torch.cuda.synchronize()
    assert torch.equal(out[1].cpu(), want)
    assert torch.equal(out[0].cpu(), want)


@pytest.mark.parametrize("batch", [1, 8])
def test_dsconv_int8_equals_plain(cuda, batch):
    g = torch.Generator().manual_seed(batch)
    args = (_i8(g, cuda, batch, 112, 112, 16), _sc(g, cuda, batch),
            _i8(g, cuda, 3, 3, 16), _sc(g, cuda, 16), _bias(g, cuda, 16),
            _i8(g, cuda, 16, 16), _sc(g, cuda, 16), _bias(g, cuda, 16))
    _same((dsconv_fused_int8(*args),), (dsconv_int8_ref(*args),))


def _dsconv_int8_args(g, device, B, H, W, C, F):
    return (_i8(g, device, B, H, W, C), _sc(g, device, B),
            _i8(g, device, 3, 3, C), _sc(g, device, C), _bias(g, device, C),
            _i8(g, device, C, F), _sc(g, device, F), _bias(g, device, F))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,W,C,F,stride,act", [
    (112, 112, 16, 16, 1, True), (56, 56, 32, 32, 2, True),
    (14, 10, 48, 24, 1, True), (9, 13, 16, 8, 1, False),
    (10, 10, 64, 40, 2, True)])
def test_dsconv_int8_paths_equal_plain(cuda, batch, H, W, C, F, stride,
                                       act):
    """The cluster kernel at every rank count the map takes, and the
    passes forced: stem.ds0 of B1@224, stride 2, C = 48 (a k32 and a
    k16 step) with 24 outputs (three column tiles), C = 64 over 40
    outputs, a small non-square map without Hardswish (ragged bands):
    EQUAL to the plain version and on two calls; the served call is one
    launch on the counter and takes the cluster."""
    g = torch.Generator().manual_seed(H * C + batch)
    args = _dsconv_int8_args(g, cuda, batch, H, W, C, F)
    ref = dsconv_int8_ref(*args, stride=stride, act=act)
    n = dsconv_fused_int8.launches
    _same((dsconv_fused_int8(*args, stride=stride, act=act),), (ref,))
    assert dsconv_fused_int8.launches == n + 1
    assert dsconv_int8_path(H, W, C, F, stride)["path"] == "cluster"
    for r in dsconv_int8_ranks(H, W, C, F, stride):
        got = _dsconv_int8(*args, stride, act, "cluster", r)
        _same((got,), (ref,))
        _same((_dsconv_int8(*args, stride, act, "cluster", r),), (got,))
    _same((_dsconv_int8(*args, stride, act, "passes"),), (ref,))


def test_dsconv_int8_passes_keep_the_rest(cuda):
    """A map no cluster holds (stem.ds0 at 640 px: a rank's fp32 DW band
    alone is past a CTA's shared memory) and channel counts the cluster
    kernel does not take (C = 8, F = 12) keep the passes, EQUAL to the
    plain version; a forced cluster on C = 8 is refused."""
    g = torch.Generator().manual_seed(3)
    for (B, H, C, F, stride) in ((1, 320, 16, 16, 1), (2, 12, 8, 16, 1),
                                 (2, 12, 16, 12, 2)):
        assert dsconv_int8_path(H, H, C, F, stride)["path"] == "passes"
        args = _dsconv_int8_args(g, cuda, B, H, H, C, F)
        _same((dsconv_fused_int8(*args, stride=stride),),
              (dsconv_int8_ref(*args, stride=stride),))
    args = _dsconv_int8_args(g, cuda, 1, 12, 12, 8, 16)
    with pytest.raises(KernelLaunchError):
        _dsconv_int8(*args, 1, True, "cluster", 4)


def test_dsconv_int8_smem_mirror_matches_the_source(cuda):
    """``dsconv_int8_cluster_smem`` equals the CUDA layout at stem.ds0 of
    B1 (192-384 px) and other maps, at every rank count, in both forms
    (plain and emitting); the card holds the batch-8 clusters of the
    chosen rank count at once at B1@224."""
    lib = library("dsconv_int8")
    fn = lib.dsconv_int8_cluster_smem_c
    fn.argtypes = [ctypes.c_int] * 7
    fn.restype = ctypes.c_longlong
    occ = lib.dsconv_int8_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    for (H, W, C, F, stride) in [(s // 2, s // 2, 16, 16, 1)
                                 for s in (192, 224, 256, 288, 320, 384)] \
            + [(56, 56, 32, 32, 2), (14, 10, 48, 24, 1), (9, 13, 16, 8, 1)]:
        for r in range(1, 17):
            for emit in (False, True):
                assert fn(H, W, C, F, stride, r, int(emit)) == \
                    dsconv_int8_cluster_smem(H, W, C, F, stride, r, emit)
    r = dsconv_int8_path(112, 112, 16, 16, 1)["ranks"]
    n = ctypes.c_int(0)
    assert occ(8, 112, 112, 16, 16, 1, r, ctypes.byref(n)) == 0
    assert n.value >= 8


def _mbconv_int8_args(g, device, B, H, C, M, F, W=None):
    return (_i8(g, device, B, H, W or H, C), _sc(g, device, B),
            _i8(g, device, C, M), _sc(g, device, M, base=2e-3),
            _bias(g, device, M), _i8(g, device, 3, 3, M), _sc(g, device, M),
            _bias(g, device, M), _i8(g, device, M, F), _sc(g, device, F),
            _bias(g, device, F))


def _mbconv_int8_paths(args, stride):
    """Every (path, ranks) to hold against the plain version: the passes,
    and where the image fits a cluster the chosen rank count and the
    largest legal one."""
    B, H, W, C = args[0].shape
    M, F = args[2].shape[1], args[8].shape[1]
    out = [("passes", 0)]
    for r in sorted({mbconv_int8_path(H, W, C, M, F, stride, B)["ranks"],
                     max(int8_ranks(M))} - {0}):
        if mbconv_int8_cluster_smem(H, W, C, M, F, stride, r) <= SMEM_LIMIT:
            out.append(("cluster", r))
    return out


def _check_mbconv_int8(args, stride, paths):
    """The served call (one launch on the counter), then each forced path
    at both variants, each EQUAL to the plain version and equal on two
    calls."""
    ref = mbconv_int8_ref(*args, stride=stride)
    qt = quantize_act(ref)
    want = (qt.q, qt.scale, ref)
    n = mbconv_fused_int8.launches, mbconv_fused_int8_emit.launches
    _same((mbconv_fused_int8(*args, stride=stride),), (ref,))
    _same(mbconv_fused_int8_emit(*args, stride=stride), want)
    assert (mbconv_fused_int8.launches, mbconv_fused_int8_emit.launches) \
        == (n[0] + 1, n[1] + 1)
    for path, ranks in paths:
        got = _mbconv_int8(*args, stride, False, path, ranks)
        _same((got,), (ref,))
        _same((_mbconv_int8(*args, stride, False, path, ranks),), (got,))
        got = _mbconv_int8(*args, stride, True, path, ranks)
        _same(got, want)
        _same(_mbconv_int8(*args, stride, True, path, ranks), got)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,C,M,F,stride", [
    (112, 16, 64, 32, 2), (56, 32, 128, 32, 1), (56, 32, 128, 64, 2),
    (28, 64, 256, 64, 1), (28, 64, 256, 128, 2), (14, 128, 512, 128, 1),
    (14, 128, 512, 256, 2), (7, 256, 1024, 256, 1)])
def test_mbconv_int8_equals_plain(cuda, batch, H, C, M, F, stride):
    """Both variants at every B1@224 mbconv shape, on the path the shape
    takes and on both paths wherever the image fits a cluster (the chosen
    and the largest legal rank count): EQUAL to the plain version, and
    equal bits on two calls."""
    g = torch.Generator().manual_seed(H * M + batch)
    args = _mbconv_int8_args(g, cuda, batch, H, C, M, F)
    _check_mbconv_int8(args, stride, _mbconv_int8_paths(args, stride))


@pytest.mark.parametrize("B,H,W,C,M,F,stride", [
    (1, 10, 10, 8, 40, 24, 2), (2, 9, 9, 24, 40, 24, 1),
    (2, 7, 7, 16, 40, 20, 1), (1, 14, 14, 32, 48, 24, 2),
    (2, 9, 7, 10, 36, 12, 1), (3, 6, 9, 24, 72, 40, 1),
    (2, 9, 9, 12, 42, 22, 1)])
def test_mbconv_int8_ragged(cuda, B, H, W, C, M, F, stride):
    """Ragged shapes on both paths at every legal rank count that fits: M
    = 40, 36 and 72 (not a multiple of ranks x 16: a last rank with a
    partial slice), F = 24, 20, 12 and 40 (not a multiple of 8, or ranks
    with no output column), C = 24 and 10 (a K tail; 8- and 2-byte
    aligned rows take the 4-byte and byte staging), W = 7 and 9, a
    non-square map, stride 2 at the anchor s - 1; M = 42 and F = 22
    (not multiples of 4: the weights' byte staging, the passes' scalar
    window and quantize-on-load)."""
    g = torch.Generator().manual_seed(H * M + C)
    args = _mbconv_int8_args(g, cuda, B, H, C, M, F, W)
    paths = [("passes", 0)] + [
        ("cluster", r) for r in int8_ranks(M)
        if mbconv_int8_cluster_smem(H, W, C, M, F, stride, r) <= SMEM_LIMIT]
    _check_mbconv_int8(args, stride, paths)


def test_mbconv_int8_refused_launch_raises(cuda):
    """A cluster launch CUDA refuses raises ``KernelLaunchError`` (never a
    retry on the passes) and leaves no error behind: the cluster path at
    S1.mb0, whose image needs more shared memory than a CTA has, and a
    cluster of 32 ranks, beyond the card."""
    g = torch.Generator().manual_seed(7)
    args = _mbconv_int8_args(g, cuda, 1, 112, 16, 64, 32)
    assert mbconv_int8_cluster_smem(112, 112, 16, 64, 32, 2, 4) > SMEM_LIMIT
    n = mbconv_fused_int8.launches
    with pytest.raises(KernelLaunchError):
        _mbconv_int8(*args, 2, False, "cluster", 4)
    big = _mbconv_int8_args(g, cuda, 1, 7, 256, 1024, 256)
    assert 31 * int8_mslice(1024, 32) < 1024   # every rank owns channels
    with pytest.raises(KernelLaunchError):
        _mbconv_int8(*big, 1, False, "cluster", 32)
    assert mbconv_fused_int8.launches == n
    _same((mbconv_fused_int8(*big),), (mbconv_int8_ref(*big),))


def test_mbconv_int8_smem_mirror_matches_the_source(cuda):
    """``mbconv_int8_cluster_smem`` and ``mbconv_int8_pass_smem`` equal the
    CUDA source's own layouts at every B1 mbconv shape (192-384 px), every
    B3@224 one (K = 2048: the GEMM pass in K chunks) and ragged ones,
    every legal rank count; the card holds at least one
    cluster of the chosen ranks at every served B1@224 site."""
    lib = library("mbconv_int8")
    cl = lib.mbconv_int8_cluster_smem_c
    cl.argtypes = [ctypes.c_int] * 7
    cl.restype = ctypes.c_longlong
    ps = lib.mbconv_int8_pass_smem_c
    ps.argtypes = [ctypes.c_int] * 6
    ps.restype = ctypes.c_longlong
    occ = lib.mbconv_int8_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 9 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    shapes = {(10, 10, 8, 40, 24, 2), (9, 7, 10, 36, 12, 1),
              (7, 7, 24, 1800, 72, 1)}
    models = [(B1, size) for size in (192, 224, 256, 384)] + [(B3, 224)]
    for cfg, size in models:
        for site in lower(cfg, batch=1, image_size=size).fusible():
            if site.kind == "mbconv":
                _, h, w, c = site.in_shape
                shapes.add((h, w, c, site.attrs["mid"], site.out_shape[-1],
                            site.stride))
    for h, w, c, m, f, st in sorted(shapes):
        assert ps(h, w, c, m, f, st) == \
            mbconv_int8_pass_smem(h, w, c, m, f, st)
        for r in int8_ranks(m):
            assert cl(h, w, c, m, f, st, r) == \
                mbconv_int8_cluster_smem(h, w, c, m, f, st, r)
    for h, c, m, f, st in ((14, 128, 512, 128, 1), (7, 256, 1024, 256, 1),
                           (28, 64, 256, 128, 2), (14, 128, 512, 256, 2)):
        r = mbconv_int8_path(h, h, c, m, f, st, 8)["ranks"]
        for emit in (0, 1):
            n = ctypes.c_int(0)
            assert occ(8, h, h, c, m, f, st, r, emit, ctypes.byref(n)) == 0
            assert n.value >= 1


@pytest.mark.parametrize("R,K,N", [(64, 256, 64), (37, 24, 20), (16, 100, 8),
                                   (50, 66, 33), (64, 1024, 64)])
def test_int8_mma_tile_equals_dp4a(cuda, R, K, N):
    """The int8 tensor-core tile of ``int8_mma.cuh`` (16-byte staging, the
    transposing weight stage, the m16n8k32 fragments) against ``__dp4a``
    sums of the same staged panels and against exact int64 sums on the
    host: ragged R, K and N, and K tails that are not 16- or 4-byte
    multiples."""
    g = torch.Generator().manual_seed(R * K + N)
    A, W = _i8(g, cuda, R, K), _i8(g, cuda, K, N)
    out = torch.empty((2, R, N), dtype=torch.int32, device=cuda)
    lib = library("mbconv_int8")
    fn = lib.int8_mma_selftest_i8
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    check(lib, fn(A.data_ptr(), W.data_ptr(), out[0].data_ptr(),
                  out[1].data_ptr(), R, K, N,
                  torch.cuda.current_stream().cuda_stream), "int8_mma")
    want = (A.cpu().long() @ W.cpu().long()).int()
    torch.cuda.synchronize()
    assert torch.equal(out[1].cpu(), want)
    assert torch.equal(out[0].cpu(), want)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,C", [(14, 384), (7, 768)])
def test_group_agg_int8_equals_plain(cuda, batch, H, C):
    g = torch.Generator().manual_seed(C + batch)
    args = (_i8(g, cuda, batch, H, H, C), _sc(g, cuda, batch),
            _i8(g, cuda, 5, 5, C), _sc(g, cuda, C), _bias(g, cuda, C))
    pw, tail = _i8(g, cuda, 16, C), (_sc(g, cuda, C), _bias(g, cuda, C))
    _same((group_agg_int8(*args, pw, *tail),),
          (group_agg_int8_ref(*args, block_diag(pw), *tail),))


def _group_agg_args(g, device, B, H, W, C, S, d=16):
    return ((_i8(g, device, B, H, W, C), _sc(g, device, B),
             _i8(g, device, S, S, C), _sc(g, device, C), _bias(g, device, C)),
            _i8(g, device, d, C), (_sc(g, device, C), _bias(g, device, C)))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,W,C,S", [(14, 14, 384, 5), (7, 7, 768, 5),
                                     (14, 14, 384, 3), (9, 5, 96, 3)])
def test_group_agg_int8_paths_equal_plain(cuda, batch, H, W, C, S):
    """The cluster kernel at every rank count that holds whole groups and
    fits a CTA, and the two launches forced, at both B1@224 shapes, S = 3
    and a small non-square map: EQUAL to the plain version; the served
    call is one launch on the counter."""
    g = torch.Generator().manual_seed(C * S + batch)
    args, pw, tail = _group_agg_args(g, cuda, batch, H, W, C, S)
    ref = group_agg_int8_ref(*args, block_diag(pw), *tail)
    n = group_agg_int8.launches
    _same((group_agg_int8(*args, pw, *tail),), (ref,))
    assert group_agg_int8.launches == n + 1
    assert group_agg_path(H, W, C, 16, S)["path"] == "cluster"
    for r in group_agg_ranks(C, 16):
        if group_agg_cluster_smem(H, W, C, 16, S, r) <= SMEM_LIMIT:
            _same((_group_agg(*args, pw, *tail, path="cluster", ranks=r),),
                  (ref,))
    _same((_group_agg(*args, pw, *tail, path="two-launch"),), (ref,))


def test_group_agg_int8_large_map_and_d8(cuda):
    """A map whose slices fit no cluster (S3 of B1 at 640 px) and a group
    size of 8 take the two launches, EQUAL to the plain version; the
    cluster kernel refuses a rank count that splits a group."""
    g = torch.Generator().manual_seed(11)
    for (B, H, C, d) in ((1, 40, 384, 16), (2, 7, 96, 8)):
        assert group_agg_path(H, H, C, d)["path"] == "two-launch"
        args, pw, tail = _group_agg_args(g, cuda, B, H, H, C, 5, d)
        _same((group_agg_int8(*args, pw, *tail),),
              (group_agg_int8_ref(*args, block_diag(pw), *tail),))
    args, pw, tail = _group_agg_args(g, cuda, 1, 7, 7, 96, 5)
    with pytest.raises(KernelLaunchError):
        _group_agg(*args, pw, *tail, path="cluster", ranks=4)


def test_group_agg_smem_mirror_matches_the_source(cuda):
    """``group_agg_cluster_smem`` equals the CUDA layout at every B1
    aggregation shape (192-384 px) and every legal rank count; the card
    holds the batch-8 clusters of the chosen rank count at once at
    B1@224."""
    lib = library("group_agg")
    fn = lib.group_agg_cluster_smem_c
    fn.argtypes = [ctypes.c_int] * 6
    fn.restype = ctypes.c_longlong
    occ = lib.group_agg_max_active_clusters
    occ.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
    occ.restype = ctypes.c_int
    for size in (192, 224, 256, 288, 320, 384):
        for f, C in ((16, 384), (32, 768)):
            h = size // f
            for S in (3, 5):
                for r in group_agg_ranks(C, 16):
                    assert fn(h, h, C, 16, S, r) == \
                        group_agg_cluster_smem(h, h, C, 16, S, r)
    for H, C in ((14, 384), (7, 768)):
        r = group_agg_path(H, H, C, 16)["ranks"]
        n = ctypes.c_int(0)
        assert occ(8, H, H, C, 16, 5, r, ctypes.byref(n)) == 0
        assert n.value >= 8


def test_fix8_engine_on_the_card(cuda):
    """``VisionEngine.quantized`` launches the int8 kernels on every
    fused site (its batch-8 key's warm-up run and capture, made with the
    engine; a replay runs no wrapper), its logits are finite, and a
    batch-8 forward equals eight batch-1 forwards bit for bit
    (``chip_smoke.py`` holds the served logits to the int8 reference
    forward)."""
    params = init_efficientvit(torch.Generator().manual_seed(0), B1)
    wrappers = (int8_matmul, group_agg_int8, mbconv_fused_int8,
                mbconv_fused_int8_emit, dsconv_fused_int8,
                supersite_fused_int8)
    per_forward = [14, 7, 7, 2, 1, 2]
    counts = {f: f.launches for f in wrappers}
    engine = VisionEngine.quantized(params, B1,
                                    VisionServeConfig(microbatch=8))
    assert [f.launches - n for f, n in counts.items()] == \
        [2 * n for n in per_forward]
    assert [engine.cache.get(8, 224).replay_launches[f.__name__]
            for f in wrappers] == per_forward
    x = _rand(np.random.default_rng(3), cuda, 8, 224, 224, 3)
    counts = {f: f.launches for f in wrappers}
    got = engine.logits(x)
    assert [f.launches - n for f, n in counts.items()] == [0] * 6
    assert got.shape == (8, 1000) and bool(torch.isfinite(got).all())
    ones = torch.cat([engine.logits(x[i:i + 1]) for i in range(8)])
    assert torch.equal(got, ones)


MSA_EMIT = [(196, 128, 384), (196, 256, 128), (49, 256, 768),
            (49, 512, 256)]


@pytest.mark.parametrize("keep_fp", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("rows,K,N", MSA_EMIT)
def test_int8_matmul_emit_equals_plain(cuda, rows, K, N, batch, keep_fp):
    """The MSA projections of B1@224 (the library's shapes): the plan
    takes the cluster path, and the codes, the scales and the kept map
    are EQUAL to the plain version; a static scale (one broadcast
    scalar) as well."""
    g = torch.Generator().manual_seed(rows + K + batch)
    args = (_i8(g, cuda, batch * rows, K), _i8(g, cuda, K, N),
            _sc(g, cuda, batch), _sc(g, cuda, N))
    kw = dict(rows_per_group=rows, bias=_bias(g, cuda, N), keep_fp=keep_fp)
    assert int8_emit_plan(batch * rows, N, K, rows)["path"] == "cluster"
    n = int8_matmul_emit.launches
    got = int8_matmul_emit(*args, **kw)
    assert int8_matmul_emit.launches == n + 1
    _same(got, int8_matmul_emit_ref(*args, **kw))
    static = (args[0], args[1], args[2][0], args[3])
    _same(int8_matmul_emit(*static, **kw),
          int8_matmul_emit_ref(*static, **kw))


@pytest.mark.parametrize("rows,K,N", [(37, 50, 29), (5, 700, 40),
                                      (16, 64, 16), (3, 3001, 8),
                                      (70, 130, 200)])
def test_int8_matmul_emit_ragged(cuda, rows, K, N):
    """Ragged rows, K and N at every cluster cell and on the plain grid
    (tiles of a group that end inside the group, K tails through the
    4-byte and byte staging and the two-stage ring, N through stage_wt's
    loads, byte stores of codes and scalar stores of the kept map): EQUAL
    to the plain version, keep-fp on and off, with and without a
    bias."""
    g = torch.Generator().manual_seed(rows * K + N)
    args = (_i8(g, cuda, 3 * rows, K), _i8(g, cuda, K, N), _sc(g, cuda, 3),
            _sc(g, cuda, N))
    bias = _bias(g, cuda, N)
    cells = [dict(path="cluster", bm=bm, bn=bn)
             for bm, bn in emit_cells(rows, N, K)]
    cells.append(dict(path="grid", bm=16, bn=32))
    for keep in (False, True):
        for b in (bias, None):
            ref = int8_matmul_emit_ref(*args, rows_per_group=rows, bias=b,
                                       keep_fp=keep)
            _same(int8_matmul_emit(*args, rows_per_group=rows, bias=b,
                                   keep_fp=keep), ref)
            for c in cells:
                _same(_int8_matmul_emit(*args, b, rows, keep, c), ref)


def test_int8_matmul_emit_grid_fallback(cuda):
    """Groups no cluster holds (4096 rows of 256 columns: 4 MB of sums an
    image) take the plain grid and the quantize pass: EQUAL to the plain
    version, one call on the counter."""
    rows, K, N = 4096, 128, 256
    plan = int8_emit_plan(2 * rows, N, K, rows)
    assert plan["path"] == "grid" and not emit_cells(rows, N, K)
    g = torch.Generator().manual_seed(4)
    args = (_i8(g, cuda, 2 * rows, K), _i8(g, cuda, K, N), _sc(g, cuda, 2),
            _sc(g, cuda, N))
    for keep in (False, True):
        kw = dict(rows_per_group=rows, bias=_bias(g, cuda, N), keep_fp=keep)
        n = int8_matmul_emit.launches
        got = int8_matmul_emit(*args, **kw)
        assert int8_matmul_emit.launches == n + 1
        _same(got, int8_matmul_emit_ref(*args, **kw))


@pytest.mark.parametrize("rows,K,N", MSA_EMIT)
def test_int8_matmul_emit_rows_are_batch_invariant(cuda, rows, K, N):
    """Image i's codes, scale and kept map in a batch-8 call equal its
    batch-1 call bit for bit (a cluster per image; no rank's work depends
    on the batch)."""
    g = torch.Generator().manual_seed(rows * N)
    x, w = _i8(g, cuda, 8 * rows, K), _i8(g, cuda, K, N)
    xs, ws, b = _sc(g, cuda, 8), _sc(g, cuda, N), _bias(g, cuda, N)
    kw = dict(rows_per_group=rows, bias=b, keep_fp=True)
    q, s, fp = int8_matmul_emit(x, w, xs, ws, **kw)
    for i in range(8):
        sl = slice(i * rows, (i + 1) * rows)
        _same((q[sl], s[i:i + 1], fp[sl]),
              int8_matmul_emit(x[sl], w, xs[i:i + 1], ws, **kw))


def test_int8_emit_smem_mirror_matches_the_source(cuda):
    """``int8_emit_smem`` equals the CUDA layout (``int8_emit_smem_c``) at
    every cluster cell of the B1 projection shapes (192-384 px) and of
    ragged ones, and the plan reports it."""
    fn = library("int8_matmul").int8_emit_smem_c
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    shapes = {(37, 50, 29), (5, 700, 40), (3, 3001, 8)}
    for size in (192, 224, 256, 384):
        for site in lower(B1, batch=1, image_size=size).fusible():
            if site.kind == "msa":
                _, h, w, c = site.in_shape
                total = site.attrs["heads"] * site.attrs["head_dim"]
                shapes |= {(h * w, c, 3 * total), (h * w, 2 * total, c)}
    for rows, K, N in sorted(shapes):
        for bm, bn in emit_cells(rows, N, K):
            assert fn(K, bm, bn) == int8_emit_smem(K, bm, bn)
        plan = int8_emit_plan(rows, N, K, rows)
        assert plan["smem"] == fn(K, plan["bm"], plan["bn"])


_EMIT_LAUNCHES = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.int8_matmul.kernel import int8_matmul_emit
g = torch.Generator(device="cuda").manual_seed(21)
calls = []
for rows, K, N in ((196, 128, 384), (196, 256, 128), (49, 256, 768),
                   (49, 512, 256)):
    x = torch.randint(-128, 128, (8 * rows, K), generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (K, N), generator=g, device="cuda",
                      dtype=torch.int8)
    ws, b = 1e-2 * torch.rand((2, N), generator=g, device="cuda")
    for xs, keep in ((1e-2 * torch.rand(8, generator=g, device="cuda"),
                      False), (torch.tensor(0.01, device="cuda"), True)):
        calls.append(lambda x=x, w=w, xs=xs, ws=ws, b=b, r=rows, k=keep:
                     int8_matmul_emit(x, w, xs, ws, rows_per_group=r,
                                      bias=b, keep_fp=k))
for fn in calls:
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for fn in calls:
        fn()
    torch.cuda.synchronize()
rows = {}
for e in prof.key_averages():
    us = getattr(e, "device_time_total", None)
    if (e.cuda_time_total if us is None else us) > 0:
        rows[e.key] = e.count
print(json.dumps(rows))
"""


def test_int8_matmul_emit_cluster_is_one_launch(cuda):
    """On the cluster path, an emitting call is one CUDA launch of
    ``int8_emit_gemm<true>`` with no memset and nothing else, at the four
    MSA projections of B1@224, batch 8, per-image and static scales,
    keep-fp off and on: counted by torch.profiler in a process of its
    own.  CUPTI now and then drops one activity record (one capture on
    an H100 counted 7 of these 8 launches), so a capture may count
    fewer, never more: every capture holds only the kernel and at most 8
    launches, and one of at most three counts all 8."""
    import json
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    counts = []
    for _ in range(3):
        proc = subprocess.run([sys.executable, "-c", _EMIT_LAUNCHES],
                              capture_output=True, text=True, timeout=600,
                              env=dict(os.environ, PYTHONPATH=src))
        assert proc.returncode == 0, proc.stderr[-2000:]
        rows = json.loads(proc.stdout.strip().splitlines()[-1])
        assert all("int8_emit_gemm<true>" in k for k in rows), rows
        counts.append(sum(rows.values()))
        assert counts[-1] <= 8, rows
        if counts[-1] == 8:
            break
    assert counts[-1] == 8, counts


@pytest.mark.parametrize("keep_fp", [False, True])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,C,stride", [(112, 16, 1), (56, 32, 2),
                                        (12, 8, 1)])
def test_dsconv_int8_emit_equals_plain(cuda, H, C, stride, batch, keep_fp):
    """The library's shapes (stem.ds0 of B1@224, stride-2 56x56x32) take
    the emitting cluster kernel, C = 8 the passes; on the cluster shapes
    the passes forced give the same bits; the fp32 map is
    ``dsconv_fused_int8``'s on both paths."""
    g = torch.Generator().manual_seed(H + batch)
    args = (_i8(g, cuda, batch, H, H, C), _sc(g, cuda, batch),
            _i8(g, cuda, 3, 3, C), _sc(g, cuda, C), _bias(g, cuda, C),
            _i8(g, cuda, C, C), _sc(g, cuda, C), _bias(g, cuda, C))
    path = dsconv_int8_path(H, H, C, C, stride, emit=True)
    assert path["path"] == ("passes" if C == 8 else "cluster")
    assert path == dsconv_int8_path(H, H, C, C, stride) | {
        "smem": path["smem"]}
    ref = dsconv_int8_emit_ref(*args, stride=stride, keep_fp=keep_fp)
    n = dsconv_fused_int8_emit.launches
    got = dsconv_fused_int8_emit(*args, stride=stride, keep_fp=keep_fp)
    assert dsconv_fused_int8_emit.launches == n + 1
    _same(got, ref)
    passes = _dsconv_int8_emit(*args, stride, True, keep_fp, "passes")
    _same(passes, ref)
    if keep_fp:
        base = dsconv_fused_int8(*args, stride=stride)
        _same((got[2],), (base,))
        _same((passes[2],), (base,))


@pytest.mark.parametrize("H,W,C,F,stride", [
    (14, 10, 48, 24, 1), (9, 13, 16, 8, 1), (10, 10, 64, 40, 2),
    (12, 12, 16, 48, 1)])
def test_dsconv_int8_emit_cluster_ranks_equal_plain(cuda, H, W, C, F,
                                                    stride):
    """The emitting cluster kernel at every rank count the map takes, on
    a k32 + k16 step with three column tiles, F = 8 (8-byte code stores,
    ragged bands), stride 2, and F > C (the output band outgrows the DW
    band's region): EQUAL to the plain version, keep-fp on and off."""
    g = torch.Generator().manual_seed(H * C + W)
    args = _dsconv_int8_args(g, cuda, 2, H, W, C, F)
    for keep in (False, True):
        ref = dsconv_int8_emit_ref(*args, stride=stride, keep_fp=keep)
        for r in dsconv_int8_ranks(H, W, C, F, stride, emit=True):
            _same(_dsconv_int8_emit(*args, stride, True, keep, "cluster", r),
                  ref)


def test_dsconv_int8_emit_cluster_is_one_launch(cuda):
    """On the cluster path, an emitting call is one CUDA launch of
    ``dsconv_i8_cluster<true>`` with no memset, with keep-fp off and on
    (one ``torch.profiler`` capture over both calls)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(5)
    args = _dsconv_int8_args(g, cuda, 8, 112, 112, 16, 16)
    assert dsconv_int8_path(112, 112, 16, 16, 1, emit=True)["path"] \
        == "cluster"
    for keep in (False, True):
        dsconv_fused_int8_emit(*args, keep_fp=keep)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for keep in (False, True):
            dsconv_fused_int8_emit(*args, keep_fp=keep)
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if (e.cuda_time_total if us is None else us) > 0:
            rows[e.key] = e.count
    assert sum(rows.values()) == 2, rows
    assert all("dsconv_i8_cluster<true>" in k for k in rows), rows


# ---------------------------------------------------------------------------
# the LM-form scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("BH,N,D,chunk,dtype", [
    (4, 1000, 64, 256, torch.float32), (2, 700, 240, 256, torch.float32),
    (3, 300, 32, 16, torch.bfloat16), (2, 64, 16, 64, torch.float32),
    (2, 300, 37, 64, torch.float32), (3, 1000, 64, 100, torch.float32),
    (2, 777, 48, 100, torch.bfloat16)])
def test_relu_attn_causal_matches_plain(cuda, BH, N, D, chunk, dtype):
    """Ragged N, d = 240 (four column groups), bf16 inputs, d = 37 (rows
    staged through registers, not by cp.async), a chunk of 100 tokens (a
    query tile of 36 rows after one of 64)."""
    rng = np.random.default_rng(N + D)
    q, k, v = (_rand(rng, cuda, BH, N, D).to(dtype) for _ in range(3))
    n = relu_attn_causal.launches
    got = relu_attn_causal(q, k, v, chunk=chunk)
    assert relu_attn_causal.launches == n + 1
    _close(got, relu_attn_causal_chunked(q, k, v, chunk=chunk))


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (4, 1024, 64, 128, 256), (3, 517, 64, 128, 256), (2, 300, 16, 16, 32),
    (2, 300, 33, 21, 64), (2, 300, 200, 4, 64), (3, 1000, 64, 128, 100)])
def test_ssd_kernel_matches_plain(cuda, BH, S, P, N, chunk):
    """Mamba-2's step sizes and decays (dt in [1e-3, 0.1], A in [-16,
    -1]); a ragged S runs as if zero-padded; P = 33 and N = 21 (rows
    staged through registers, not by cp.async); N = 4 under P = 200
    (four column groups over a state of four rows); a chunk of 100."""
    rng = np.random.default_rng(S + P)
    x = _rand(rng, cuda, BH, S, P)
    Bm, Cm = _rand(rng, cuda, BH, S, N), _rand(rng, cuda, BH, S, N)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (
        BH, S))).astype(np.float32)).to(cuda)
    A = torch.from_numpy(-rng.uniform(1, 16, (BH, 1)).astype(
        np.float32)).to(cuda)
    n = ssd_chunked.launches
    got = ssd_chunked(x, dt, dt * A, Bm, Cm, chunk=chunk)
    assert ssd_chunked.launches == n + 1
    _close(got, ssd_chunked_ref(x, dt, dt * A, Bm, Cm, chunk=chunk))


# many chunks: more (row, chunk) tasks than the card has SMs, a ragged
# last chunk, d = 240 (four column groups), bf16, chunk 256
CAUSAL_MANY = [(4, 8192, 64, 64, torch.float32),
               (3, 8192 - 37, 64, 64, torch.float32),
               (3, 4096 + 10, 240, 64, torch.float32),
               (4, 8192, 64, 64, torch.bfloat16),
               (3, 16384, 64, 256, torch.float32),
               (3, 8192 + 100, 100, 128, torch.float32)]


@pytest.mark.parametrize("BH,N,D,chunk,dtype", CAUSAL_MANY)
def test_relu_attn_causal_many_chunks(cuda, BH, N, D, chunk, dtype):
    """64 to 128 chunks a row, more (row, chunk) tasks than the card has
    SMs: the states, the prefix and the outputs of the chunk-parallel
    scan against the plain version in the same stages
    and against the TPU kernel's chunk order; a ragged N (and D = 100, no
    multiple of 64) on the last chunk's query tiles."""
    rng = np.random.default_rng(N + D)
    q, k, v = (_rand(rng, cuda, BH, N, D).to(dtype) for _ in range(3))
    plan = relu_attn_causal_plan(BH, N, D, chunk)
    assert plan["chunks"] >= 64 and plan["launches"] == 3
    assert BH * plan["chunks"] > 132
    n = relu_attn_causal.launches
    got = relu_attn_causal(q, k, v, chunk=chunk)
    assert relu_attn_causal.launches == n + 1
    _close(got, relu_attn_causal_scan(q, k, v, chunk=chunk))
    _close(got, relu_attn_causal_chunked(q, k, v, chunk=chunk))


SSD_MANY = [(4, 8192, 64, 128, 64), (3, 8192 - 50, 64, 128, 64),
            (3, 16384, 64, 128, 256), (3, 4096 + 7, 100, 72, 64)]


def _ssd_args(rng, device, BH, S, P, N):
    """Mamba-2's step sizes and decays: dt in [1e-3, 0.1], A in [-16,
    -1] per row."""
    x = _rand(rng, device, BH, S, P)
    Bm, Cm = _rand(rng, device, BH, S, N), _rand(rng, device, BH, S, N)
    dt = torch.from_numpy(np.exp(rng.uniform(np.log(1e-3), np.log(0.1), (
        BH, S))).astype(np.float32)).to(device)
    A = torch.from_numpy(-rng.uniform(1, 16, (BH, 1)).astype(
        np.float32)).to(device)
    return x, dt, dt * A, Bm, Cm


@pytest.mark.parametrize("BH,S,P,N,chunk", SSD_MANY)
def test_ssd_kernel_many_chunks(cuda, BH, S, P, N, chunk):
    """64 to 128 chunks a row through the decayed prefix, a ragged last
    chunk, P = 100 (two column groups) and N = 72."""
    args = _ssd_args(np.random.default_rng(S + P), cuda, BH, S, P, N)
    plan = ssd_plan(BH, S, P, N, chunk)
    assert plan["chunks"] >= 64 and plan["launches"] == 3
    assert BH * plan["chunks"] > 132
    n = ssd_chunked.launches
    got = ssd_chunked(*args, chunk=chunk)
    assert ssd_chunked.launches == n + 1
    _close(got, ssd_scan_ref(*args, chunk=chunk))
    _close(got, ssd_chunked_ref(*args, chunk=chunk))


def test_scan_smem_mirrors_match_the_sources(cuda):
    """``relu_attn_causal_smem_bytes`` and ``ssd_smem_bytes`` equal the
    CUDA layouts of both launches (``relu_attn_causal_smem_c``,
    ``ssd_smem_c``) over head dims, state sizes and chunks, and fit."""
    ra, sd = library("relu_attn_causal"), library("ssd")
    ra.relu_attn_causal_smem_c.restype = ctypes.c_longlong
    sd.ssd_smem_c.restype = ctypes.c_longlong
    for d in (16, 37, 64, 100, 128, 240, 256):
        want = relu_attn_causal_smem_bytes(d)
        assert [ra.relu_attn_causal_smem_c(d, o) for o in (0, 1)] == [
            want["states"], want["out"]], d
        assert max(want.values()) <= SMEM_LIMIT
    for n, p, chunk in ((128, 64, 256), (16, 16, 32), (21, 33, 64),
                        (72, 100, 64), (256, 256, 256)):
        want = ssd_smem_bytes(n, p, chunk)
        assert [sd.ssd_smem_c(n, p, chunk, o) for o in (0, 1)] == [
            want["states"], want["out"]], (n, p, chunk)


def test_scans_repeat_their_bits(cuda):
    """No atomics and a fixed order in every sum: two calls of each scan
    on the same inputs give equal bits (fp32 and bf16 attention, the
    SSD)."""
    rng = np.random.default_rng(20)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = [_rand(rng, cuda, 3, 4096 - 5, 64).to(dtype) for _ in range(3)]
        assert torch.equal(relu_attn_causal(*qkv, chunk=64),
                           relu_attn_causal(*qkv, chunk=64))
    args = _ssd_args(rng, cuda, 3, 4096 - 5, 64, 128)
    assert torch.equal(ssd_chunked(*args, chunk=64),
                       ssd_chunked(*args, chunk=64))


# One torch.profiler capture over a call of each scan, two chunk counts
# each; printed as {kernel: launches}.
_SCAN_LAUNCHES = """
import json
import torch
from torch.profiler import ProfilerActivity, profile
from repro_torch.kernels.relu_attn.kernel import relu_attn_causal
from repro_torch.kernels.ssd.kernel import ssd_chunked
g = torch.Generator(device="cuda").manual_seed(21)
r = lambda *s: torch.randn(s, generator=g, device="cuda")
qkv = [r(2, 1024, 64) for _ in range(3)]
dt = 1e-3 + 0.1 * torch.rand((2, 1024), generator=g, device="cuda")
ssd = (r(2, 1024, 64), dt, -4.0 * dt, r(2, 1024, 128), r(2, 1024, 128))
calls = [lambda: relu_attn_causal(*qkv, chunk=256),
         lambda: relu_attn_causal(*qkv, chunk=1024),
         lambda: ssd_chunked(*ssd, chunk=256),
         lambda: ssd_chunked(*ssd, chunk=1024)]
for fn in calls:
    fn()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for fn in calls:
        fn()
    torch.cuda.synchronize()
rows = {}
for e in prof.key_averages():
    us = getattr(e, "device_time_total", None)
    if (e.cuda_time_total if us is None else us) > 0:
        rows[e.key] = e.count
print(json.dumps(rows))
"""


def test_scans_launch_three_kernels(cuda):
    """A call over many chunks is three CUDA launches (states, prefix,
    outputs), a single chunk one (the outputs), as the plans say, and
    nothing else: counted by torch.profiler in a process of its own (a
    second capture in one process can miss the device activity)."""
    import json
    import os
    import subprocess
    import sys
    assert [relu_attn_causal_plan(2, 1024, 64, c)["launches"]
            for c in (256, 1024)] == [3, 1]
    assert [ssd_plan(2, 1024, 64, 128, c)["launches"]
            for c in (256, 1024)] == [3, 1]
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    proc = subprocess.run([sys.executable, "-c", _SCAN_LAUNCHES],
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, PYTHONPATH=src))
    assert proc.returncode == 0, proc.stderr[-2000:]
    rows = json.loads(proc.stdout.strip().splitlines()[-1])
    names = ("causal_states", "causal_out", "ssd_states", "ssd_out",
             "chunk_prefix")
    counts = {n: sum(c for k, c in rows.items() if n in k) for n in names}
    assert counts == {"causal_states": 1, "causal_out": 2, "ssd_states": 1,
                      "ssd_out": 2, "chunk_prefix": 2}, rows
    assert sum(rows.values()) == 8, rows


# ---------------------------------------------------------------------------
# super-site chains: the kernels against their plain versions, grouped
# forwards against per-site ones
# ---------------------------------------------------------------------------

# widths (8,16,24,32,48), depths (2,2,3,1,1): forms stem.ss0 (a residual
# first member), S1.ss0 and S2.ss0
DEEP = EfficientViTConfig(name="ss-smoke", widths=(8, 16, 24, 32, 48),
                          depths=(2, 2, 3, 1, 1), head_widths=(64, 64),
                          num_classes=10, image_size=64)
CHAINS = [(B1, ("S1.mb0", "S1.mb1")), (B1, ("S2.mb0", "S2.mb1", "S2.mb2")),
          (DEEP, ("stem.ds0", "stem.ds1"))]


def _chain(cfg, names, batch, precision):
    params = init_efficientvit(torch.Generator().manual_seed(len(names)),
                               cfg, "cuda")
    if precision == "int8":
        params = quantize_efficientvit(params)
    sup = SuperSite.of(lower(cfg, batch=batch), names)
    return sup, pack_weights(params, sup, precision)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("cfg,names", CHAINS)
def test_supersite_kernel_matches_plain(cuda, cfg, names, batch):
    """The planner's band and bands of 1 and 3 rows at its chunk, widest
    first.  A band whose CTA needs more than SMEM_LIMIT is refused by the
    card (B1@224 S1.ss0 at batch 1: 3 rows at chunk 32 need 253,696 B),
    and the refusal leaves no error behind for the next launch."""
    sup, pack = _chain(cfg, names, batch, "fp")
    blocks = choose_blocks(sup)
    x = _rand(np.random.default_rng(batch), cuda, *sup.in_shape)
    for rows in sorted({blocks["block_rows"], 1, 3}, reverse=True):
        geom = make_fp_geom(sup, pack, rows, blocks["block_m"])
        n = supersite_fused.launches
        if supersite_smem_bytes(sup, rows, blocks["block_m"]) > SMEM_LIMIT:
            with pytest.raises(KernelLaunchError):
                supersite_fused(x, pack.fp, geom=geom)
            assert supersite_fused.launches == n
            continue
        got = supersite_fused(x, pack.fp, geom=geom)
        assert supersite_fused.launches == n + 1
        _close(got, supersite_ref(x, pack.fp, geom=geom))
        assert torch.equal(got, supersite_fused(x, pack.fp, geom=geom))


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("cfg,names", CHAINS)
def test_supersite_int8_equals_plain(cuda, cfg, names, batch):
    """Every exit: fp32, int8, int8 with the fp map kept; two calls give
    equal bits."""
    sup, pack = _chain(cfg, names, batch, "int8")
    geom = make_int8_geom(sup, pack)
    g = torch.Generator().manual_seed(batch)
    x_q = _i8(g, cuda, *sup.in_shape)
    x_s = _sc(g, cuda, batch)
    x_fp = (_rand(np.random.default_rng(batch), cuda, *sup.in_shape)
            if sup.sites[0].residual else None)
    args = (x_q, x_s, pack.q, pack.fp)
    for emit in (False, True):
        ref = supersite_int8_ref(*args, geom=geom, x_fp=x_fp,
                                 exit_emit=emit)
        n = supersite_fused_int8.launches
        got = supersite_fused_int8(*args, geom=geom, x_fp=x_fp,
                                   exit_emit=emit, keep_fp=emit)
        assert supersite_fused_int8.launches == n + 1
        _same(got if emit else (got,), ref if emit else (ref,))
        again = supersite_fused_int8(*args, geom=geom, x_fp=x_fp,
                                     exit_emit=emit, keep_fp=emit)
        _same(again if emit else (again,), got if emit else (got,))


@pytest.mark.parametrize("cfg,batch", [(B1, 4), (DEEP, 2)])
def test_grouped_forward_on_the_card(cuda, cfg, batch):
    """The default grouped plan against the per-site plan: fp32 within
    1e-4, FIX8 bit-equal."""
    params = init_efficientvit(torch.Generator().manual_seed(0), cfg, "cuda")
    program = lower(cfg, batch=batch)
    x = _rand(np.random.default_rng(4), cuda, batch, cfg.image_size,
              cfg.image_size, 3)
    for tree in (params, quantize_efficientvit(params)):
        grouped = plan_program(program, tree)
        flat = plan_program(program, tree, supersites=False)
        assert grouped.groups and not flat.groups
        with torch.inference_mode():
            got = execute(program, tree, x, plan=grouped)
            want = execute(program, tree, x, plan=flat)
        if tree is params:
            _close(got, want)
        else:
            _same((got,), (want,))


# ---------------------------------------------------------------------------
# CUDA graphs: one per executor key
# ---------------------------------------------------------------------------

def _launches():
    return {n: w.launches for n, w in kernel_wrappers().items()}


def _graph_cache(cfg, precision, buckets, **kw):
    params = init_efficientvit(torch.Generator().manual_seed(0), cfg, "cuda")
    tree = params if precision == "fp" else quantize_efficientvit(params)
    return ExecutorCache(tree, cfg, buckets=buckets,
                         precision="auto" if precision == "fp" else "int8",
                         device="cuda", **kw)


def _replayed(ex, params, x):
    """One replay, and the launches it added to the wrappers' counters."""
    before = _launches()
    out = ex(params, x)
    after = _launches()
    return out, {n: after[n] - before[n] for n in after
                 if after[n] != before[n]}


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_replay_equals_eager(cuda, precision):
    """B1_SMOKE at batch 1, 4 and 8: every executor holds a graph, its
    replayed logits equal the eager forward of its (program, plan) bit
    for bit, and a replay runs no kernel wrapper (the capture recorded
    the launches; the wrappers' counters count only launches they
    issue)."""
    cache = _graph_cache(B1_SMOKE, precision, (1, 4, 8))
    for batch in (1, 4, 8):
        ex = cache.get(batch, 64)
        assert ex.graph is not None and ex.warmed
        x = _rand(np.random.default_rng(batch), cuda, batch, 64, 64, 3)
        got, added = _replayed(ex, cache.params, x)
        assert added == {} and ex.replay_launches
        with torch.inference_mode():
            want = execute(ex.program, cache.params, x, plan=ex.plan)
        _same((got,), (want,))
        partial, _ = _replayed(ex, cache.params, x[:1])   # rows zeroed
        with torch.inference_mode():
            padded = execute(ex.program, cache.params, torch.cat(
                [x[:1], x.new_zeros((batch - 1, 64, 64, 3))]), plan=ex.plan)
        _same((partial,), (padded,))


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_dispatches_in_flight_keep_their_logits(cuda, precision):
    """Five replays of one key queued behind a sleep before anything is
    read: each returns its own logits (the graph's output is copied out
    in-stream), equal to its eager forward."""
    cache = _graph_cache(B1_SMOKE, precision, (2,))
    ex = cache.get(2, 64)
    xs = [_rand(np.random.default_rng(10 + i), cuda, 2, 64, 64, 3)
          for i in range(5)]
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    outs = [ex(cache.params, x) for x in xs]
    with torch.inference_mode():
        wants = [execute(ex.program, cache.params, x, plan=ex.plan)
                 for x in xs]
    _same(outs, wants)
    assert not torch.equal(outs[0], outs[1])


def test_ladder_moves_drop_the_graph_and_capture_anew(cuda):
    """``degrade`` on a chain member (the deep config's S2.ss0 splits) and
    ``pin_fp`` on a FIX8 key: a new executor with a new graph whose
    replays run the new plan's kernels and equal its eager forward."""
    cache = _graph_cache(DEEP, "fp", (2,))
    ex0 = cache.get(2, 64)
    assert {g.name for g in ex0.plan.groups.values()} == {
        "stem.ss0", "S1.ss0", "S2.ss0"}
    state = cache.degrade(2, 64, site="S2.mb1")
    assert state.level == 1 and cache.keys() == ()
    ex1 = cache.get(2, 64)
    assert ex1 is not ex0 and ex1.graph is not None
    assert ex1.graph is not ex0.graph
    assert {g.name for g in ex1.plan.groups.values()} == {"stem.ss0",
                                                          "S1.ss0"}
    assert ex1.replay_launches["supersite_fused"] == 2
    assert ex1.replay_launches["mbconv_fused"] == \
        ex0.replay_launches["mbconv_fused"] + 2
    x = _rand(np.random.default_rng(5), cuda, 2, 64, 64, 3)
    got, added = _replayed(ex1, cache.params, x)
    assert added == {}
    with torch.inference_mode():
        _close(got, execute(ex1.program, cache.params, x))
        _same((got,), (execute(ex1.program, cache.params, x,
                               plan=ex1.plan),))
    qcache = _graph_cache(DEEP, "int8", (2,))
    q0 = qcache.get(2, 64)
    assert q0.replay_launches.get("int8_matmul")
    qcache.pin_fp(2, 64)
    q1 = qcache.get(2, 64)
    assert q1 is not q0 and q1.graph is not None and not q1._runs_int8
    assert not any(n in q1.replay_launches for n in (
        "int8_matmul", "group_agg_int8", "mbconv_fused_int8",
        "supersite_fused_int8", "dsconv_fused_int8"))
    got, _ = _replayed(q1, qcache.params, x)
    with torch.inference_mode():
        _same((got,), (execute(q1.program, qcache.params, x,
                               plan=q1.plan),))


def test_failed_capture_is_a_negative_cached_build_failure(cuda,
                                                          monkeypatch):
    """A host wait inside the forward (legal eagerly, refused while a
    stream captures) makes the capture fail: a typed ``ExecutorError``,
    negative-cached, nothing inserted; served requests end "failed",
    none completes on eager launches, and the real failure moves no
    ladder (level 2 would serve the reference path's plain PyTorch)."""
    import repro_torch.core.program as program_mod
    real_gap = program_mod._gap

    def syncing_gap(y):
        torch.cuda.current_stream().synchronize()
        return real_gap(y)

    monkeypatch.setattr(program_mod, "_gap", syncing_gap)
    clock = ManualClock()
    cache = _graph_cache(B1_SMOKE, "fp", (1,), clock=clock, neg_ttl_s=10.0)
    with pytest.raises(ExecutorError, match="capture"):
        cache.get(1, 64)
    assert len(cache) == 0 and cache._donor_plans == {}
    assert cache.telemetry.counters["executor_build_failed"] == 1
    with pytest.raises(ExecutorError, match="negative-cached"):
        cache.get(1, 64)
    sched = MicroBatchScheduler(cache, cache.params, clock=clock,
                                max_retries=2, backoff_ms=0.0)
    reqs = [Request(i, np.zeros((64, 64, 3), np.float32)) for i in range(2)]
    for r in reqs:
        sched.submit(r)
    for _ in range(8):
        if not sched.outstanding():
            break
        sched.step(drain=True)
        sched.finalize()
        clock.advance(20.0)
    assert [r.status for r in reqs] == ["failed", "failed"]
    assert all(isinstance(r.error, ExecutorError) and r.logits is None
               and not r.error.injected for r in reqs)
    assert cache.degradation(1, 64) is None
    assert cache.telemetry.counters["real_failures"] == sum(
        r.retries for r in reqs)
    assert "degraded" not in cache.telemetry.counters
    assert "completed" not in cache.telemetry.counters or \
        cache.telemetry.counters["completed"] == 0
    # the card still works once the fault is gone, on the fused plan
    monkeypatch.setattr(program_mod, "_gap", real_gap)
    clock.advance(20.0)
    ex = cache.get(1, 64)
    assert ex.graph is not None and ex.plan is not None
    assert ex.fused_sites and ex.degraded is None


def test_recapture_after_the_pool_lost_its_last_graph(cuda):
    """A ladder move (or an eviction) that drops the last graph of the
    cache's pool: PyTorch refuses a capture into a pool whose graphs are
    all gone, so the next build captures into a new pool, and its replay
    equals its eager forward."""
    import gc

    cache = _graph_cache(B1_SMOKE, "fp", (2,))
    pool = cache.pool
    assert cache.get(2, 64).graph is not None
    cache.degrade(2, 64, site="S2.mb0")
    gc.collect()
    ex = cache.get(2, 64)
    assert ex.graph is not None and cache.pool != pool
    x = _rand(np.random.default_rng(6), cuda, 2, 64, 64, 3)
    with torch.inference_mode():
        _same((ex(cache.params, x),), (execute(ex.program, cache.params, x,
                                               plan=ex.plan),))
    cache = _graph_cache(B1_SMOKE, "fp", (1, 2), capacity=1)
    cache.get(1, 64)
    cache.get(2, 64)            # evicts bucket 1; bucket 2's graph lives
    pool = cache.pool
    assert cache.get(1, 64).graph is not None and cache.pool == pool


def test_real_launch_failure_on_the_card_moves_no_ladder(cuda,
                                                         monkeypatch):
    """A ``KernelLaunchError`` that no ``FaultPlan`` injected retries the
    same executor and never replans onto the reference path; the same
    error injected by a plan moves the key to level 1."""
    clock = ManualClock()
    cache = _graph_cache(B1_SMOKE, "fp", (2,), clock=clock)
    ex = cache.get(2, 64)
    real_call = port_executors.Executor.__call__
    fails = [KernelLaunchError("launch failed", site="S2.mb0")
             for _ in range(2)]

    def flaky(self, params, x):
        if fails:
            raise fails.pop(0)
        return real_call(self, params, x)

    monkeypatch.setattr(port_executors.Executor, "__call__", flaky)
    sched = MicroBatchScheduler(cache, cache.params, clock=clock,
                                backoff_ms=0.0)
    reqs = [Request(i, np.zeros((64, 64, 3), np.float32)) for i in range(2)]
    for r in reqs:
        sched.submit(r)
    for _ in range(8):
        if not sched.outstanding():
            break
        sched.step(drain=True)
        sched.finalize()
    assert [r.status for r in reqs] == ["completed", "completed"], [
        (r.status, r.error) for r in reqs]
    assert [r.retries for r in reqs] == [2, 2]
    assert cache.degradation(2, 64) is None and cache.get(2, 64) is ex
    assert cache.telemetry.counters["real_failures"] == 2
    monkeypatch.setattr(port_executors.Executor, "__call__", real_call)
    faults = FaultPlan(FaultSpec("kernel.launch", times=2, site="S2.mb0"))
    drill = _graph_cache(B1_SMOKE, "fp", (2,), clock=clock, faults=faults)
    sched = MicroBatchScheduler(drill, drill.params, clock=clock,
                                backoff_ms=0.0)
    reqs = [Request(i, np.zeros((64, 64, 3), np.float32)) for i in range(2)]
    for r in reqs:
        sched.submit(r)
    for _ in range(8):
        if not sched.outstanding():
            break
        sched.step(drain=True)
        sched.finalize()
    assert [r.status for r in reqs] == ["completed", "completed"], [
        (r.status, r.error) for r in reqs]
    state = drill.degradation(2, 64)
    assert state.level == 1 and state.demoted == {"S2.mb0"}
    assert "real_failures" not in drill.telemetry.counters


def test_replays_from_two_streams_keep_their_logits(cuda):
    """Two keys of one cache replayed at once from two threads, each on
    its own stream, behind a sleep on each: the graphs share one memory
    pool, so the cache runs them one at a time on its own stream; every
    replay returns the logits of its own eager forward."""
    import threading

    cache = _graph_cache(B1_SMOKE, "fp", (2, 4))
    exs = [cache.get(2, 64), cache.get(4, 64)]
    xs = [[_rand(np.random.default_rng(20 + 4 * k + i), cuda, ex.key.batch,
                 64, 64, 3) for i in range(4)] for k, ex in enumerate(exs)]
    outs = [None, None]
    torch.cuda.synchronize()

    def serve(k):
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            torch.cuda._sleep(50_000_000)
            outs[k] = [exs[k](cache.params, x) for x in xs[k]]
            stream.synchronize()

    threads = [threading.Thread(target=serve, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k, ex in enumerate(exs):
        with torch.inference_mode():
            wants = [execute(ex.program, cache.params, x, plan=ex.plan)
                     for x in xs[k]]
        _same(outs[k], wants)


def test_scalar_constants_exist_before_capture(cuda, monkeypatch):
    """The eager warm-up makes every ``scalar`` constant; the capture
    makes none (one first made while capturing would hold garbage until
    the first replay, so ``scalar`` refuses it)."""
    calls = []
    real = port_executors.execute

    def spy(*a, **kw):
        n0 = len(port_device._SCALARS)
        capturing = torch.cuda.is_current_stream_capturing()
        out = real(*a, **kw)
        calls.append((capturing, n0, len(port_device._SCALARS)))
        return out

    monkeypatch.setattr(port_executors, "execute", spy)
    for precision in ("fp", "int8"):
        calls.clear()
        _graph_cache(B1_SMOKE, precision, (3,)).get(3, 96)
        assert [c[0] for c in calls] == [False, True]
        assert calls[1][1] == calls[1][2]
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    known = port_device.scalar(6.0, torch.device("cuda:0"))
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            assert port_device.scalar(6.0, torch.device("cuda:0")) is known
            with pytest.raises(RuntimeError, match="capture"):
                port_device.scalar(12345.5, torch.device("cuda:0"))
        finally:
            graph.capture_end()


# ---------------------------------------------------------------------------
# sharded executors: one graph per mesh member; per-site CUDA events
# ---------------------------------------------------------------------------

MESH4 = ("cuda:0",) * 4


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_sharded_members_capture_their_own_graphs(cuda, precision):
    """Four fault domains on one card at bucket 8: one graph per member
    (local batch 2), each on its own stream, all in the card's one pool;
    each capture issued the launches of one local-batch forward; the
    replay equals the members' eager forwards bit for bit, and the
    unsharded executor's logits (FIX8 bit for bit, fp32 within 1e-5 of
    max|logit|)."""
    cache = _graph_cache(B1_SMOKE, precision, (8,), devices=MESH4)
    single = _graph_cache(B1_SMOKE, precision, (2, 8))
    ex = cache.get(8, 64)
    assert ex.device_ids == (0, 1, 2, 3) and ex.shard.local_batch == 2
    assert len({id(g) for g in ex.graphs}) == 4 and None not in ex.graphs
    assert len({m.stream for m in ex.members}) == 4
    assert len({m.pool for m in ex.members}) == 1
    per = single.get(2, 64).replay_launches
    assert ex.member_launches == [per] * 4
    assert ex.replay_launches == {k: 4 * v for k, v in per.items()}
    x = _rand(np.random.default_rng(30), cuda, 8, 64, 64, 3)
    got, added = _replayed(ex, cache.params, x)
    assert added == {}
    with torch.inference_mode():
        eager = torch.cat([execute(ex.program, cache.params,
                                   x[2 * i:2 * i + 2], plan=ex.plan)
                           for i in range(4)])
    _same((got,), (eager,))
    ref = single.get(8, 64)(single.params, x)
    if precision == "int8":
        _same((got,), (ref,))
    else:
        d = (got - ref).abs().max().item()
        assert d <= 1e-5 * max(1.0, ref.abs().max().item()), d
    partial, _ = _replayed(ex, cache.params, x[:3])
    with torch.inference_mode():
        padded = torch.cat([x[:3], x.new_zeros((5, 64, 64, 3))])
        want = torch.cat([execute(ex.program, cache.params,
                                  padded[2 * i:2 * i + 2], plan=ex.plan)
                          for i in range(4)])
    _same((partial,), (want,))


def test_sharded_member_capture_failure_is_typed(cuda, monkeypatch):
    """A capture that fails on the third member fails the build with a
    typed ``ExecutorError`` naming it: nothing is cached and nothing
    serves the mesh eagerly; once the fault is gone the build captures
    every member into a fresh pool."""
    real = port_executors.execute
    captures = []

    def spy(*a, **kw):
        if torch.cuda.is_current_stream_capturing():
            captures.append(1)
            if len(captures) == 3:
                torch.cuda.current_stream().synchronize()
        return real(*a, **kw)

    monkeypatch.setattr(port_executors, "execute", spy)
    clock = ManualClock()
    cache = _graph_cache(B1_SMOKE, "fp", (4,), devices=MESH4, clock=clock)
    pool = cache.pool
    with pytest.raises(ExecutorError, match="member 2, mesh device 2"):
        cache.get(4, 64)
    assert len(cache) == 0 and cache.telemetry.counters[
        "executor_build_failed"] == 1
    monkeypatch.setattr(port_executors, "execute", real)
    clock.advance(10.0)
    ex = cache.get(4, 64)
    assert None not in ex.graphs and cache.pool != pool
    x = _rand(np.random.default_rng(31), cuda, 4, 64, 64, 3)
    with torch.inference_mode():
        eager = torch.cat([execute(ex.program, cache.params, x[i:i + 1],
                                   plan=ex.plan) for i in range(4)])
    _same((ex(cache.params, x),), (eager,))


def test_sharded_dropout_on_the_card(cuda):
    """An injected ``device.dropout`` on domain 3 before the replay: the
    mesh shrinks 4 -> 3, bucket 4 is recaptured 2-wide, every request
    completes with the healthy mesh's logits, the ladder never moves;
    with all four lost, the requests fail typed ``MeshExhausted``."""
    clock = ManualClock()
    faults = FaultPlan(FaultSpec("device.dropout", times=1, device=3))
    cache = _graph_cache(B1_SMOKE, "int8", (4,), devices=MESH4,
                         clock=clock, faults=faults)
    sched = MicroBatchScheduler(cache, cache.params, clock=clock,
                                faults=faults, backoff_ms=0.0)
    imgs = np.random.default_rng(32).standard_normal(
        (4, 64, 64, 3)).astype(np.float32)
    reqs = [Request(i, imgs[i]) for i in range(4)]
    for r in reqs:
        sched.submit(r)
    for _ in range(8):
        if not sched.outstanding():
            break
        sched.step(drain=True)
        sched.finalize()
    assert [r.status for r in reqs] == ["completed"] * 4
    tel = cache.telemetry.counters
    assert tel["device_lost"] == 1 and tel["mesh_shrunk"] == 1
    assert cache.degradation(4, 64) is None
    ex = cache.get(4, 64)
    assert ex.device_ids == (0, 1) and None not in ex.graphs
    healthy = _graph_cache(B1_SMOKE, "int8", (4,), devices=MESH4)
    want = healthy.get(4, 64)(healthy.params, torch.from_numpy(imgs).cuda())
    assert np.array_equal(np.stack([r.logits for r in reqs]),
                          want.cpu().numpy())
    for d in (0, 1, 2):
        faults.specs.append(FaultSpec("device.dropout", times=1, device=d))
    late = [Request(10 + i, imgs[i]) for i in range(2)]
    for r in late:
        sched.submit(r)
    for _ in range(8):
        if not sched.outstanding():
            break
        sched.step(drain=True)
        sched.finalize()
    assert [r.status for r in late] == ["failed"] * 2
    assert all(type(r.error).__name__ == "MeshExhausted" for r in late)
    assert cache.mesh_exhausted and sched.outstanding() == 0


def test_profile_execute_times_sites_by_cuda_events(cuda):
    """``profile_execute`` on the card times each site by a pair of CUDA
    events (no host clock): every site of the program recorded once per
    repeat, every window positive, every drift ratio finite."""
    from repro_torch.obs.profile import drift_report, profile_execute
    params = init_efficientvit(torch.Generator().manual_seed(0), DEEP,
                               "cuda")
    program = lower(DEEP, batch=2)
    plan = plan_program(program, params, autotune=False)
    assert plan.groups
    x = _rand(np.random.default_rng(33), cuda, 2, 64, 64, 3)
    before = _launches()
    prof = profile_execute(program, params, x, plan=plan, repeats=2,
                           warmup=1)
    added = {n: v - before[n] for n, v in _launches().items()
             if v != before[n]}
    assert prof.events and prof.repeats == 2
    assert set(prof.records) == {s.name for s in program.sites}
    assert all(t > 0 for v in prof.records.values() for t in v)
    # the warm-up ran the groups; the two profiled forwards ran none
    assert added["supersite_fused"] == len(plan.groups)
    rep = drift_report(program, prof, plan=plan)
    assert rep.finite()


# ---------------------------------------------------------------------------
# the planner's tuners, B2 / B3 shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,C,M,F,stride", [
    (1, 7, 512, 2048, 512, 1), (8, 7, 512, 2048, 512, 1),
    (2, 7, 24, 1800, 72, 1), (2, 14, 64, 2048, 40, 2)])
def test_mbconv_int8_passes_stream_a_deep_k(cuda, B, H, C, M, F, stride):
    """A PW2 of K = M above ~1.7 KB (B3's S4: 2048) stages each weight
    tile in K chunks of 512 (a ragged last chunk at 1800, columns past F
    = 72 and 40, stride 2): both variants on the passes EQUAL to the
    plain version, and the planner fuses B3's S4 MBConv sites."""
    from repro_torch.kernels.mbconv.kernel import GEMM_KCHUNK, panel_pitch
    assert (64 + 64) * panel_pitch(M) > SMEM_LIMIT
    assert mbconv_int8_pass_smem(H, H, C, M, F, stride) >= \
        64 * panel_pitch(M) + 64 * panel_pitch(GEMM_KCHUNK)
    g = torch.Generator().manual_seed(M + F + B)
    args = _mbconv_int8_args(g, cuda, B, H, C, M, F)
    assert mbconv_int8_path(H, H, C, M, F, stride, B)["path"] == "passes"
    _check_mbconv_int8(args, stride, [("passes", 0)])
    params = init_efficientvit(torch.Generator().manual_seed(0), B3, "cuda")
    plan = plan_program(lower(B3, batch=B), quantize_efficientvit(params))
    assert all(d.fused for d in plan.decisions.values())


def test_a_sweep_on_the_card_picks_a_candidate_and_caches(cuda):
    """``plan_program`` on the card with a cold cache sweeps each fp
    family (CUDA events, random inputs of the site's shape): every frozen
    block is one of the site's candidates, no candidate is disqualified,
    and a second plan, the in-process cache dropped, reads the file and
    sweeps nothing."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.registry import get_kernel
    params = init_efficientvit(torch.Generator().manual_seed(0), B1, "cuda")
    program = lower(B1, batch=2)
    n, bad = autotune.SWEEP_COUNT, autotune.DISQUALIFIED
    plan = plan_program(program, params)
    assert autotune.SWEEP_COUNT > n and autotune.DISQUALIFIED == bad
    sites = {s.name: s for s in program.fusible()}
    for d in plan.decisions.values():
        assert dict(d.blocks) in [dict(c) for c in get_kernel(
            d.kind, "fp").candidates(sites[d.name])], d.name
    for g in plan.groups.values():
        sup = SuperSite.of(program, g.members, name=g.name)
        assert dict(g.blocks) in get_kernel("supersite", "fp").candidates(sup)
    for e in autotune.SWEEP_LOG[-3:]:
        assert all(t is not None and t > 0 for _, t, _ in e["times"])
        assert e["key"][-1] == f"backend=cuda:{torch.cuda.get_device_name()}"
    autotune.clear_memory_cache()
    n = autotune.SWEEP_COUNT
    again = plan_program(program, params)
    assert autotune.SWEEP_COUNT == n
    assert [d.to_dict() for d in again.decisions.values()] == \
        [d.to_dict() for d in plan.decisions.values()]
    off = plan_program(program, params, autotune=False)
    for d in off.decisions.values():
        assert dict(d.blocks) == dict(get_kernel(d.kind, "fp").candidates(
            sites[d.name])[0])


def _site_case(cuda, site, g):
    """Random inputs of a fp site's kernel -> (kernel(blocks), plain())."""
    B, H, W, C = site.in_shape
    F = site.out_shape[-1]
    if site.kind == "dsconv":
        a = (_rand(g, cuda, B, H, W, C), _rand(g, cuda, 3, 3, C, scale=.3),
             _rand(g, cuda, C), _rand(g, cuda, C, F, scale=C ** -0.5),
             _rand(g, cuda, F))
        return (lambda b: dsconv_fused(*a, stride=site.stride, **b),
                lambda: dsconv_ref(*a, stride=site.stride))
    if site.kind == "mbconv":
        M = site.attrs["mid"]
        a = (_rand(g, cuda, B, H, W, C), _rand(g, cuda, C, M,
                                              scale=C ** -0.5),
             _rand(g, cuda, M), _rand(g, cuda, 3, 3, M, scale=.3),
             _rand(g, cuda, M), _rand(g, cuda, M, F, scale=M ** -0.5),
             _rand(g, cuda, F))
        return (lambda b: mbconv_fused(*a, stride=site.stride, **b),
                lambda: mbconv_ref(*a, stride=site.stride))
    h, d = site.attrs["heads"], site.attrs["head_dim"]
    q, k, v = _msa_qkv(g, cuda, B, H * W, h, site.attrs["n_branches"], d)
    return (lambda b: relu_attn_noncausal(q, k, v, **b),
            lambda: relu_attn_noncausal_ref(q, k, v))


@pytest.mark.parametrize("cfg,names", [
    (B1, ("stem.ds0", "S1.mb1", "S3.down", "S3.evit0.msa", "S4.evit0.mb",
          "S4.evit0.msa")),
    (B3, ("stem.ds0", "S1.mb0", "S2.mb1", "S3.evit0.msa", "S4.evit0.mb",
          "S4.evit0.msa"))])
def test_every_candidate_launches_and_equals_plain(cuda, cfg, names):
    """Every candidate the tuners time, at B1@224 and B3@224 sites of
    each fp kind (batch 2) and at a chain of each: one launch each, within
    1e-4 of the plain version."""
    from repro_torch.kernels.registry import get_kernel
    g = np.random.default_rng(len(names))
    program = lower(cfg, batch=2)
    sites = {s.name: s for s in program.fusible()}
    for name in names:
        site = sites[name]
        kfn, pfn = _site_case(cuda, site, g)
        ref = pfn()
        for cand in get_kernel(site.kind, "fp").candidates(site):
            _close(kfn(cand), ref)
    params = init_efficientvit(torch.Generator().manual_seed(0), cfg, "cuda")
    for members in (("S1.mb0", "S1.mb1"), ("S2.mb1", "S2.mb2")):
        sup = SuperSite.of(program, members)
        pack = pack_weights(params, sup, "fp")
        x = _rand(g, cuda, *sup.in_shape)
        ref = None
        for cand in get_kernel("supersite", "fp").candidates(sup):
            geom = make_fp_geom(sup, pack, cand["block_rows"],
                                cand["block_m"])
            got = supersite_fused(x, pack.fp, geom=geom)
            ref = supersite_ref(x, pack.fp, geom=geom) if ref is None else ref
            _close(got, ref)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("N,h", [(196, 6), (49, 12), (196, 8), (49, 16)])
def test_relu_attn_at_head_dim_32(cuda, batch, N, h):
    """The attention core of B2 and B3 at 224 px (d = 32, the generic
    instance), written into the projection's map as the MSA serves it:
    within 1e-4 of the plain version, one launch."""
    q, k, v = _msa_qkv(np.random.default_rng(N * h + batch), cuda, batch, N,
                       h, 2, d=32)
    buf = torch.empty((batch, N, 2 * h * 32), device=cuda)
    n = relu_attn_noncausal.launches
    relu_attn_noncausal(q, k, v, out=_proj_view(buf, batch, N, 2, h, 32))
    assert relu_attn_noncausal.launches == n + 1
    want = torch.empty_like(buf)
    relu_attn_noncausal_ref(q, k, v, out=_proj_view(want, batch, N, 2, h, 32))
    _close(buf, want)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("H,C", [(14, 576), (7, 1152), (14, 768), (7, 1536)])
def test_group_agg_int8_at_d32(cuda, batch, H, C):
    """The grouped int8 aggregation of B2 and B3 at 224 px (groups of 32):
    on its path and on the two launches, EQUAL to the plain version."""
    g = torch.Generator().manual_seed(C + H + batch)
    args, pw, tail = _group_agg_args(g, cuda, batch, H, H, C, 5, d=32)
    ref = group_agg_int8_ref(*args, block_diag(pw), *tail)
    n = group_agg_int8.launches
    _same((group_agg_int8(*args, pw, *tail),), (ref,))
    assert group_agg_int8.launches == n + 1
    _same((_group_agg(*args, pw, *tail, path="two-launch"),), (ref,))


@pytest.mark.parametrize("precision", ["fp", "int8"])
def test_artifact_warm_cache_runs_no_sweep(cuda, precision, tmp_path,
                                           monkeypatch):
    """B1 searched on the host for bucket 8 and a 224 / 256 px trace,
    then served from a fresh tuner cache: building every (bucket, resolution) executor of
    the artifact sweeps nothing, each plan equals the artifact decision
    for decision, and the batch-8 replay equals its eager forward bit for
    bit at both resolutions."""
    from repro_torch.kernels import autotune
    from repro_torch.search import search
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE",
                       str(tmp_path / "fresh.json"))
    autotune.clear_memory_cache()
    params = init_efficientvit(torch.Generator().manual_seed(0), B1, "cuda")
    tree = params if precision == "fp" else quantize_efficientvit(params)
    prec = "auto" if precision == "fp" else "int8"
    rng = np.random.default_rng(0)
    trace = [(0.002 * i, 224 if rng.random() < 0.75 else 256)
             for i in range(32)]
    art = search(B1, tree, trace, buckets=(8,), precision=prec,
                 deadline_ms=20.0, seed=0, iters=8)
    assert art.objective <= art.default_objective
    assert art.buckets == (8,) and art.resolutions == (224, 256)
    n = autotune.SWEEP_COUNT
    cache = ExecutorCache(tree, B1, precision=prec, device="cuda",
                          artifact=art)
    for b in art.buckets:
        for r in art.resolutions:
            assert [d.to_dict() for d in cache.get(b, r).plan.decisions
                    .values()] == art.decisions_for(b, r), (b, r)
    assert autotune.SWEEP_COUNT == n
    for r in (224, 256):
        ex = cache.get(8, r)
        x = _rand(np.random.default_rng(r), cuda, 8, r, r, 3)
        got = ex(cache.params, x)
        with torch.inference_mode():
            want = execute(ex.program, cache.params, x, plan=ex.plan)
        _same((got,), (want,))


# ---------------------------------------------------------------------------
# the LM serving path: the layers and the engine on the card, the two
# scans' kernels against the reference forward's plain scans
# ---------------------------------------------------------------------------

def _lm_close(got, ref, tol):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= tol * max(1.0, ref.float().abs().max().item()), err


@pytest.mark.parametrize("S,dtype", [(768, torch.float32),
                                     (300, torch.float32),
                                     (768, torch.bfloat16)])
def test_lm_relu_linear_attention_layer_on_the_card(cuda, S, dtype):
    """GQA (4 kv heads under 8 heads of 64): the causal prefill launches
    ``relu_attn_causal`` once and matches the plain scan (fp32 within
    1e-4; bf16 within one bf16 step, 2^-7, of max|y|); the cache is the
    same plain computation on both paths."""
    from repro_torch.layers import attention as ta
    cfg = ta.AttnConfig(d_model=256, n_heads=8, n_kv=4, head_dim=64,
                        backend="relu_linear", dtype=dtype)
    gen = torch.Generator(device=cuda).manual_seed(0)
    p = ta.init_attention(gen, cfg, cuda)
    x = torch.randn((2, S, 256), generator=gen, device=cuda).to(dtype)
    relu_attn_causal.launches = 0
    y, cache = ta.attention(p, x, cfg, return_cache=True)
    assert relu_attn_causal.launches == 1
    yr, cr = ta.attention(p, x, cfg, return_cache=True, reference=True)
    assert relu_attn_causal.launches == 1
    _lm_close(y, yr, 1e-4 if dtype == torch.float32 else 2.0 ** -7)
    for k in cache:
        assert torch.equal(cache[k], cr[k])


@pytest.mark.parametrize("S", [512, 600, 2])
def test_lm_mamba2_layer_on_the_card(cuda, S):
    """The Mamba-2 prefill (64 heads of 64, state 64, chunk 256) launches
    ``ssd_chunked`` once and matches the plain scan within 1e-4; then a
    decode step from its cache on the card."""
    from repro_torch.layers import mamba2 as tm
    cfg = tm.Mamba2Config(d_model=2048, d_state=64, head_dim=64,
                          chunk=256)
    gen = torch.Generator(device=cuda).manual_seed(1)
    p = tm.init_mamba2(gen, cfg, cuda)
    x = torch.randn((1, S + 1, 2048), generator=gen, device=cuda)
    ssd_chunked.launches = 0
    y, cache = tm.mamba2(p, x[:, :S], cfg, return_cache=True)
    assert ssd_chunked.launches == 1
    yr, cr = tm.mamba2(p, x[:, :S], cfg, return_cache=True, reference=True)
    assert ssd_chunked.launches == 1
    _lm_close(y, yr, 1e-4)
    for k in cache:
        assert torch.equal(cache[k], cr[k])
    yd, _ = tm.mamba2_decode(p, x[:, S:], cache, cfg)
    yf = tm.mamba2(p, x, cfg, reference=True)
    _lm_close(yd, yf[:, S:], 1e-4)


def test_lm_engine_two_slots_on_the_card(cuda):
    """A narrow zamba2 (relu_linear; 4 Mamba layers, the shared block
    twice) served from 2 slots: every admission launches ``ssd_chunked``
    4 times and ``relu_attn_causal`` twice, decode neither; the served
    tokens equal the reference engine's (plain scans) wherever the
    reference's top-2 margin exceeds 1e-3 * max|logit|."""
    from repro_torch.configs import get_arch
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import (
        Request, ServeConfig, ServingEngine)
    cfg = get_arch("zamba2-1.2b").scaled(
        attn_backend="relu_linear", n_layers=4, shared_attn_every=2,
        d_model=256, n_heads=4, n_kv=4, head_dim=64, d_ff=512, vocab=1000,
        param_dtype="float32", compute_dtype="float32")
    params = build_model(cfg).init(0, device=cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (300, 17, 600)]

    def reqs():
        return [Request(rid=i, prompt=p, max_tokens=5)
                for i, p in enumerate(prompts)]

    served = {}
    for reference in (False, True):
        eng = ServingEngine(cfg, params, ServeConfig(max_slots=2,
                                                     max_len=1024),
                            device=cuda)
        if reference:
            eng.model = build_model(cfg, reference=True)
        relu_attn_causal.launches = ssd_chunked.launches = 0
        done = eng.run(reqs())
        torch.cuda.synchronize()
        n = 0 if reference else len(prompts)
        assert (ssd_chunked.launches, relu_attn_causal.launches) == \
            (4 * n, 2 * n)
        served[reference] = {r.rid: r.out_tokens for r in done}
        assert all(len(r.out_tokens) == 5 for r in done)
    model, ref_model = build_model(cfg), build_model(cfg, reference=True)
    for rid, toks in served[True].items():
        prompt = prompts[rid]
        ctx = torch.as_tensor(np.concatenate([prompt, toks[:-1]]),
                              device=cuda)
        for i, tok in enumerate(toks):
            t = ctx[None, :len(prompt) + i]
            lg, _ = model.prefill(params, {"tokens": t})
            lr, _ = ref_model.prefill(params, {"tokens": t})
            _lm_close(lg, lr, 1e-3)
            top2 = torch.topk(lr[0], 2).values
            if (top2[0] - top2[1]).item() <= 1e-3 * max(
                    1.0, lr.abs().max().item()):
                break
            assert served[False][rid][i] == tok, (rid, i)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N", [1, 257, 4096])
def test_relu_attn_causal_at_gemma3_head_width(cuda, N, dtype):
    """Gemma3-12B's global layers under relu_linear: 16 heads of 240 at
    batch 1 in chunks of 256 (one launch for one token, three past a
    chunk), against the plain version in the kernel's stages."""
    rng = np.random.default_rng(N)
    q, k, v = (_rand(rng, cuda, 16, N, 240).to(dtype) for _ in range(3))
    n = relu_attn_causal.launches
    got = relu_attn_causal(q, k, v, chunk=256)
    assert relu_attn_causal.launches == n + 1
    _close(got, relu_attn_causal_scan(q, k, v, chunk=256))


@pytest.mark.parametrize("name,kw", [
    ("granite-3-2b", {}), ("gemma3-12b", {}),
    ("gemma3-12b", {"attn_backend": "relu_linear"}), ("internvl2-1b", {}),
    ("zamba2-1.2b", {}), ("grok-1-314b", {"capacity_factor": 2.0}),
    ("kimi-k2-1t-a32b", {"capacity_factor": 2.0})])
def test_lm_decode_equals_reprefill_on_the_card(cuda, name, kw):
    """Each family with KV caches at its smoke size (gemma3: window 32),
    fp32 with fp32 caches, served from 2 slots with 3 ragged prompts (45
    and 33 tokens wrap gemma3's rings): every decode step's logits equal
    the last row of a fresh prefill of the prompt and the tokens chosen
    before it within 1e-4 * max(1, max|logit|).  The MoE smoke models
    (4 experts top-2) run at capacity factor 2 = n_experts / top_k, so
    no prefill drops a token that decode keeps."""
    import dataclasses

    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models.registry import build_model
    from repro_torch.serving.engine import (
        Request, ServeConfig, ServingEngine)
    cfg = smoke_variant(get_arch(name)).scaled(kv_dtype="float32", **kw)
    model = build_model(cfg)
    params = model.init(0, device=cuda)
    eng = ServingEngine(cfg, params, ServeConfig(max_slots=2, max_len=64),
                        device=cuda)
    steps = []

    def decode(p, c, t, pos):
        logits, c = model.decode(p, c, t, pos)
        steps.append(([r.rid if r is not None else None
                       for r in eng.slot_req], logits))
        return logits, c

    eng.model = dataclasses.replace(model, decode=decode)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (20, 45, 33)]
    done = eng.run([Request(rid=i, prompt=p, max_tokens=6)
                    for i, p in enumerate(prompts)])
    assert sorted(len(r.out_tokens) for r in done) == [6, 6, 6]
    toks = {r.rid: r.out_tokens for r in done}
    seen = {rid: 0 for rid in toks}
    for rids, logits in steps:
        for i, rid in enumerate(rids):
            if rid is None:
                continue
            seen[rid] += 1
            ctx = np.concatenate([prompts[rid], toks[rid][:seen[rid]]])
            ref, _ = model.prefill(params, {"tokens": torch.as_tensor(
                ctx, device=cuda)[None]})
            _lm_close(logits[i], ref[0], 1e-4)
    assert seen == {rid: 5 for rid in toks}


# ---------------------------------------------------------------------------
# the MoE layer, the W8 transform and the encoder-decoder on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,k,cf,B,S,groups", [
    (4, 2, 2.0, 2, 16, 1), (64, 1, 1e-9, 1, 2048, 1), (8, 2, 1.25, 4, 300, 1),
    (4, 2, 1.0, 16, 1, 16), (4, 2, 1.0, 16, 1, 1), (384, 8, 1.0, 8, 1, 8)])
def test_lm_moe_dense_on_the_card(cuda, E, k, cf, B, S, groups):
    """``moe_dense`` on the card against itself on the CPU, fp32: the same
    routes and dropped rows, y within 1e-5 * max(1, max|y|), aux within
    1e-5 of it; with capacity drops (one expert of 64 per token at the
    capacity floor of 8) and the 16-row slot isolation (one group per
    row: no row zero; one group: rows 8-15 zero)."""
    from repro_torch.layers import moe as tmoe
    cfg = tmoe.MoeConfig(d_model=64, d_ff=128, n_experts=E, top_k=k,
                         capacity_factor=cf)
    gen = torch.Generator().manual_seed(E + B)
    p = tmoe.init_moe(gen, cfg, "cpu")
    x = torch.randn((B, S, 64), generator=gen)
    if S == 1:
        x = x[:1].expand(B, 1, 64).contiguous()    # one prompt per slot
    yc, ac = tmoe.moe_dense(p, x, cfg, groups)
    pg = {key: (v.to(cuda) if not isinstance(v, dict)
                else {kk: vv.to(cuda) for kk, vv in v.items()})
          for key, v in p.items()}
    yg, ag = tmoe.moe_dense(pg, x.to(cuda), cfg, groups)
    _, ic, _ = tmoe._route(x.reshape(groups, -1, 64), p["router"]["w"], cfg)
    _, ig, _ = tmoe._route(x.to(cuda).reshape(groups, -1, 64),
                           pg["router"]["w"], cfg)
    assert torch.equal(ic, ig.cpu())
    zc = (yc.reshape(B * S, -1) == 0).all(-1)
    assert torch.equal(zc, (yg.cpu().reshape(B * S, -1) == 0).all(-1))
    _lm_close(yg.cpu(), yc, 1e-5)
    assert torch.allclose(ag.cpu(), ac, rtol=1e-5, atol=0)
    if S == 1 and E == 4:
        assert list(torch.nonzero(zc).flatten()) == (
            [] if groups == 16 else list(range(8, 16)))


def test_lm_quantize_lm_params_on_the_card_is_bit_equal(cuda):
    """``quantize_lm_params`` of a kimi-k2 smoke tree (stacked experts,
    an embedding table, attention weights) on the card: bit-equal to the
    CPU's, leaf for leaf; the same on a bf16 stacked expert tensor of
    (2, 8, 512, 1024)."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.core.quantization import quantize_lm_params
    from repro_torch.models.registry import build_model
    cfg = smoke_variant(get_arch("kimi-k2-1t-a32b"))
    params = build_model(cfg).init(0, device="cpu")
    big = (torch.randn((2, 8, 512, 1024),
                       generator=torch.Generator().manual_seed(1)) * 0.02
           ).to(torch.bfloat16)
    params["extra"] = {"w_in": big}        # quantized as an expert tensor
    cpu = quantize_lm_params(params)
    card = quantize_lm_params(_tree_to(params, cuda))
    assert set(cpu["extra"]["w_in"]) == {"q", "scale"}

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
            return
        assert a.dtype == b.dtype, path
        assert torch.equal(a, b.cpu()), path

    walk(cpu, card)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def test_lm_seamless_decode_step_on_the_card(cuda):
    """One smoke Seamless (2 + 2 layers) prefill through the registry and
    a decode step on the card against the same on the CPU: the state's
    leaves within one bf16 step (2^-7) of max|leaf|, the logits within
    1e-2 * max(1, max|logit|) (bf16 state); and with fp32 state
    (``init_encdec_state(..., dtype=torch.float32)``) within 1e-4."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import encdec as ted
    from repro_torch.models.registry import build_model
    cfg = smoke_variant(get_arch("seamless-m4t-large-v2"))
    model = build_model(cfg)
    params = model.init(0, device="cpu")
    frames = torch.randn((2, 40, cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
    tok = torch.tensor([[3], [5]])
    batch = {"frames": frames, "tokens": torch.zeros((2, 8),
                                                      dtype=torch.long)}
    pc = _tree_to(params, cuda)
    sc = model.prefill(params, batch)
    sg = model.prefill(pc, _tree_to(batch, cuda))
    for key in ("ck", "cv"):
        _lm_close(sg["cross"][key].cpu(), sc["cross"][key], 2.0 ** -7)
    lc, _ = model.decode(params, sc, tok, 0)
    lg, _ = model.decode(pc, sg, tok.to(cuda), 0)
    _lm_close(lg.cpu(), lc, 1e-2)
    fc = ted.init_encdec_state(params, frames, cfg, 8, torch.float32)
    fg = ted.init_encdec_state(pc, frames.to(cuda), cfg, 8, torch.float32)
    lc, _ = ted.encdec_decode_step(params, fc, tok, 0, cfg)
    lg, _ = ted.encdec_decode_step(pc, fg, tok.to(cuda), 0, cfg)
    _lm_close(lg.cpu(), lc, 1e-4)



# ---------------------------------------------------------------------------
# training: the two scans under autograd on the card, flash attention,
# one train step of a narrow zamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,dtype", [(768, torch.float32),
                                     (300, torch.float32),
                                     (768, torch.bfloat16)])
def test_train_scan_gradients_on_the_card(cuda, S, dtype):
    """The relu_linear attention layer and the Mamba-2 layer launch their
    kernel once forward and none in the backward, and every input's and
    param's gradient matches autograd through the plain scan (fp32
    within 1e-4 * max(1, max|g|); bf16 inputs within 2^-6 of it): a
    launch has no ``grad_fn`` of its own, so a zero or missing gradient
    here means the autograd Function is not in the graph."""
    from repro_torch.common.tree import flatten_with_paths, map_with_path
    from repro_torch.layers import attention as ta
    from repro_torch.layers import mamba2 as tm
    gen = torch.Generator(device=cuda).manual_seed(2)
    acfg = ta.AttnConfig(d_model=256, n_heads=8, n_kv=4, head_dim=64,
                         backend="relu_linear", dtype=dtype)
    mcfg = tm.Mamba2Config(d_model=256, d_state=64, head_dim=64, chunk=256,
                           dtype=dtype)
    layers = ((relu_attn_causal, ta.init_attention(gen, acfg, cuda),
               lambda p, x, **kw: ta.attention(p, x, acfg, **kw)),
              (ssd_chunked, tm.init_mamba2(gen, mcfg, cuda),
               lambda p, x, **kw: tm.mamba2(p, x, mcfg, **kw)))
    tol = 1e-4 if dtype == torch.float32 else 2.0 ** -6
    for kernel, params, fn in layers:
        x = torch.randn((2, S, 256), generator=gen, device=cuda).to(dtype)
        grads = []
        for reference in (False, True):
            leaves = {k: v.detach().requires_grad_() for k, v in
                      flatten_with_paths(params) if v.is_floating_point()}
            xi = x.clone().requires_grad_()
            kernel.launches = 0
            y = fn(map_with_path(leaves.get, params), xi,
                   reference=reference)
            g = torch.autograd.grad((y.float() ** 2).sum(),
                                    [xi] + list(leaves.values()))
            assert kernel.launches == (0 if reference else 1)
            grads.append(g)
        for a, b in zip(*grads):
            assert bool(torch.isfinite(a).all())
            _lm_close(a, b, tol)


@pytest.mark.parametrize("S,window", [(2048, None), (1536, None),
                                      (2048, 512)])
def test_train_flash_attention_on_the_card(cuda, S, window):
    """``flash_attention`` forward and (dq, dk, dv) against autograd of
    the chunked softmax (``softmax_attention``) on the card, within 1e-4
    * max(1, max|.|): causal, a ragged S (one chunk) and a window."""
    from repro_torch.layers.attention import softmax_attention
    from repro_torch.layers.flash import flash_attention
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((1, S, 8, 64), generator=gen, device=cuda)
               .requires_grad_() for _ in range(3))
    pos = torch.arange(S, device=cuda)
    cot = torch.randn((1, S, 8, 64), generator=gen, device=cuda)
    out = flash_attention(q, k, v, pos, pos, True, window, 1024, 1024)
    ref = softmax_attention(q, k, v, pos, pos, causal=True, window=window)
    _lm_close(out, ref, 1e-4)
    for a, b in zip(torch.autograd.grad(out, (q, k, v), cot),
                    torch.autograd.grad(ref, (q, k, v), cot)):
        _lm_close(a, b, 1e-4)


def test_train_step_on_the_card(cuda, tmp_path):
    """A narrow zamba2 (relu_linear, bf16 params; 7 layers: a group and a
    tail) trains 12 steps through the ``Trainer`` with a failure at step
    7: finite losses, resumed from step 5, its latest checkpoint at 10,
    and each scan launched twice a layer a step (remat)."""
    from repro_torch.configs import get_arch
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.runtime.trainer import (
        Trainer, TrainerConfig, make_failure_hook)
    cfg = get_arch("zamba2-1.2b").scaled(
        attn_backend="relu_linear", n_layers=7, d_model=256, n_heads=4,
        n_kv=4, d_ff=512, vocab=512)
    tcfg = TrainerConfig(total_steps=12, ckpt_every=5,
                         ckpt_dir=str(tmp_path), log_every=100)
    tr = Trainer(cfg, DataConfig(vocab=512, seq_len=300, global_batch=4),
                 tcfg, failure_hook=make_failure_hook([7]))
    relu_attn_causal.launches = ssd_chunked.launches = 0
    out = tr.run()
    assert len(out["losses"]) == 7 + 7
    assert all(np.isfinite(out["losses"]))
    assert ssd_chunked.launches == 14 * 7 * 2
    assert relu_attn_causal.launches == 14 * 1 * 2
    from repro_torch.checkpoint.checkpoint import latest_step
    assert latest_step(str(tmp_path)) == 10


@pytest.fixture
def nccl_world(cuda):
    """A world of one rank on NCCL, in process, and its (1, 1) mesh; the
    group is destroyed after the test (a live group would put every later
    ``Trainer`` on a mesh)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def test_dist_collectives_at_world_1(nccl_world):
    """Each collective at axis size 1 returns what its ``jax.lax``
    counterpart does there: its input (``ppermute`` [(0, 0)] too)."""
    from repro_torch.distributed import collectives as C
    mesh = nccl_world
    x = torch.randn(8, 12, device="cuda")
    for axes in ("data", "model", ("data", "model")):
        assert C.axis_index(axes, mesh) == 0
        assert C.axis_size(axes, mesh) == 1
        for op in (C.psum, C.pmean, C.pmax):
            assert torch.equal(op(x, axes, mesh), x)
        for ax in (0, 1):
            assert torch.equal(C.all_gather(x, axes, axis=ax, mesh=mesh), x)
    for s, c in ((0, 1), (1, 0)):
        assert torch.equal(C.all_to_all(x, "model", s, c, mesh=mesh), x)
    assert torch.equal(C.ppermute(x, "model", [(0, 0)], mesh=mesh), x)
    xg = x.clone().requires_grad_()
    (g,) = torch.autograd.grad(C.all_gather(xg, "data", axis=0,
                                            mesh=mesh).sum(), xg)
    assert torch.equal(g, torch.ones_like(x))


def test_dist_compressed_psum_formula(nccl_world):
    """At world 1 ``compressed_psum`` is its formula, bit for bit."""
    from repro_torch.optim.compression import compressed_psum
    g = torch.randn(4096, 4096, device="cuda")
    out = compressed_psum(g, "data", nccl_world)
    one = torch.ones((), device="cuda")
    scale = torch.clamp(g.abs().amax() / (127.0 * one), min=1e-30)
    want = (torch.round(g / scale).to(torch.int32).float() * scale) / one
    assert out.dtype == g.dtype and torch.equal(out, want)


def test_dist_sharded_step_at_world_1(nccl_world):
    """A smoke zamba2 (relu_linear: both scans) step through the sharded
    ``make_train_step`` on a (1, 1) NCCL mesh equals the single-device
    step: the loss within 1e-6 relative, every param within 1e-5 *
    max(1, max|p|); the scans launch in both."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.partition import (
        make_ctx, match_partition_rules, shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch.steps import default_opt_cfg, make_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init
    cfg = smoke_variant(get_arch("zamba2-1.2b")).scaled(
        attn_backend="relu_linear")
    model = build_model(cfg)
    opt_cfg = default_opt_cfg(cfg)
    params = model.init(0, "cuda")
    opt = adamw_init(params, opt_cfg)
    g = torch.Generator(device="cuda").manual_seed(3)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=g,
                              device="cuda") for k in ("tokens", "targets")}
    ctx = make_ctx(nccl_world)
    specs = match_partition_rules(LM_RULES, params, ctx)
    opt_specs = {"step": P(), "m": specs, "v": specs, "master": specs}
    ssd_chunked.launches = relu_attn_causal.launches = 0
    p1, _, l1 = make_train_step(model, opt_cfg)(params, opt, batch)
    single = (ssd_chunked.launches, relu_attn_causal.launches)
    step = make_train_step(model, opt_cfg, ctx=ctx, specs=specs)
    p2, _, l2 = step(shard_tree(params, specs, nccl_world),
                     shard_tree(opt, {k: opt_specs[k] for k in opt},
                                nccl_world), batch)
    assert single[0] > 0 and single[1] > 0
    assert (ssd_chunked.launches, relu_attn_causal.launches) == (
        2 * single[0], 2 * single[1])
    assert abs(float(l1) - float(l2)) <= 1e-6 * abs(float(l1))
    for (path, a), (_, b) in zip(flatten_with_paths(p1),
                                 flatten_with_paths(p2)):
        assert a.shape == b.shape, path
        assert float((a - b).abs().max()) <= 1e-5 * max(
            1.0, float(a.abs().max())), path


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b"])
def test_tp_split_path_at_world_1_bit_equal(nccl_world, arch):
    """The tensor-parallel path (``distributed/tp.py``) on a (1, 1) NCCL
    mesh, where ``model`` splits nothing, equals the unsharded steps bit
    for bit: the sharded gradient's loss and every gradient leaf against
    ``value_and_grad(model.loss)``, the sharded prefill's logits and
    caches and two sharded decode steps' against ``model.prefill`` /
    ``model.decode``.  Smoke widths, fp32 caches; zamba2 on relu_linear
    (both scans launch)."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.distributed.partition import (
        make_ctx, match_partition_rules, shard_tree)
    from repro_torch.distributed.rules import CACHE_RULES, LM_RULES
    from repro_torch.launch.steps import (
        make_prefill_step, make_serve_step, sharded_value_and_grad,
        value_and_grad)
    from repro_torch.models.registry import build_model
    cfg = smoke_variant(get_arch(arch)).scaled(kv_dtype="float32")
    if arch == "zamba2-1.2b":
        cfg = cfg.scaled(attn_backend="relu_linear")
    model = build_model(cfg)
    params = model.init(0, "cuda")
    g = torch.Generator(device="cuda").manual_seed(5)
    batch = {k: torch.randint(0, cfg.vocab, (4, 64), generator=g,
                              device="cuda") for k in ("tokens", "targets")}
    ctx = make_ctx(nccl_world)
    specs = match_partition_rules(LM_RULES, params, ctx)
    blocks = shard_tree(params, specs, nccl_world)
    ssd_chunked.launches = relu_attn_causal.launches = 0
    l1, g1 = value_and_grad(model.loss)(params, batch)
    l2, g2, _ = sharded_value_and_grad(model, ctx, specs)(blocks, batch)
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g1),
                                                 tree_leaves(g2)))
    if arch == "zamba2-1.2b":
        assert ssd_chunked.launches > 0 and relu_attn_causal.launches > 0
    tokens = batch["tokens"][:, :30]
    with torch.no_grad():
        lg1, c1 = model.prefill(params, {"tokens": tokens})
    c_specs = match_partition_rules(CACHE_RULES, c1, ctx)
    lg2, c2 = make_prefill_step(model, ctx=ctx, specs=specs,
                                cache_specs=c_specs)(blocks,
                                                     {"tokens": tokens})
    assert torch.equal(lg1, lg2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c1),
                                                 tree_leaves(c2)))
    room = model.init_caches(4, 32, "cuda")

    def pad(a, t):
        out = t.new_zeros(t.shape)
        out[tuple(slice(0, n) for n in a.shape)] = a
        return out

    from repro_torch.common.tree import tree_map
    c1 = c2 = tree_map(pad, c1, room)
    serve = make_serve_step(model, ctx=ctx, specs=specs,
                            cache_specs=match_partition_rules(
                                CACHE_RULES, c1, ctx))
    for t in range(2):
        tok = batch["tokens"][:, 30 + t:31 + t]
        with torch.no_grad():
            lg1, c1 = model.decode(params, c1, tok, 30 + t)
        lg2, c2 = serve(blocks, c2, tok, 30 + t)
        assert torch.equal(lg1, lg2)
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c1),
                                                     tree_leaves(c2)))
