"""The port's CUDA kernels on the card, held against their plain PyTorch
versions; without a card every test here skips.

This file imports neither JAX nor the JAX package, so it runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerance: max|kernel - plain| <= 1e-4 * max(1, max|plain|).  Both are
fp32 with TF32 off; they differ in summation order only.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core.efficientvit import B1_SMOKE, init_efficientvit
from repro_torch.core.fusion import plan_program
from repro_torch.core.program import execute, lower
from repro_torch.kernels.dsconv.kernel import dsconv_fused
from repro_torch.kernels.dsconv.ref import dsconv_ref
from repro_torch.kernels.mbconv.kernel import mbconv_fused
from repro_torch.kernels.mbconv.ref import mbconv_ref
from repro_torch.kernels.relu_attn.kernel import relu_attn_noncausal
from repro_torch.kernels.relu_attn.ref import relu_attn_noncausal_ref
from repro_torch.serving.scheduler import Request
from repro_torch.serving.vision import VisionEngine, VisionServeConfig

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize("B,H,C,F,stride,rows", [
    (1, 112, 16, 16, 1, None), (2, 9, 8, 72, 1, 4), (2, 8, 8, 12, 2, 3)])
def test_dsconv_kernel_matches_plain(cuda, B, H, C, F, stride, rows):
    rng = np.random.default_rng(H)
    args = (_rand(rng, cuda, B, H, H, C), _rand(rng, cuda, 3, 3, C, scale=.3),
            _rand(rng, cuda, C), _rand(rng, cuda, C, F, scale=C ** -0.5),
            _rand(rng, cuda, F))
    n = dsconv_fused.launches
    got = dsconv_fused(*args, stride=stride, block_rows=rows)
    assert dsconv_fused.launches == n + 1
    _close(got, dsconv_ref(*args, stride=stride))


@pytest.mark.parametrize("B,H,C,M,F,stride,rows,bm", [
    (1, 112, 16, 64, 32, 2, None, None), (2, 14, 128, 512, 128, 1, None, None),
    (2, 7, 256, 1024, 256, 1, None, None), (1, 10, 8, 40, 24, 2, 2, 16),
    (2, 9, 8, 36, 8, 1, 4, 8)])
def test_mbconv_kernel_matches_plain(cuda, B, H, C, M, F, stride, rows, bm):
    """Ragged bands (9 rows in bands of 4) and ragged mid chunks (40 in
    chunks of 16) included."""
    rng = np.random.default_rng(H * M)
    args = (_rand(rng, cuda, B, H, H, C), _rand(rng, cuda, C, M,
                                                 scale=C ** -0.5),
            _rand(rng, cuda, M), _rand(rng, cuda, 3, 3, M, scale=.3),
            _rand(rng, cuda, M), _rand(rng, cuda, M, F, scale=M ** -0.5),
            _rand(rng, cuda, F))
    n = mbconv_fused.launches
    got = mbconv_fused(*args, stride=stride, block_rows=rows, block_m=bm)
    assert mbconv_fused.launches == n + 1
    _close(got, mbconv_ref(*args, stride=stride))


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


def test_dispatch_does_not_wait_on_the_card(cuda):
    """``step()`` copies the batch in and launches it without waiting for
    the work already queued; ``finalize()`` is where the host waits."""
    params = init_efficientvit(torch.Generator().manual_seed(0), B1_SMOKE)
    engine = VisionEngine(params, B1_SMOKE, VisionServeConfig(microbatch=1))
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
