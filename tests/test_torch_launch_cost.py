"""The dry-run's counters (``launch/cost.py``) and roofline
(``launch/analysis.py``) against ground truth computed by hand, as
``tests/test_hlo_cost.py`` / ``test_hlo_cost_extra.py`` hold JAX's HLO
parser: one matmul's FLOPs, a loop counted once per iteration, the
recompute of ``kernels/recompute.py``, the scan kernels' meta branches,
the ring multipliers of the collectives on a fake 4-rank group, bytes
(views add 0), the tracked peak, and ``RooflineTerms`` against JAX's on
the same terms under either set of constants.
"""
import pytest
import torch

from repro_torch.kernels.recompute import with_recompute_grad
from repro_torch.kernels.relu_attn.kernel import (
    relu_attn_causal, relu_attn_causal_cost, relu_attn_causal_plan)
from repro_torch.kernels.ssd.kernel import ssd_chunked, ssd_cost, ssd_plan
from repro_torch.launch import analysis
from repro_torch.launch.cost import measure_step
from repro_torch.launch.dryrun import fake_world


def _meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(shape, dtype=dtype, device="meta",
                       requires_grad=grad)


def test_single_matmul_flops():
    c = measure_step(lambda a, b: a @ b, _meta(64, 128), _meta(128, 32))
    assert c.flops == c.dot_flops == 2 * 64 * 32 * 128
    assert c.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)
    assert c.argument_bytes == 4 * (64 * 128 + 128 * 32)
    assert c.peak_bytes == 4 * 64 * 32
    assert c.collective_bytes == 0 and c.off_meta_ops == 0


def test_loop_counts_every_iteration():
    def f(x, w):
        for _ in range(13):
            x = torch.tanh(x @ w)
        return x

    c = measure_step(f, _meta(8, 32), _meta(32, 32))
    assert c.flops == 13 * 2 * 8 * 32 * 32
    # each matmul reads x and w and writes x; each tanh reads and writes x
    assert c.bytes == 13 * 4 * ((8 * 32 + 32 * 32 + 8 * 32) + 2 * 8 * 32)


def test_nested_loops_multiply():
    def f(x, w):
        for _ in range(3):
            for _ in range(5):
                x = x @ w
        return x

    c = measure_step(f, _meta(4, 16), _meta(16, 16))
    assert c.flops == 3 * 5 * 2 * 4 * 16 * 16


def test_recompute_counts_the_second_forward():
    """``with_recompute_grad``'s backward runs the plain version again:
    one more forward's FLOPs than autograd through the plain version."""
    m, k, n = 16, 32, 8

    def plain(a, b):
        return a @ b

    def grads(fn):
        def run(a, b):
            return torch.autograd.grad(fn(a, b).sum(), (a, b))
        return run

    a, b = _meta(m, k, grad=True), _meta(k, n, grad=True)
    direct = measure_step(grads(plain), a, b)
    recomputed = measure_step(grads(lambda x, y: with_recompute_grad(
        plain, plain, x, y)), a, b)
    one = 2 * m * k * n
    assert direct.flops == 3 * one
    assert recomputed.flops == 4 * one


def test_ssd_meta_branch_counts_its_cost():
    bh, s, p, n, chunk = 6, 600, 16, 8, 256
    args = (_meta(bh, s, p), _meta(bh, s), _meta(bh, s), _meta(bh, s, n),
            _meta(bh, s, n))
    before = ssd_chunked.launches
    c = measure_step(lambda *a: ssd_chunked(*a, chunk=chunk), *args)
    want = ssd_cost(bh, s, p, n, chunk)
    assert c.kernels == {"ssd_chunked": {"calls": 1, "flops": want["flops"],
                                         "bytes": want["bytes"]}}
    assert c.flops == c.dot_flops == want["flops"]
    assert c.bytes == want["bytes"]
    # the workspace of the plan is allocated (and freed) on meta
    assert c.peak_bytes == ssd_plan(bh, s, p, n, chunk)["workspace"] \
        + 4 * bh * s * p
    assert ssd_chunked.launches == before          # nothing launched
    # by hand: 3 chunks of 256, 256, 88 tokens
    ls = (256, 256, 88)
    tri = sum(L * (L + 1) for L in ls) * (n + p)
    assert want["flops"] == bh * (tri + 2 * n * p * (s - 256)
                                  + 2 * n * p * (s - 88))
    assert want["bytes"] == 4 * bh * s * (p + 2 + 2 * n) + 4 * bh * s * p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_relu_causal_meta_branch_counts_its_cost(dtype):
    bh, n, d, chunk = 4, 300, 16, 128
    q = _meta(bh, n, d, dtype=dtype)
    before = relu_attn_causal.launches
    c = measure_step(lambda a, b, v: relu_attn_causal(a, b, v, chunk=chunk),
                     q, q.clone(), q.clone())
    want = relu_attn_causal_cost(bh, n, d, chunk, q.element_size())
    assert c.kernels["relu_attn_causal"]["flops"] == want["flops"]
    assert c.flops == want["flops"]
    assert c.bytes == want["bytes"]
    assert want["bytes"] == 3 * bh * n * d * q.element_size() + 4 * bh * n * d
    ls = (128, 128, 44)
    assert want["triangle"] == bh * sum(L * (L + 1) for L in ls) * 2 * d
    assert want["read"] == bh * 2 * d * d * (n - 128)
    assert want["update"] == bh * 2 * d * d * (n - 44)
    assert c.peak_bytes == relu_attn_causal_plan(bh, n, d, chunk)[
        "workspace"] + 4 * bh * n * d
    assert relu_attn_causal.launches == before


@pytest.fixture(scope="module")
def world4():
    from torch.distributed.device_mesh import DeviceMesh
    with fake_world(4):
        yield DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                         mesh_dim_names=("data", "model"))


def test_collective_ring_multipliers(world4):
    from repro_torch.distributed import collectives as C
    x = _meta(8, 16)
    op = 8 * 16 * 4
    cases = {
        "all-reduce": (lambda t: C.psum(t, "model", world4), 2 * op),
        "all-gather": (lambda t: C.all_gather(t, "model", axis=0,
                                              mesh=world4), 2 * op),
        "all-to-all": (lambda t: C.all_to_all(t, "model", 0, 1,
                                              mesh=world4), op),
        "collective-permute": (lambda t: C.ppermute(
            t, "model", [(0, 1)], mesh=world4), op),
    }
    for kind, (fn, want) in cases.items():
        c = measure_step(fn, x, mesh=world4)
        assert c.coll_by_kind == {kind: want}, kind
        assert c.collective_bytes == want
        assert c.coll_by_axis == {"model": want}
    # a psum over both axes runs one all-reduce a mesh axis
    c = measure_step(lambda t: C.psum(t, ("data", "model"), world4), x,
                     mesh=world4)
    assert c.coll_by_axis == {"data": 2 * op, "model": 2 * op}


def test_psum_backward_is_a_psum(world4):
    from repro_torch.distributed import collectives as C
    x, w = _meta(8, 16), _meta(16, 16, grad=True)

    def f(x, w):
        y = C.psum(x @ w, "model", world4)
        return torch.autograd.grad(y.sum(), w)

    c = measure_step(f, x, w)
    assert c.coll_by_kind == {"all-reduce": 2 * (2 * 8 * 16 * 4)}
    assert c.flops == 2 * (2 * 8 * 16 * 16)


def test_bytes_scale_and_views_are_free():
    small = measure_step(lambda t: t * 2.0, _meta(10, 10))
    big = measure_step(lambda t: t * 2.0, _meta(100, 100))
    assert big.bytes == 100 * small.bytes == 2 * 4 * 100 * 100
    views = measure_step(lambda t: t.view(100).transpose(0, 0)[:50]
                         .reshape(5, 10).unsqueeze(0), _meta(10, 10))
    assert views.bytes == 0 and views.peak_bytes == 0
    half = measure_step(lambda t: t.to(torch.bfloat16), _meta(10, 10))
    assert half.bytes == 100 * (4 + 2)


def test_peak_tracks_frees():
    def f(x):
        a = x * 2.0          # 400 B
        b = a * 2.0          # 800 live
        del a
        c = b * 2.0          # 800 live again
        del b
        return c

    c = measure_step(f, _meta(10, 10))
    assert c.peak_bytes == 800


def _jax_analysis():
    from repro.launch import analysis as ja
    return ja


TERMS = [(1e12, 1e9, 1e8, 5e11), (1e9, 1e12, 1e8, 0.0),
         (1e9, 1e6, 1e12, 1e8), (0.0, 0.0, 0.0, 0.0)]


@pytest.mark.parametrize("terms", TERMS)
def test_roofline_matches_jax_under_either_constants(terms, monkeypatch):
    ja = _jax_analysis()
    names = (("PEAK_FLOPS_BF16", "PEAK_FLOPS_BF16"), ("HBM_BW", "HBM_BW"),
             ("NVLINK_BW", "ICI_BW"))
    # the port's class with JAX's (TPU v5e) constants
    for port, jax_name in names:
        monkeypatch.setattr(analysis, port, getattr(ja, jax_name))
    got = analysis.RooflineTerms(*terms).to_dict()
    assert got == ja.RooflineTerms(*terms).to_dict()
    monkeypatch.undo()
    # JAX's class with the port's (H100) constants
    for port, jax_name in names:
        monkeypatch.setattr(ja, jax_name, getattr(analysis, port))
    want = ja.RooflineTerms(*terms).to_dict()
    assert analysis.RooflineTerms(*terms).to_dict() == want


def test_h100_constants_and_model_flops():
    ja = _jax_analysis()
    assert analysis.PEAK_FLOPS_BF16 == 989e12
    assert analysis.PEAK_FLOPS_INT8 == 1979e12
    assert analysis.HBM_BW == 3.35e12
    assert analysis.model_flops_train(7, 11) == ja.model_flops_train(7, 11)
    assert analysis.model_flops_decode(7, 11) == ja.model_flops_decode(7, 11)
    t = analysis.RooflineTerms(989e12, 3.35e12, 0.0, 494.5e12)
    assert t.compute_s == t.memory_s == 1.0
    assert t.bound_s == 1.0 and t.roofline_fraction == 1.0
    assert t.useful_flops_fraction == 0.5
