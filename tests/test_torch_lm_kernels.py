"""The port's LM-form kernels (``relu_attn_causal``, ``ssd_chunked``) and
their public ops on the CPU, held against the JAX package.

On the CPU each wrapper takes its plain PyTorch version, which runs in
the TPU kernel's chunk order; JAX's Pallas kernels run in interpret mode,
as ``tests/test_kernels.py`` runs them.  Inputs are numpy-seeded and the
sweeps mirror ``tests/test_kernels.py``'s (ragged N and S, g = 2, bf16
attention inputs).

Tolerances: rtol = atol = 1e-5 against JAX's kernel at the same chunk
(fp32 sums in another order; bf16 inputs are rounded from the same fp32
values on both sides, then computed in fp32).  For the SSD the atol is
1e-5 * max(1, max|y|): the in-chunk cumsum of dA runs in XLA's order in
JAX and in order in torch (they differ by up to 1.5e-5 over 256 terms),
and exp(cum_l - cum_s) carries that into y: measured up to 4.6e-5 at
max|y| 33 on these cases, and within 7.6e-6 when the port is fed JAX's
cumsum values.  JAX's own 2e-4 against the O(N^2) and recurrent
oracles, and for a ragged S, where JAX's SSD takes the whole sequence as
one chunk and the port pads to whole chunks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.relu_attn import kernel as jrk
from repro.kernels.relu_attn import ops as jro
from repro.kernels.relu_attn import ref as jrr
from repro.kernels.ssd import kernel as jsk
from repro.kernels.ssd import ops as jso
from repro.kernels.ssd import ref as jsr
from repro_torch.kernels.relu_attn.kernel import (
    relu_attn_causal, relu_attn_causal_plan)
from repro_torch.kernels.relu_attn.ops import (
    msa_attention_fn, relu_linear_attention)
from repro_torch.kernels.relu_attn.ref import (
    relu_attn_causal_chunked, relu_attn_causal_ref, relu_attn_causal_scan)
from repro_torch.kernels.ssd.kernel import ssd_chunked, ssd_plan
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.kernels.ssd.ref import (
    ssd_chunked_ref, ssd_recurrent_ref, ssd_scan_ref)

SAME_CHUNK = dict(rtol=1e-5, atol=1e-5)
ORACLE = dict(rtol=2e-4, atol=2e-4)


def _pair(a, dtype):
    """One fp32 numpy array as (jnp, torch) of ``dtype`` ("f32" or
    "bf16"), rounded identically."""
    if dtype == "bf16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.from_numpy(a).to(torch.bfloat16))
    return jnp.asarray(a), torch.from_numpy(a)


def _np(x):
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------------
# relu_attn_causal
# ---------------------------------------------------------------------------

def _causal_case(i):
    """Case i of the sweep of ``test_kernels.py::
    test_relu_attn_causal_sweep`` (same draws)."""
    rng = np.random.default_rng(2 * 10_007 + i)
    dtype = ["f32", "bf16"][int(rng.integers(2))]
    b = int(rng.integers(1, 4))
    n = int(rng.integers(1, 9)) * 16
    d = int(rng.choice([16, 32]))
    chunk = int(rng.choice([16, 32, n]))
    qkv = [rng.standard_normal((b, n, d)).astype(np.float32)
           for _ in range(3)]
    return dtype, chunk, qkv


@pytest.mark.parametrize("case", range(8))
def test_relu_attn_causal_matches_jax_sweep(case):
    dtype, chunk, qkv = _causal_case(case)
    (jq, tq_), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in qkv)
    want = _np(jrk.relu_attn_causal(jq, jk, jv, chunk=chunk))
    got = relu_attn_causal(tq_, tk, tv, chunk=chunk)
    assert got.dtype == torch.float32
    assert_allclose(got.numpy(), want, **SAME_CHUNK)
    assert_allclose(got.numpy(), _np(jrr.relu_attn_causal_ref(jq, jk, jv)),
                    **ORACLE)


@pytest.mark.parametrize("n,d,chunk", [(50, 16, 16), (100, 32, 32),
                                       (37, 16, 64)])
def test_relu_attn_causal_ragged_n(n, d, chunk):
    """N not a multiple of the chunk: zero-padded, as JAX pads."""
    rng = np.random.default_rng(n)
    qkv = [rng.standard_normal((2, n, d)).astype(np.float32)
           for _ in range(3)]
    want = _np(jrk.relu_attn_causal(*map(jnp.asarray, qkv), chunk=chunk))
    got = relu_attn_causal(*map(torch.from_numpy, qkv), chunk=chunk)
    assert_allclose(got.numpy(), want, **SAME_CHUNK)


@pytest.mark.parametrize("b,n,d,chunk,dtype", [
    (2, 256, 16, 16, "f32"), (1, 16 * 17 + 5, 32, 16, "f32"),
    (1, 16 * 16 + 3, 240, 16, "f32"), (2, 32 * 16, 16, 32, "bf16")])
def test_relu_attn_causal_scan_many_chunks(b, n, d, chunk, dtype):
    """The kernel's stages (each chunk's state, the exclusive prefix, the
    outputs) over 16 to 18 chunks, a ragged last chunk and d = 240,
    against JAX's kernel (interpret mode, op by op) and the TPU kernel's
    chunk order: a prefix that includes its own chunk, or skips one,
    misses by far more than the tolerance."""
    rng = np.random.default_rng(n + d)
    qkv = [rng.standard_normal((b, n, d)).astype(np.float32)
           for _ in range(3)]
    (jq, tq_), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in qkv)
    with jax.disable_jit():
        want = _np(jrk.relu_attn_causal(jq, jk, jv, chunk=chunk))
    got = relu_attn_causal_scan(tq_, tk, tv, chunk=chunk)
    assert -(-n // chunk) >= 16
    assert_allclose(got.numpy(), want, **SAME_CHUNK)
    assert_allclose(got.numpy(), relu_attn_causal_chunked(
        tq_, tk, tv, chunk=chunk).numpy(), **SAME_CHUNK)
    assert torch.equal(relu_attn_causal(tq_, tk, tv, chunk=chunk), got)


def test_relu_attn_causal_oracle_matches_jax():
    rng = np.random.default_rng(3)
    qkv = [rng.standard_normal((2, 40, 16)).astype(np.float32)
           for _ in range(3)]
    want = _np(jrr.relu_attn_causal_ref(*map(jnp.asarray, qkv)))
    got = relu_attn_causal_ref(*map(torch.from_numpy, qkv))
    assert_allclose(got.numpy(), want, **SAME_CHUNK)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_relu_linear_attention_matches_jax(causal, dtype):
    """The public op on (B, N, H, D), heads folded as JAX folds them."""
    rng = np.random.default_rng(4 + causal)
    B, N, H, D = 2, 48, 3, 16
    qkv = [rng.standard_normal((B, N, H, D)).astype(np.float32)
           for _ in range(3)]
    (jq, tq_), (jk, tk), (jv, tv) = (_pair(a, dtype) for a in qkv)
    want = _np(jro.relu_linear_attention(jq, jk, jv, causal=causal,
                                         block_n=16))
    got = relu_linear_attention(tq_, tk, tv, causal=causal, block_n=16)
    assert tuple(got.shape) == (B, N, H, D)
    assert_allclose(got.numpy(), want, **SAME_CHUNK)


def test_msa_attention_fn_matches_jax():
    rng = np.random.default_rng(6)
    qkv = [rng.standard_normal((2, 49, 4, 16)).astype(np.float32)
           for _ in range(3)]
    want = _np(jro.msa_attention_fn(*map(jnp.asarray, qkv)))
    got = msa_attention_fn(*map(torch.from_numpy, qkv))
    assert_allclose(got.numpy(), want, **SAME_CHUNK)


# ---------------------------------------------------------------------------
# ssd_chunked through ssd_op
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, s, h, p, g, n):
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal((h,)) * 0.5)).astype(np.float32)
    B = rng.standard_normal((b, s, g, n)).astype(np.float32)
    C = rng.standard_normal((b, s, g, n)).astype(np.float32)
    D = rng.standard_normal((h,)).astype(np.float32)
    return x, dt, A, B, C, D


def _ssd_case(i):
    """Case i of the sweep of ``test_kernels.py::test_ssd_pallas_sweep``
    (the same shape draws)."""
    rng = np.random.default_rng(5 * 10_007 + i)
    b = int(rng.integers(1, 3))
    s = int(rng.integers(1, 5)) * 32
    h = int(rng.choice([2, 4]))
    p = int(rng.choice([16, 32]))
    g = int(rng.choice([1, 2]))
    n = int(rng.choice([8, 16]))
    chunk = int(rng.choice([16, 32, s]))
    return chunk, _ssd_inputs(rng, b, s, h, p, g, n)


def _same_chunk_ssd(got, want):
    assert_allclose(got, want, rtol=1e-5,
                    atol=1e-5 * max(1.0, float(np.abs(want).max())))


def _both_ssd(args, chunk):
    x, dt, A, B, C, D = args
    want = _np(jso.ssd_op(*map(jnp.asarray, (x, dt, A, B, C)), chunk=chunk,
                          D_skip=jnp.asarray(D)))
    got = ssd_op(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk,
                 D_skip=torch.from_numpy(D))
    return got.numpy(), want


@pytest.mark.parametrize("case", range(6))
def test_ssd_op_matches_jax_sweep(case):
    chunk, args = _ssd_case(case)
    got, want = _both_ssd(args, chunk)
    _same_chunk_ssd(got, want)
    ref, _ = jsr.ssd_recurrent_ref(*map(jnp.asarray, args[:5]),
                                   D_skip=jnp.asarray(args[5]))
    assert_allclose(got, _np(ref), **ORACLE)


@pytest.mark.parametrize("s,chunk,g", [(100, 32, 1), (70, 16, 2)])
def test_ssd_op_ragged_s_pads_to_whole_chunks(s, chunk, g):
    """S not a multiple of the chunk: the port pads with dt = 0 and keeps
    the chunk; JAX takes the whole sequence as one chunk."""
    args = _ssd_inputs(np.random.default_rng(s), 2, s, 4, 16, g, 8)
    got, want = _both_ssd(args, chunk)
    assert_allclose(got, want, **ORACLE)


@pytest.mark.parametrize("BH,S,P,N,chunk", [
    (2, 256, 16, 8, 16), (2, 16 * 17 + 5, 16, 8, 16),
    (1, 16 * 16, 64, 128, 16), (1, 32 * 16 + 9, 24, 16, 32)])
def test_ssd_scan_many_chunks(BH, S, P, N, chunk):
    """The kernel's stages (each chunk's state and decay, the decayed
    exclusive prefix, the outputs) over 16 to 18 chunks, against JAX's
    kernel (interpret mode, op by op) at the same chunk, fed the inputs
    zero-padded to whole chunks (dt = dA = 0), as the port pads a ragged
    S; and against the TPU kernel's chunk order.  A decay applied once
    too often, or a prefix that includes its own chunk, misses by far
    more than the tolerance."""
    rng = np.random.default_rng(S + P)
    x = rng.standard_normal((BH, S, P)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.1, (BH, S)).astype(np.float32)
    dA = (dt * -rng.uniform(1, 16, (BH, 1))).astype(np.float32)
    Bm, Cm = (rng.standard_normal((BH, S, N)).astype(np.float32)
              for _ in range(2))
    pad = -S % chunk
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (x, dt, dA, Bm, Cm)]
    with jax.disable_jit():
        want = _np(jsk.ssd_chunked_pallas(*map(jnp.asarray, padded),
                                          chunk=chunk))[:, :S]
    args = [torch.from_numpy(a) for a in (x, dt, dA, Bm, Cm)]
    got = ssd_scan_ref(*args, chunk=chunk)
    assert -(-S // chunk) >= 16
    _same_chunk_ssd(got.numpy(), want)
    _same_chunk_ssd(got.numpy(), ssd_chunked_ref(*args,
                                                 chunk=chunk).numpy())
    assert torch.equal(ssd_chunked(*args, chunk=chunk), got)


def test_ssd_padding_adds_nothing():
    """A ragged S equals the first S outputs of the same sequence padded
    with dt = dA = 0 (at the plain version, the kernel's CPU path)."""
    rng = np.random.default_rng(9)
    BH, S, P, N, pad = 3, 40, 8, 4, 24
    x, Bm, Cm = (torch.from_numpy(rng.standard_normal(sh).astype(
        np.float32)) for sh in ((BH, S, P), (BH, S, N), (BH, S, N)))
    dt = torch.from_numpy(rng.uniform(0.01, 0.5, (BH, S)).astype(np.float32))
    dA = -dt * 0.7
    y = ssd_chunked(x, dt, dA, Bm, Cm, chunk=16)

    def zpad(t):
        return torch.cat([t, torch.zeros((BH, pad) + t.shape[2:])], dim=1)
    y_long = ssd_chunked(*map(zpad, (x, dt, dA, Bm, Cm)), chunk=16)
    assert torch.equal(y, y_long[:, :S])


def test_ssd_recurrent_oracle_matches_jax():
    args = _ssd_inputs(np.random.default_rng(8), 2, 24, 4, 8, 2, 8)
    want_y, want_state = jsr.ssd_recurrent_ref(*map(jnp.asarray, args[:5]),
                                               D_skip=jnp.asarray(args[5]))
    got_y, got_state = ssd_recurrent_ref(*map(torch.from_numpy, args[:5]),
                                         D_skip=torch.from_numpy(args[5]))
    assert_allclose(got_y.numpy(), _np(want_y), **SAME_CHUNK)
    assert_allclose(got_state.numpy(), _np(want_state), **SAME_CHUNK)


@pytest.mark.parametrize("plan,want", [
    (relu_attn_causal_plan(32, 32768, 64), (128, 3, 68_157_440)),
    (relu_attn_causal_plan(32, 32668, 64), (128, 3, 68_157_440)),
    (relu_attn_causal_plan(16, 32768, 240), (128, 3, 473_825_280)),
    (relu_attn_causal_plan(2, 200, 16), (1, 1, 0)),
    (ssd_plan(64, 32768, 64, 128), (128, 3, 268_468_224)),
    (ssd_plan(64, 32668, 64, 128), (128, 3, 268_468_224)),
    (ssd_plan(2, 100, 16, 8, chunk=32), (4, 3, 4 * 2 * 4 * (8 * 16 + 1)))])
def test_scan_plans(plan, want):
    """The scans' plans at the library shapes (Zamba2-1.2B, Gemma3-12B's
    global layer, Mamba2-1.3B, 32k tokens in chunks of 256) and small
    ones: chunks a row, CUDA launches a call (one for a single chunk),
    workspace bytes (a state, and a normalizer or a decay, per chunk)."""
    assert (plan["chunks"], plan["launches"], plan["workspace"]) == want
