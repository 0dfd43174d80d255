"""The port's LM weight-only int8 transform (``quantize_lm_params`` in
``repro_torch/core/quantization.py``) on the CPU, held against JAX's on
the smoke trees of granite-3-2b, kimi-k2-1t-a32b, zamba2-1.2b and
seamless-m4t-large-v2 (JAX's init carried over by ``params_from_jax``).

The quantized trees must equal JAX's path for path, dtype for dtype and
bit for bit (JAX runs op by op, ``jax.disable_jit()``); the decode
logits of the quantized params within 1e-4 * max(1, max|logit|) of
JAX's quantized decode.  The port's own copy of JAX's W8 check
(``tests/test_core_paper.py::test_w8_lm_serving_parity``): quantized
decode logits within relative L2 0.12 of the fp32 ones, and more than 3x
fewer bytes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.core.quantization import quantize_lm_params as jquantize
from repro.models.registry import build_model as jbuild
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.core import quantization as tq
from repro_torch.models.registry import build_model
from repro_torch.serving.engine import Request, ServeConfig, ServingEngine

NAMES = ("granite-3-2b", "kimi-k2-1t-a32b", "zamba2-1.2b",
         "seamless-m4t-large-v2")
LOGIT_TOL = 1e-4


def leaves(tree):
    return {tuple(k.key for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def tleaves(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tleaves(v, path + (k,)))
        return out
    return {path: tree}


def bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def tbits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def close(got, ref, tol):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    err = np.abs(got - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), (err, np.abs(ref).max())


@pytest.fixture(scope="module", params=NAMES)
def trees(request):
    name = request.param
    jc, tc = jsmoke(JARCHS[name]), smoke_variant(get_arch(name))
    jp = jbuild(jc).init(jax.random.PRNGKey(0))
    with jax.disable_jit():
        jq = jquantize(jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    return name, jc, tc, jp, jq, tp, tq.quantize_lm_params(tp)


def test_quantized_tree_equals_jax_bit_for_bit(trees):
    """The same tree paths, dtypes and bits of every leaf (``qw`` /
    ``qt`` / ``q`` int8, their fp32 ``scale``s, and the leaves left as
    they were); ``params_from_jax`` carries JAX's quantized tree over to
    the same leaves."""
    _, _, _, _, jq, _, got = trees
    ref = leaves(jq)
    flat = tleaves(got)
    assert set(flat) == set(ref)
    kinds = set()
    for path, leaf in ref.items():
        t = flat[path]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        assert tuple(t.shape) == leaf.shape, path
        assert np.array_equal(tbits(t), bits(leaf)), path
        kinds.add(path[-1])
    assert {"qw", "qt", "scale"} <= kinds
    carried = tleaves(params_from_jax(jax.tree.map(np.asarray, jq), "cpu"))
    for path, t in carried.items():
        assert t.dtype == flat[path].dtype, path
        assert torch.equal(t, flat[path]), path


def _decode_inputs(jc, B=2):
    toks = np.random.default_rng(1).integers(0, jc.vocab, (B, 12))
    frames = np.random.default_rng(2).standard_normal(
        (B, 16, jc.d_model)).astype(np.float32)
    return toks, frames


def _jax_logits(jc, params, toks, frames, steps=3):
    """Each decode step's logits: enc-dec from its registry prefill's
    state, an LM from zero caches (JAX's W8 check) at positions 0.."""
    m = jbuild(jc)
    B = toks.shape[0]
    if jc.family == "encdec":
        state = jax.jit(m.prefill)(params, {
            "frames": jnp.asarray(frames),
            "tokens": jnp.zeros((B, steps), jnp.int32)})
    else:
        state = m.init_caches(B, 16)
    dec = jax.jit(m.decode)
    out = []
    for t in range(steps):
        lg, state = dec(params, state, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        out.append(lg)
    return out


def _port_logits(tc, params, toks, frames, steps=3):
    m = build_model(tc)
    B = toks.shape[0]
    if tc.family == "encdec":
        state = m.prefill(params, {"frames": torch.from_numpy(frames),
                                   "tokens": torch.zeros((B, steps),
                                                         dtype=torch.long)})
    else:
        state = m.init_caches(B, 16, device="cpu")
    out = []
    for t in range(steps):
        lg, state = m.decode(params, state, torch.as_tensor(
            toks[:, t:t + 1]), t)
        out.append(lg)
    return out


def test_quantized_decode_matches_jax(trees):
    """Three decode steps of the W8 params (dequantized on use by
    ``linear``, ``embed`` and the MoE's ``_deq``) against JAX's."""
    _, jc, tc, _, jq, _, qt = trees
    toks, frames = _decode_inputs(jc)
    for got, ref in zip(_port_logits(tc, qt, toks, frames),
                        _jax_logits(jc, jq, toks, frames)):
        close(got, ref, LOGIT_TOL)


def test_w8_serving_parity_and_bytes(trees):
    """The port's own copy of JAX's check: W8 decode logits within
    relative L2 0.12 of the fp32 params', and more than 3x fewer bytes
    (fp32 smoke params)."""
    name, _, tc, _, _, tp, qt = trees
    toks, frames = _decode_inputs(tc)
    toks = np.zeros_like(toks)
    lg_fp = _port_logits(tc, tp, toks, frames, 1)[0]
    lg_q = _port_logits(tc, qt, toks, frames, 1)[0]
    rel = ((lg_q - lg_fp).norm() / lg_fp.norm()).item()
    assert rel < 0.12, (name, rel)

    def nbytes(tree):
        return sum(t.numel() * t.element_size()
                   for t in tleaves(tree).values())

    assert nbytes(tp) / nbytes(qt) > 3.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 32), (3, 64, 32), (2, 4, 64, 32)])
def test_per_slice_transform_equals_whole_tensor(shape, dtype):
    """``quantize_lm_params`` quantizes one leading index (layer, expert)
    at a time: bit-equal to JAX's whole-tensor ``_q_per_out_channel``
    (the scale reduces the in dim only)."""
    w = (torch.randn(shape, generator=torch.Generator().manual_seed(7))
         * 0.3).to(dtype)
    w[..., 0] = 0.0             # a zero out channel: the 1e-8 floor
    q1, s1 = tq._q_sliced(w)
    q2, s2 = tq._q_per_out_channel(w)
    assert q1.dtype == torch.int8 and s1.dtype == torch.float32
    assert s1.shape == shape[:-2] + (1, shape[-1])
    assert torch.equal(q1, q2) and torch.equal(s1, s2)
    with jax.disable_jit():
        jq, js = jquantize({"blocks": {"mlp": {"w_in": {
            "w": jnp.asarray(w.float().numpy()).astype(
                jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)}}}}
        )["blocks"]["mlp"]["w_in"].values()
    assert np.array_equal(q1.numpy(), np.asarray(jq))
    assert np.array_equal(s1.numpy(), np.asarray(js))


@pytest.mark.parametrize("name", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_engine_serves_w8_moe_params(name):
    """The W8 params of both MoE models through the ``ServingEngine`` (4
    slots, 6 ragged requests): every request finishes with its 5
    tokens."""
    cfg = smoke_variant(get_arch(name))
    params = tq.quantize_lm_params(build_model(cfg).init(0, device="cpu"))
    assert set(params["blocks"]["moe"]["w_in"]) == {"q", "scale"}
    rng = np.random.default_rng(0)
    eng = ServingEngine(cfg, params, ServeConfig(max_slots=4, max_len=64),
                        device="cpu")
    done = eng.run([Request(rid=i, prompt=rng.integers(0, cfg.vocab, n),
                            max_tokens=5)
                    for i, n in enumerate((3, 30, 9, 17, 40, 5))])
    assert sorted(r.rid for r in done) == list(range(6))
    assert all(len(r.out_tokens) == 5 for r in done)
