"""The port's FIX8 path (``VisionEngine.quantized`` -> ``quantize_efficientvit``
-> ``plan_program`` -> ``execute``) against the JAX package, on the CPU,
at B1_SMOKE (``test_torch_fix8_b1.py`` runs B1@224 with these helpers).

The JAX side runs op by op (``jax.disable_jit``): under ``jit`` XLA on
the CPU contracts ``a*b+c`` into an FMA and turns a division by a
constant into a reciprocal multiply, which eager torch never does.  The
forward tests carry JAX's quantized tree across (``params_from_jax``):
BN folding uses rsqrt, and ``lax.rsqrt`` and ``torch.rsqrt`` differ, so
the port's own quantizer is held to a tolerance of its own.

Gates, and why:
- reference forward (``plan=None``): bit-equal to JAX with the same
  fp32 attention core.  The attention core is the one fp32 reduction of
  the FIX8 forward, and XLA's CPU dot sums in an order torch does not
  reproduce (the state ``ReLU(K)^T V`` with four interleaved FMA
  accumulators); an ulp there flips an int8 code at the next requant.
  With the port's own attention core the smoke forwards hold
  1e-3 * max|logit|; B1@224 holds top-1 and 0.1 * max|logit|.
- fused forward (``plan``): the MSA projections dequantize as
  ``(acc * xs) * ws`` (the GEMM kernel's order) where the reference does
  ``acc * (xs * ws)``, and the attention kernel sums in its own order,
  so codes flip at the first MSA site and the flips grow through the
  remaining requants.  B1_SMOKE holds 1e-3 * max|logit|; B1@224 holds
  top-1 and 0.1 * max|logit|, and the test prints the first site whose
  int8 codes differ.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro.core import quantization as jq
from repro.core import relu_attention as jra
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.core import quantization as tq
from repro_torch.serving.vision import VisionEngine, VisionServeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _perturb_bn(tree, rng):
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape[0]
            return {"scale": rng.uniform(0.8, 1.2, n).astype(np.float32),
                    "bias": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "mean": (0.1 * rng.standard_normal(n)).astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        return {k: _perturb_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_perturb_bn(v, rng) for v in tree]
    return tree


def _fp_tree(jcfg, seed):
    init = jax.jit(jevit.init_efficientvit, static_argnums=1)
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))
    return _perturb_bn(tree, np.random.default_rng(seed))


def _qtree(fp):
    return jax.tree.map(np.asarray,
                        jq.quantize_efficientvit(jax.tree.map(jnp.asarray, fp)))


@pytest.fixture(scope="module")
def smoke_fp():
    return _fp_tree(jevit.B1_SMOKE, 0)


@pytest.fixture(scope="module")
def smoke_q(smoke_fp):
    return _qtree(smoke_fp)


def _images(n, res, seed):
    return np.random.default_rng(seed).standard_normal(
        (n, res, res, 3)).astype(np.float32)


def _jax_reference(cfg, batch, res, jtree, x):
    with jax.disable_jit():
        return np.asarray(jprog.execute(
            jprog.lower(cfg, batch=batch, image_size=res), jtree,
            jnp.asarray(x)))


def _jax_attention(q, k, v):
    """JAX's reference attention core, op by op, as the port's
    ``attention_fn``."""
    with jax.disable_jit():
        o = jra.relu_global_attention(*(jnp.asarray(t.numpy())
                                        for t in (q, k, v)))
    return torch.from_numpy(np.array(o))


# ---------------------------------------------------------------------------
# the reference forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res,batch", [(32, 1), (32, 2), (64, 1), (64, 2)])
def test_reference_forward_bit_equal_smoke(smoke_q, res, batch):
    x = _images(batch, res, seed=res + batch)
    want = _jax_reference(jevit.B1_SMOKE, batch, res, smoke_q, x)
    program = tprog.lower(tevit.B1_SMOKE, batch=batch, image_size=res)
    tp = params_from_jax(smoke_q, "cpu")
    got = tprog.execute(program, tp, torch.from_numpy(x),
                        attention_fn=_jax_attention).numpy()
    np.testing.assert_array_equal(got, want)
    own = tprog.execute(program, tp, torch.from_numpy(x)).numpy()
    assert np.abs(own - want).max() <= 1e-3 * np.abs(want).max()


# ---------------------------------------------------------------------------
# the fused (planned) forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("res,batch", [(32, 1), (64, 2)])
def test_fused_forward_matches_reference_smoke(smoke_q, res, batch):
    x = torch.from_numpy(_images(batch, res, seed=7))
    tp = params_from_jax(smoke_q, "cpu")
    program = tprog.lower(tevit.B1_SMOKE, batch=batch, image_size=res)
    plan = tfusion.plan_program(program, tp)
    assert all(d.fused and d.precision == "int8"
               for d in plan.decisions.values())
    ref = tprog.execute(program, tp, x)
    got = tprog.execute(program, tp, x, plan=plan)
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert (got - ref).abs().max() <= 1e-3 * ref.abs().max()


def test_fused_forward_matches_jax_fused_smoke(smoke_q, tmp_autotune_cache):
    """Against JAX's own fused int8 path (Pallas in interpret mode)."""
    x = _images(2, 64, seed=11)
    jprogram = jprog.lower(jevit.B1_SMOKE, batch=2)
    jplan = jfusion.plan_program(jprogram, smoke_q, autotune=False,
                                 supersites=False)
    want = np.asarray(jprog.execute(jprogram, smoke_q, jnp.asarray(x),
                                    plan=jplan))
    tp = params_from_jax(smoke_q, "cpu")
    program = tprog.lower(tevit.B1_SMOKE, batch=2)
    got = tprog.execute(program, tp, torch.from_numpy(x),
                        plan=tfusion.plan_program(program, tp)).numpy()
    print(f"B1_SMOKE fused int8, port vs JAX fused: max|d| "
          f"{np.abs(got - want).max():.4e} of {np.abs(want).max():.4e}")
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.parametrize("batch", [2, 4])
def test_fused_batch_invariance(smoke_q, batch):
    """Row i of a batch-n fused forward equals the batch-1 forward of
    image i, bit for bit: every activation scale is per image."""
    tp = params_from_jax(smoke_q, "cpu")
    x = torch.from_numpy(_images(batch, 64, seed=batch))
    program = tprog.lower(tevit.B1_SMOKE, batch=batch)
    rows = tprog.execute(program, tp, x,
                         plan=tfusion.plan_program(program, tp))
    one = tprog.lower(tevit.B1_SMOKE, batch=1)
    plan1 = tfusion.plan_program(one, tp)
    for i in range(batch):
        assert torch.equal(rows[i], tprog.execute(one, tp, x[i:i + 1],
                                                  plan=plan1)[0])


# ---------------------------------------------------------------------------
# the port's own quantizer, conversion, serving
# ---------------------------------------------------------------------------

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_quantize_efficientvit_matches_jax(smoke_fp, smoke_q):
    """Same fp tree, quantized by each package.  BN folding's rsqrt
    differs in the last bit (lax.rsqrt vs torch.rsqrt), so folded biases
    and scales agree to 1e-6 and at most 0.1 % of the int8 codes differ,
    each by exactly 1; the FC layers (no BN) are bit-equal."""
    got = dict(_leaves(tq.quantize_efficientvit(
        params_from_jax(smoke_fp, "cpu"))))
    want = dict(_leaves(smoke_q))
    assert set(got) == set(want)
    n_codes = n_diff = 0
    for path, w in want.items():
        g = got[path].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, path
        if w.dtype == np.int8:
            diff = g.astype(np.int32) - w
            assert np.abs(diff).max() <= 1, path
            n_codes += w.size
            n_diff += int(np.count_nonzero(diff))
            if path[0] == "head" and path[1] in ("fc1", "fc2"):
                np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
    assert n_diff <= 1e-3 * n_codes, (n_diff, n_codes)


def test_params_from_jax_carries_int8_leaves(smoke_q):
    tp = params_from_jax(smoke_q, "cpu")
    got = dict(_leaves(tp))
    for path, w in _leaves(smoke_q):
        g = got[path]
        assert g.dtype == (torch.int8 if w.dtype == np.int8
                           else torch.float32), path
        np.testing.assert_array_equal(g.numpy(), w)


def test_quantized_engine_serves_int8(smoke_fp):
    params = params_from_jax(smoke_fp, "cpu")
    engine = VisionEngine.quantized(params, tevit.B1_SMOKE,
                                    VisionServeConfig(microbatch=4),
                                    device="cpu")
    assert engine.serve_cfg.precision == "int8"
    assert all(d.fused and d.precision == "int8"
               for d in engine.plan.decisions.values())
    assert len(engine.plan.epilogues) == 10
    x = _images(5, 64, seed=5)
    got = engine.logits(x)
    assert {k.precision for k in engine.cache.keys()} == {"int8"}
    qtree = tq.quantize_efficientvit(params)
    for i in range(5):
        program = tprog.lower(tevit.B1_SMOKE, batch=1)
        want = tprog.execute(program, qtree, torch.from_numpy(x[i:i + 1]),
                             plan=tfusion.plan_program(program, qtree))
        assert torch.equal(got[i], want[0])


def test_vision_module_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch.serving.vision\n"
            "bad = [m for m in sys.modules if m in ('jax', 'repro') "
            "or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT)
