"""The port's FIX8 path at EfficientViT-B1@224 against the JAX package, on
the CPU: the int8 plan, the reference forward and the fused forward.

The same rules as ``test_torch_fix8.py`` (B1_SMOKE), whose docstring
gives the gates and why: the JAX side runs op by op, JAX's quantized
tree is carried across, the reference forward is bit-equal given the
same fp32 attention core, and the fused forward holds top-1 and
``CHAOS * max|logit|``: on these random weights the first MSA site flips
a few int8 codes and the flips grow through the S3/S4 requants.
"""
import dataclasses

import numpy as np
import pytest
import torch
from test_torch_fix8 import (
    _fp_tree, _images, _jax_attention, _jax_reference, _qtree)

from repro.core import efficientvit as jevit
from repro.core import fusion as jfusion
from repro.core import program as jprog
from repro_torch.convert import params_from_jax
from repro_torch.core import efficientvit as tevit
from repro_torch.core import fusion as tfusion
from repro_torch.core import program as tprog
from repro_torch.core import quantization as tq

CHAOS = 0.1      # fused or own-attention logits: max|d| <= CHAOS * max|ref|


@pytest.fixture(scope="module")
def b1_q():
    return _qtree(_fp_tree(jevit.B1, 1))


def _site_walk(program, params, x, plan):
    """(first site whose int8 boundary codes differ between the fused
    and the reference forward, codes differing there, codes there).
    Only boundaries outside the plan's super-site groups are read: a
    group runs whole or not at all."""
    inner = {n for g in plan.groups.values() for n in g.members[:-1]}
    for k in range(1, len(program.sites) + 1):
        if program.sites[k - 1].name in inner:
            continue
        sub = dataclasses.replace(program, sites=program.sites[:k])
        ref = tprog.execute(sub, params, x)
        fused = tprog.execute(sub, params, x, plan=plan)
        if ref.dim() < 2 or not isinstance(fused, tq.QTensor):
            continue
        n = int((tq.quantize_act(ref).q != fused.q).sum())
        if n:
            return program.sites[k - 1].name, n, fused.q.numel()
    return None, 0, 0


# ---------------------------------------------------------------------------
# the plan, the reference forward and the fused forward
# ---------------------------------------------------------------------------

def test_int8_plan_matches_jax_b1_224(b1_q, tmp_autotune_cache):
    j = jfusion.plan_program(jprog.lower(jevit.B1), b1_q, autotune=False,
                             supersites=False)
    t = tfusion.plan_program(tprog.lower(tevit.B1),
                             params_from_jax(b1_q, "cpu"), supersites=False)
    key = lambda d: (d.name, d.kind, d.fused, d.precision, tuple(d.shape),
                     d.q_in)
    assert [key(d) for d in t.decisions.values()] == \
        [key(d) for d in j.decisions.values()]
    ep = lambda m: {n: (e.out_dtype, e.scale, e.residual)
                    for n, e in m.items()}
    assert ep(t.epilogues) == ep(j.epilogues)
    kinds = [e.residual for e in t.epilogues.values()]
    assert (len(kinds), kinds.count("post-add"), kinds.count("keep-fp")) \
        == (23, 18, 5)
    assert tfusion.launch_counts(t) == jfusion.launch_counts(j)
    assert tfusion.launch_counts(t)["fused"] == \
        tfusion.EXPECTED_B1_FUSED_LAUNCHES_INT8 == 29
    jrep = {r["site"]: r for r in jfusion.plan_report(j)}
    for r in tfusion.plan_report(t):
        for k in ("hbm_unfused", "hbm_fused", "hbm_w", "hbm_delivered",
                  "q_in", "launches_ref", "launches_fused"):
            assert r[k] == jrep[r["site"]][k], (r["site"], k)


def test_reference_forward_bit_equal_b1_224(b1_q):
    x = _images(1, 224, seed=3)
    want = _jax_reference(jevit.B1, 1, 224, b1_q, x)
    program = tprog.lower(tevit.B1)
    tp = params_from_jax(b1_q, "cpu")
    got = tprog.execute(program, tp, torch.from_numpy(x),
                        attention_fn=_jax_attention).numpy()
    assert got.shape == (1, 1000)
    np.testing.assert_array_equal(got, want)
    own = tprog.execute(program, tp, torch.from_numpy(x)).numpy()
    d, top = np.abs(own - want).max(), np.abs(want).max()
    print(f"B1@224 reference forward, the port's own attention core vs "
          f"JAX: max|d| {d:.4e} of max|logit| {top:.4e}")
    assert int(own.argmax()) == int(want.argmax())
    assert d <= CHAOS * top


def test_fused_forward_b1_224(b1_q):
    x = torch.from_numpy(_images(1, 224, seed=3))
    tp = params_from_jax(b1_q, "cpu")
    program = tprog.lower(tevit.B1)
    plan = tfusion.plan_program(program, tp)
    ref = tprog.execute(program, tp, x)
    got = tprog.execute(program, tp, x, plan=plan)
    d, top = (got - ref).abs().max().item(), ref.abs().max().item()
    site, n, total = _site_walk(program, tp, x, plan)
    print(f"B1@224 fused int8 vs reference: max|d| {d:.4e} of max|logit| "
          f"{top:.4e}; first site with differing int8 codes: {site} "
          f"({n} of {total})")
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert d <= CHAOS * top
    assert site is None or program.site(site).kind == "msa"
