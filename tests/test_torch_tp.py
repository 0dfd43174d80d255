"""The port's tensor parallelism on the CPU: the dense layers split over
``model`` (``distributed/tp.py``: attention heads, ``d_ff``, the Mamba
heads and the vocab) in the sharded train, prefill and decode steps, on
a 4-rank gloo world (``tests/torch_dist_world.py``, suite ``tp``,
started once by a module fixture) on the meshes (1, 4) and (2, 2), at
``smoke_variant`` widths in fp32, from params converted from JAX's
``init`` (``jax.random.PRNGKey(0)``) and numpy batches.

Each case makes one layout trap show: GQA whose kv heads ``model`` does
not divide (granite's 2 on 4: half a kv head a rank), a q-head count
that ``model`` does not divide while ``q_dim`` does (6 heads of 8 on 4:
blocks of 1.5 heads; JAX's ``heads`` annotation releases ``model``),
the same padded to 8 heads (``pad_heads_to``: one rank holds only
padding), the fused ``wqkv`` and ``w_in_gate`` (a contiguous column
block straddles their parts), tied embeddings (the table read out
vocab-parallel), a vocab that ``model`` does not divide (released:
today's path), zamba2 (``in_proj`` and ``conv_w`` blocks off the
heads, the gated norm over ``d_inner``, both scans' plain versions),
a seamless-like enc-dec (cross attention, its cross K/V caches),
grok's MoE between split layers (``a2a``), and a W8 serve case (the
row-parallel ``scale`` gathered whole).

Gates: the sharded step's loss within 1e-6 relative of the port's
single-device step and of JAX's single-device ``Model.loss`` on the
same params and batch (JAX's own GSPMD step is no reference: ROADMAP
R2); every gradient block within 1e-5 * max(1, max|g|) of the
single-device gradient cut to JAX's spec, and the clip's norm within
1e-5 relative; the updated params within 1e-5 * max(1, max|p|) of
AdamW on the full tree with the gathered gradient; the sharded
prefill's and decode's logits and cache blocks within 1e-5 * max(1,
max|ref|) of the single-device steps' blocks (what the replicated
sharded steps were held to; the enc-dec's bf16 state within 1e-2, a
bf16 value's rounding, and its decode from the sharded prefill's state
on both sides); and every dense leaf the layers were handed in the
train, prefill and decode steps is its ``model`` block: none is
gathered over ``model``.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.models.registry import build_model as jbuild

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD_TIMEOUT_S = 300
LOSS_TOL = 1e-6
TOL = 1e-5
BF16_TOL = 1e-2

GRANITE = "granite-3-2b"
# name: (arch, config overrides, train, serve)
CASES = {
    "gqa": (GRANITE, {}, True, True),
    "heads6": (GRANITE, {"n_heads": 6, "head_dim": 8}, True, True),
    "heads6-pad8": (GRANITE, {"n_heads": 6, "head_dim": 8,
                              "pad_heads_to": 8}, True, True),
    "fused-qkv": (GRANITE, {"fused_qkv": True}, True, True),
    "fused-mlp": (GRANITE, {"fused_mlp": True}, True, True),
    "tied": (GRANITE, {"tie_embeddings": True}, True, True),
    "vocab131": (GRANITE, {"vocab": 131}, True, True),
    "zamba2": ("zamba2-1.2b", {"attn_backend": "relu_linear"}, True, True),
    "seamless": ("seamless-m4t-large-v2", {}, True, True),
    "grok-a2a": ("grok-1-314b", {"capacity_factor": 2.0}, True, True),
    "w8": (GRANITE, {}, False, True),
}
MESHES = ("1x4", "2x2")
KEYS = [f"{c}@{m}" for c in CASES for m in MESHES]


def _batch(cfg, rng):
    b = {"tokens": rng.integers(0, cfg.vocab, (8, 32)),
         "targets": rng.integers(0, cfg.vocab, (8, 32))}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((8, 24, cfg.d_model)).astype(
            np.float32)
    else:             # uneven token counts per dp shard
        b["mask"] = (rng.random((8, 32)) < np.linspace(0.3, 0.9, 8)[:, None]
                     ).astype(np.float32)
    return b


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_dist_tp"))
    cases, jax_loss = [], {}
    for name, (arch, kw, train, serve) in CASES.items():
        jc = jsmoke(JARCHS[arch]).scaled(**kw)
        jm = jbuild(jc)
        jp = jm.init(jax.random.PRNGKey(0))
        batch = _batch(jc, np.random.default_rng(3))
        if train:
            jax_loss[name] = float(jm.loss(jp, {
                k: jax.numpy.asarray(v) for k, v in batch.items()}))
        params = jax.tree.map(np.asarray, jp)
        for mesh in MESHES:
            cases.append({"name": name, "arch": arch, "kw": kw,
                          "mesh": mesh, "params": params, "batch": batch,
                          "w8": not train, "serve": serve})
    torch.save({"tp": cases}, os.path.join(out, "inputs.pt"))
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dist_world.py"), "tp",
         out], env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    ranks = [torch.load(os.path.join(out, f"tp_rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    return ranks, jax_loss


def _train(key):
    return CASES[key.partition("@")[0]][2]


def _within(entry):
    """An fp32 leaf within ``TOL``; the enc-dec's bf16 state (its caches
    are bf16 whatever ``kv_dtype``) within ``BF16_TOL``: a product
    summed in another order can round to the neighbouring bf16 value."""
    diff, top, *rest = entry
    tol = BF16_TOL if rest[1:] == ["torch.bfloat16"] else TOL
    return diff <= tol * max(1.0, top)


@pytest.mark.parametrize("key", [k for k in KEYS if _train(k)])
def test_tp_loss_matches_single_device_and_jax(world, key):
    ranks, jax_loss = world
    want = jax_loss[key.partition("@")[0]]
    for r in range(4):
        l1, l2 = ranks[r][key]["loss"]
        assert abs(l2 - l1) <= LOSS_TOL * abs(l1), (r, l1, l2)
        assert abs(l2 - want) <= LOSS_TOL * abs(want), (r, want, l2)


@pytest.mark.parametrize("key", [k for k in KEYS if _train(k)])
def test_tp_grads_and_norm(world, key):
    ranks, _ = world
    for r in range(4):
        e = ranks[r][key]
        for path, (diff, top, same) in e["grads"].items():
            assert same, (r, path)
            assert diff <= TOL * max(1.0, top), (r, path, diff, top)
        want, got = e["gnorm"]
        assert abs(got - want) <= TOL * want, (r, want, got)


@pytest.mark.parametrize("key", [k for k in KEYS if _train(k)])
def test_tp_step_params(world, key):
    ranks, _ = world
    for r in range(4):
        for path, (diff, top, same) in ranks[r][key]["params"].items():
            assert same, (r, path)
            assert diff <= TOL * max(1.0, top), (r, path, diff, top)


@pytest.mark.parametrize("key", [k for k in KEYS
                                 if CASES[k.partition("@")[0]][3]])
def test_tp_prefill_and_decode(world, key):
    ranks, _ = world
    for r in range(4):
        e = ranks[r][key]["serve"]
        if "prefill" in e:
            assert _within(e["prefill"]), (r, e["prefill"])
        for tag in ("prefill_caches", "decode_caches"):
            for path, entry in e[tag].items():
                assert _within(entry), (r, tag, path, entry)
        assert len(e["decode"]) == 4
        for t, entry in enumerate(e["decode"]):
            assert _within(entry), (r, t, entry)


@pytest.mark.parametrize("key", KEYS)
def test_tp_no_dense_leaf_gathered_over_model(world, key):
    """Every dense leaf the layers were handed in each sharded step is
    its ``model`` block, and ``model`` splits some of them."""
    ranks, _ = world
    calls = {"train", "prefill", "decode"} if _train(key) else \
        {"prefill", "decode"}
    for r in range(4):
        e = ranks[r][key]
        assert set(e["over"]) == calls, (r, sorted(e["over"]))
        for call in calls:
            assert e["over"][call] == [], (r, call, e["over"][call])
            assert e["split"][call] > 0, (r, call)


def test_tp_layouts_take_their_paths(world):
    """The traps are live: on (1, 4) the vocab of 131 is released (the
    logits whole) while granite's 128 is split; the decode's logits are
    the rank's (``dp``, ``vocab``) block."""
    ranks, _ = world
    assert ranks[0]["vocab131@1x4"]["serve"]["decode"][0][2] == (4, 131)
    assert ranks[0]["gqa@1x4"]["serve"]["decode"][0][2] == (4, 32)
    assert ranks[0]["gqa@2x2"]["serve"]["decode"][0][2] == (2, 64)
