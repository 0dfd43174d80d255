"""The port's sharded training on the CPU: a 4-rank gloo world
(``tests/torch_dist_world.py``, suite ``train``, started once by a
module fixture) on ``("data", "model")`` meshes.

  * The sharded train step (``make_train_step(ctx=, specs=)``: the
    rank's blocks of the params and AdamW state, its ``dp`` slice of the
    batch) on (2, 2) for granite-3-2b (with a mask whose token count
    differs per shard), zamba2-1.2b (the scans' plain versions) and
    grok-1-314b (4 experts: ``moe_shard_map`` in ``a2a``), and for
    grok-1-314b on (4, 1) (``_moe_global``), at smoke width, against the
    port's single-device ``value_and_grad`` (which
    ``tests/test_torch_train.py`` holds against JAX's): the loss within
    1e-6 relative; each rank's gradient block
    (``sharded_value_and_grad``) within 1e-5 * max(1, max|g|) of the
    single-device gradient's block, so a gradient off by any factor
    fails; the clip's global norm within 1e-5 relative; and the step's
    updated params within 1e-5 * max(1, max|p|) of AdamW on the full
    tree with the gathered gradient and that norm.  The expert weights'
    gradients come back at the size of the rank's block.  The MoE
    capacity holds every token (C >= T), so neither path drops one.
  * ``Trainer(mesh=)`` with a failure injected at step 6 resumes from
    its step-4 checkpoint, and steps 4 and 5 repeat their losses bit for
    bit.
  * ``pipelined_apply`` over ``pod`` (2 stages) against a sequential
    reference, forward within 2e-5 and the stage gradients within 2e-4
    (JAX's bounds), alone and with the microbatches split over ``data``
    inside a stage (the gradients summed over ``data``).
  * The sharded step with ``grad_accum=2`` (granite-3-2b on (2, 2), the
    rank's rows of each global microbatch, a mask whose token counts
    differ between the microbatches) against the single-device
    ``grad_accum=2`` step on the global batch, at the bounds above.
  * The sharded prefill and 4 sharded decode steps
    (``make_prefill_step`` / ``make_serve_step(ctx=)``) against the
    single-device ones on the global batch of 4 rows, for granite-3-2b
    (softmax, the KV sequence on ``model``), gemma3-12b (the sliding
    ring, wrapping during the decode), zamba2-1.2b (relu_linear and
    Mamba states split over heads) and grok-1-314b (``a2a`` prefill and
    per-row decode groups on (2, 2); ``_moe_global`` on (4, 1) at
    capacity factor 0.5, where the prefill drops tokens): each rank's
    logits block and cache blocks within 1e-5 * max(1, max|ref|), fp32
    smoke weights and fp32 caches.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.layers.moe import _capacity
from repro_torch.models.lm import moe_cfg

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, HERE)

from torch_dist_world import (  # noqa: E402
    SERVE_CASES, TRAIN_CASES, serve_arch, train_arch)

WORLD_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_dist_train"))
    env = dict(os.environ, PYTHONPATH=SRC)
    run = subprocess.run(
        [sys.executable, os.path.join(HERE, "torch_dist_world.py"), "train",
         out], env=env, capture_output=True, text=True,
        timeout=WORLD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    return [torch.load(os.path.join(out, f"train_rank{r}.pt"),
                       weights_only=False) for r in range(4)]


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_step_loss(world, arch):
    for r in range(4):
        l1, l2 = world[r]["steps"][arch]["loss"]
        assert abs(l1 - l2) <= 1e-6 * abs(l1), (r, l1, l2)


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_step_grads(world, arch):
    for r in range(4):
        for path, (diff, top, same) in \
                world[r]["steps"][arch]["grads"].items():
            assert same, (r, path)
            assert diff <= 1e-5 * max(1.0, top), (r, path, diff, top)


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_step_gnorm(world, arch):
    for r in range(4):
        want, got = world[r]["steps"][arch]["gnorm"]
        assert abs(got - want) <= 1e-5 * want, (r, want, got)


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_step_params(world, arch):
    for r in range(4):
        for path, (diff, top, same) in \
                world[r]["steps"][arch]["params"].items():
            assert same, (r, path)
            assert diff <= 1e-5 * max(1.0, top), (r, path, diff, top)


@pytest.mark.parametrize("arch", TRAIN_CASES)
def test_sharded_step_really_shards(world, arch):
    s = world[0]["steps"][arch]
    assert s["sharded_leaves"] > 0
    dp = 4 if arch.endswith("@4x1") else 2
    assert s["local_batch"] == (8 // dp, 32)     # the dp slice of 8 rows


@pytest.mark.parametrize("arch", [a for a in TRAIN_CASES if "grok" in a])
def test_expert_grads_stay_blocks(world, arch):
    """No rank gathers the expert weights whole: each expert leaf's
    gradient is its block's size, a quarter of the (L, E, D, F) leaf
    (E over model and D over data on (2, 2); D over data on (4, 1))."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import smoke_variant
    cfg = smoke_variant(get_arch("grok-1-314b"))
    full = cfg.n_layers * cfg.n_experts * cfg.d_model * cfg.d_ff
    for r in range(4):
        blocks = world[r]["steps"][arch]["expert_blocks"]
        assert len(blocks) == 3                   # w_in, w_gate, w_out
        for shape, gshape in blocks:
            assert gshape == shape
            assert int(np.prod(shape)) * 4 == full, shape


def test_capacity_holds_every_token():
    mcfg = moe_cfg(train_arch("grok-1-314b"))
    for tokens in (8 * 32, 4 * 32, 4 * 16):   # one device, dp, a2a slice
        assert _capacity(mcfg, tokens) >= tokens


def test_trainer_resumes_bit_equal(world):
    for r in range(4):
        t = world[r]["trainer"]
        losses = t["losses"]
        # steps 0-5, the failure at 6, steps 4-7 again from the checkpoint
        assert len(losses) == 10
        assert losses[4:6] == losses[6:8]
        assert all(np.isfinite(losses))
        assert t["mesh"] == (2, 2)
    assert all(world[r]["trainer"]["losses"] == world[0]["trainer"]["losses"]
               for r in range(4))


def test_trainer_holds_blocks(world):
    # embed/table (V=128, D=64): vocab over model, fsdp over data
    assert world[0]["trainer"]["final_shapes"] == {"table": (64, 32)}


def test_launcher_under_torchrun(tmp_path):
    """``launch/train.py`` under ``torchrun --standalone`` (a free port):
    two gloo ranks on a (1, 2) mesh, rank 0 prints."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--mesh", "1x2", "--smoke", "--steps", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    assert run.returncode == 0, run.stderr[-4000:]
    lines = [ln for ln in run.stdout.splitlines()
             if ln.startswith("final loss")]
    assert len(lines) == 1 and lines[0].endswith("on cpu on a (1, 2) mesh")


def _seq_reference(L, D, M, mb, S):
    rng = np.random.default_rng(0)
    Ws = torch.tensor(rng.standard_normal((L, D, D)) * 0.3,
                      dtype=torch.float32).requires_grad_()
    x = torch.tensor(rng.standard_normal((M, mb, S, D)), dtype=torch.float32)
    h = x
    for w in Ws:
        h = torch.tanh(h @ w)
    (g,) = torch.autograd.grad((h ** 2).sum(), Ws)
    return h.detach().numpy(), g.numpy()


PIPES = {"alone": (4, 16, 4, 2, 8), "dp": (2, 8, 2, 8, 4)}


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_forward(world, name):
    y, _ = _seq_reference(*PIPES[name])
    mb = PIPES[name][3]
    for r in range(4):
        got = world[r]["pipeline"][name]["y"]
        want = y if name == "alone" else \
            y[:, (r % 2) * mb // 2:(r % 2 + 1) * mb // 2]
        assert np.abs(got - want).max() < 2e-5


@pytest.mark.parametrize("name", sorted(PIPES))
def test_pipeline_backward(world, name):
    _, g = _seq_reference(*PIPES[name])
    for r in range(4):
        assert np.abs(world[r]["pipeline"][name]["grad"] - g).max() < 2e-4


def test_grad_accum_step_loss(world):
    for r in range(4):
        a = world[r]["accum"]
        l1, l2 = a["loss"]
        assert abs(l1 - l2) <= 1e-6 * abs(l1), (r, l1, l2)
        assert a["counts"][0] != a["counts"][1]     # the mask matters
        assert a["local_batch"] == (4, 32)


def test_grad_accum_step_grads_and_norm(world):
    for r in range(4):
        a = world[r]["accum"]
        for path, (diff, top, same) in a["grads"].items():
            assert same, (r, path)
            assert diff <= 1e-5 * max(1.0, top), (r, path, diff, top)
        want, got = a["gnorm"]
        assert abs(got - want) <= 1e-5 * want, (r, want, got)


def test_grad_accum_step_params(world):
    for r in range(4):
        for path, (diff, top, same) in world[r]["accum"]["params"].items():
            assert same, (r, path)
            assert diff <= 1e-5 * max(1.0, top), (r, path, diff, top)


def _within(entry):
    diff, top, _ = entry
    return diff <= 1e-5 * max(1.0, top)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_prefill(world, case):
    for r in range(4):
        e = world[r]["serve"][case]
        assert _within(e["prefill"]), (r, e["prefill"])
        for path, entry in e["prefill_caches"].items():
            assert _within(entry), (r, path, entry)


@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_decode(world, case):
    for r in range(4):
        e = world[r]["serve"][case]
        assert len(e["decode"]) == 4
        for t, entry in enumerate(e["decode"]):
            assert _within(entry), (r, t, entry)
        for path, entry in e["decode_caches"].items():
            assert _within(entry), (r, path, entry)


def test_sharded_decode_splits_the_caches(world):
    """Every cache is the rank's block: the KV sequence (softmax and the
    sliding ring) and the relu_linear / Mamba heads on ``model``, the
    rows on ``data``; the logits' vocab on ``model``."""
    split = {c: world[0]["serve"][c]["split"] for c in SERVE_CASES}
    assert split["granite-3-2b"]["blocks/k"] == \
        "PartitionSpec(None, 'data', 'model', None, None)"
    assert split["gemma3-12b"]["local/k"] == \
        "PartitionSpec(None, None, 'data', 'model', None, None)"
    assert split["zamba2-1.2b"]["shared_attn/state"] == \
        "PartitionSpec(None, 'data', 'model', None, None)"
    assert split["zamba2-1.2b"]["mamba_groups/ssm"] == \
        "PartitionSpec(None, None, 'data', 'model', None, None)"
    assert split["zamba2-1.2b"]["mamba_groups/conv"] == \
        "PartitionSpec(None, None, 'data', None, 'model')"
    for c in SERVE_CASES:
        rows = 1 if c.endswith("@4x1") else 2
        vocab = serve_arch(c).vocab // (1 if c.endswith("@4x1") else 2)
        assert world[0]["serve"][c]["prefill"][2] == (rows, vocab)


def test_sharded_prefill_drops_like_one_device(world):
    """At capacity factor 0.5 the global batch's prefill drops
    assignments; the sharded prefill's logits equal the single-device
    ones (above), so it drops the same ones.  Decode's per-row groups
    hold every token (capacity 8 a row)."""
    assert world[0]["serve"]["grok-1-314b@4x1"]["dropped"] > 0
    assert world[0]["serve"]["grok-1-314b"]["dropped"] == 0
