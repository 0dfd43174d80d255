"""The port's training runtime on the CPU (``optim/``, ``checkpoint/``,
``data/``, ``runtime/``, ``launch/train.py``, ``convert.py``'s state
trees), held against the JAX package where JAX's passes.

Tolerances: ``adamw_update`` params, m, v and master within 1e-6 *
max|leaf| of JAX's at fp32, and each element within one bf16 step (2^-8
of it) for bf16 leaves; ``lr_scale`` within 1e-6; compression bit for
bit (int8 codes, fp32 scales, residuals); JAX-written checkpoints (fp32,
int32 and bf16 leaves) restore bit-equal in the port, and the port's
fp32 / int32 checkpoints restore bit-equal in JAX.  The trainer tests
are the port's versions of JAX's three trainer tests, which fail on
JAX's own trainer here (its mesh install, ROADMAP R2).
"""
import ast
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.common.tree import flatten_with_paths, global_norm
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import (
    DataConfig, SyntheticLMDataset, host_shard)
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compression as tcomp
from repro_torch.optim import schedule as tsched
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.runtime.trainer import (
    Trainer, TrainerConfig, make_failure_hook)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BF16_STEP = 2.0 ** -8


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def port(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def jax_leaves(tree) -> dict:
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def bits(t):
    """A tensor's raw bits as a numpy array (bf16 through int16)."""
    if isinstance(t, torch.Tensor):
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# AdamW, schedules, compression
# ---------------------------------------------------------------------------

def _tree(dtype, seed):
    rng = np.random.default_rng(seed)
    return {"a": jnp.asarray(rng.standard_normal((8, 16)), dtype),
            "n": {"b": jnp.asarray(rng.standard_normal((32,)) * 1e-3,
                                   dtype),
                  "c": jnp.asarray(rng.standard_normal((4, 4, 3)), dtype)}}


@pytest.mark.parametrize("param_dtype,state_dtype,master_dtype", [
    ("float32", None, "float32"),
    ("bfloat16", None, "float32"),
    ("bfloat16", "bfloat16", None)])
def test_adamw_update_matches_jax(param_dtype, state_dtype, master_dtype):
    """Two ``adamw_update`` steps (the clip active on the second, a
    schedule multiplier of 0.5) from the same params and JAX's
    ``adamw_init`` state carried over by ``params_from_jax`` (the state
    tree's step, m, v and master, bf16 bit for bit): fp32; bf16 params
    with an fp32 master; bf16 params and bf16 moments, no master."""
    cfg = jadamw.AdamWConfig(state_dtype=state_dtype,
                             master_dtype=master_dtype, grad_clip=5.0)
    tcfg = tadamw.AdamWConfig(**cfg.__dict__)
    jp = _tree(jnp.dtype(param_dtype), 0)
    jo = jadamw.adamw_init(jp, cfg)
    tp, to = port(jp), port(jo)
    assert ("master" in to) == ("master" in tadamw.adamw_init(tp, tcfg))
    for k, v in flatten_with_paths(tadamw.adamw_init(tp, tcfg)):
        assert bits(dict(flatten_with_paths(to))[k]).tobytes() == \
            bits(v).tobytes(), k
    for i, scale in enumerate((1.0, 40.0)):
        g = jax.tree.map(lambda x: x * scale, _tree(jnp.dtype(param_dtype),
                                                    i + 1))
        jp, jo = jadamw.adamw_update(g, jo, jp, cfg, lr_scale=0.5)
        tp, to = tadamw.adamw_update(port(g), to, tp, tcfg,
                                     lr_scale=torch.tensor(0.5))
    got = dict(flatten_with_paths({"p": tp, "o": to}))
    for path, leaf in jax_leaves({"p": jp, "o": jo}).items():
        t = got[path]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        a, b = _np(t), _np(leaf)
        if t.dtype == torch.bfloat16:     # each element within one step
            assert np.all(np.abs(a - b) <= BF16_STEP * np.abs(b)), path
        else:                             # relative to the leaf's size
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), path


def test_global_norm_matches_jax():
    jt = _tree(jnp.float32, 3)
    from repro.common.tree import global_norm as jnorm
    assert abs(float(global_norm(port(jt))) - float(jnorm(jt))) <= \
        1e-6 * float(jnorm(jt))


@pytest.mark.parametrize("kind", ["cosine", "linear", "constant"])
def test_lr_scale_matches_jax(kind):
    jc = jsched.ScheduleConfig(kind=kind, warmup_steps=10, total_steps=100,
                               min_ratio=0.1)
    tc = tsched.ScheduleConfig(**jc.__dict__)
    for step in (0, 1, 5, 9, 10, 11, 37, 55, 99, 100, 250):
        got = tsched.lr_scale(tc, step)
        assert got.dtype == torch.float32
        assert abs(float(got) - float(jsched.lr_scale(jc, step))) <= 1e-6
    assert float(tsched.lr_scale(tc, 0)) == 0.0
    with pytest.raises(ValueError):
        tsched.lr_scale(tsched.ScheduleConfig(kind="step"), 3)


def test_compression_is_bit_exact_against_jax():
    """``quantize_leaf``, ``dequantize_leaf`` and three rounds of
    ``compress_grads_with_feedback`` / ``decompress_grads`` (JAX op by
    op): every int8 code, scale and residual equal; codes of a
    half-way value round to even."""
    rng = np.random.default_rng(7)
    grads = {"w": rng.standard_normal((32, 32)).astype(np.float32),
             "b": {"x": (rng.standard_normal((16,)) * 1e-3).astype(
                 np.float32)}}
    with jax.disable_jit():
        jef = jcomp.init_error_feedback(grads)
        tef = tcomp.init_error_feedback(port(grads))
        for _ in range(3):
            jq, jef = jcomp.compress_grads_with_feedback(grads, jef)
            tq, tef = tcomp.compress_grads_with_feedback(port(grads), tef)
            for path, (q, s) in {"w": jq["w"], "b/x": jq["b"]["x"]}.items():
                node = tq
                for k in path.split("/"):
                    node = node[k]
                assert node[0].dtype == torch.int8
                assert np.array_equal(node[0].numpy(), np.asarray(q))
                assert node[1].item() == float(s)
            assert np.array_equal(tef["w"].numpy(), np.asarray(jef["w"]))
            jd = jcomp.decompress_grads(jq, grads)
            td = tcomp.decompress_grads(tq, port(grads))
            assert np.array_equal(td["b"]["x"].numpy(),
                                  np.asarray(jd["b"]["x"]))
    half = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5])
    q, scale = tcomp.quantize_leaf(half)
    assert scale.item() == 1.0 and q.tolist() == [127, 0, 2, 2, 0]
    assert q.element_size() * 4 == half.element_size()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jtree():
    rng = np.random.default_rng(4)
    return {"a": jnp.asarray(rng.standard_normal((4, 8)), jnp.float32),
            "nested": {"b": jnp.arange(6, dtype=jnp.int32),
                       "h": jnp.asarray(rng.standard_normal((3, 5)),
                                        jnp.bfloat16)},
            "step": jnp.int32(9)}


def test_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    """fp32, int32, a 0-dim int32 and bf16 leaves written by JAX's
    ``save`` come back in the port with their dtypes and bits, on the
    asked device."""
    jt = _jtree()
    jckpt.save(str(tmp_path), 7, jt, extra={"loss": 1.5})
    tmpl = port(jax.tree.map(jnp.zeros_like, jt))
    out, step, extra = tckpt.restore(str(tmp_path), tmpl, device="cpu")
    assert step == 7 and extra == {"loss": 1.5}
    for path, leaf in jax_leaves(jt).items():
        t = dict(flatten_with_paths(out))[path]
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
        assert bits(t).tobytes() == bits(leaf).tobytes(), path


def test_port_checkpoint_layout_is_jax_s(tmp_path):
    """The port writes JAX's layout byte for byte (directory, file names,
    manifest, every .npy, bf16 included); JAX's ``restore`` reads the
    port's fp32 / int32 leaves back bit-equal (it cannot read a bf16
    leaf, its own or the port's: ROADMAP R7); the port reads its own
    bf16."""
    jt = _jtree()
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jckpt.save(str(jdir), 3, jt, extra={"k": 1})
    tt = port(jt)
    tckpt.save(str(tdir), 3, tt, extra={"k": 1})
    jd, td = jdir / "step_00000003", tdir / "step_00000003"
    assert sorted(os.listdir(jd)) == sorted(os.listdir(td))
    for name in os.listdir(jd):
        assert (jd / name).read_bytes() == (td / name).read_bytes(), name
    flat = {k: v for k, v in jt.items() if k != "nested"}
    flat["nested"] = {"b": jt["nested"]["b"]}
    tflat = {k: v for k, v in tt.items() if k != "nested"}
    tflat["nested"] = {"b": tt["nested"]["b"]}
    tckpt.save(str(tmp_path / "p2"), 4, tflat)
    out, step, _ = jckpt.restore(str(tmp_path / "p2"), flat)
    assert step == 4
    for path, leaf in jax_leaves(flat).items():
        assert bits(jax_leaves(out)[path]).tobytes() == \
            bits(leaf).tobytes()
    with pytest.raises(TypeError):
        jckpt.restore(str(tdir), jt)
    back, _, _ = tckpt.restore(str(tdir), tt)
    assert bits(back["nested"]["h"]).tobytes() == \
        bits(tt["nested"]["h"]).tobytes()


def test_checkpoint_atomicity(tmp_path):
    """A ``.tmp`` directory (a crash mid-write) is invisible, and so is a
    step directory without its manifest."""
    tckpt.save(str(tmp_path), 5, port(_jtree()))
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000011")
    assert tckpt.latest_step(str(tmp_path)) == 5
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore(str(tmp_path / "none"), {})


def test_checkpoint_manager_async_and_gc(tmp_path):
    """``keep=2`` leaves the newest two steps; a crash's ``.tmp`` is
    removed; the snapshot is taken at ``save_async``, not at write."""
    os.makedirs(tmp_path / "step_00000001.tmp")
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    t = port(_jtree())
    for s in (10, 20, 30):
        mgr.save_async(s, t)
        saved = t["a"].clone()
        t["a"].add_(1.0)
    mgr.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000020",
                                            "step_00000030"]
    out, step, _ = tckpt.restore(str(tmp_path), t)
    assert step == 30
    assert torch.equal(out["a"], saved)


def test_restore_shape_mismatch_and_missing_leaf_raise(tmp_path):
    t = port(_jtree())
    tckpt.save(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(str(tmp_path), dict(t, a=torch.zeros((5, 8))))
    with pytest.raises(KeyError):
        tckpt.restore(str(tmp_path), dict(t, z=torch.zeros(2)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_data_deterministic_and_step_keyed():
    cfg = DataConfig(vocab=64, seq_len=16, global_batch=8)
    d1, d2 = (SyntheticLMDataset(cfg, "cpu") for _ in range(2))
    b1 = d1.global_batch(3)
    assert b1["tokens"].shape == (8, 16)
    assert torch.equal(b1["tokens"], d2.global_batch(3)["tokens"])
    assert not torch.equal(d1.global_batch(4)["tokens"], b1["tokens"])
    other = SyntheticLMDataset(DataConfig(64, 16, 8, seed=1), "cpu")
    assert not torch.equal(other.global_batch(3)["tokens"], b1["tokens"])
    assert 0 <= int(b1["tokens"].min()) and int(b1["tokens"].max()) < 64


def test_host_shards_tile_the_global_batch():
    ds = SyntheticLMDataset(DataConfig(vocab=64, seq_len=16,
                                       global_batch=8), "cpu")
    g = ds.global_batch(11)
    for n in (4, 2):
        parts = [ds.host_batch(11, i, n)["tokens"] for i in range(n)]
        assert torch.equal(torch.cat(parts), g["tokens"])
    with pytest.raises(ValueError):
        host_shard(g, 0, 3)


def test_targets_shift_by_one_and_the_chain_is_learnable():
    """Targets are the tokens shifted by one; sharp transitions have a
    mean row entropy well below ln V (the floor a model can reach)."""
    ds = SyntheticLMDataset(DataConfig(vocab=64, seq_len=16,
                                       global_batch=2), "cpu")
    b = ds.global_batch(0)
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])
    assert 0.0 < ds.optimal_loss_estimate() < 0.8 * np.log(64)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

def test_straggler_flagging():
    mon = StragglerMonitor(min_samples=8, k_mad=4.0)
    rng = np.random.default_rng(0)
    for _ in range(16):
        times = {f"h{i}": 1.0 + rng.normal(0, 0.01) for i in range(8)}
        times["h3"] = 1.8 + rng.normal(0, 0.01)   # consistent straggler
        mon.record_step(times)
    rep = mon.report()
    assert rep.flagged == ["h3"]
    assert rep.slowest[0][0] == "h3"
    assert mon.should_evict() == ["h3"]


def test_straggler_no_false_positives():
    mon = StragglerMonitor(min_samples=8)
    assert mon.report() is None
    rng = np.random.default_rng(1)
    for _ in range(16):
        mon.record_step({f"h{i}": 1.0 + rng.normal(0, 0.02)
                         for i in range(8)})
    assert mon.report().flagged == []


# ---------------------------------------------------------------------------
# trainer and launcher
# ---------------------------------------------------------------------------

def _trainer(tmp_path, *, steps=30, hook=None, arch="granite-3-2b"):
    cfg = smoke_variant(get_arch(arch))
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                      sharpness=4.0)
    tcfg = TrainerConfig(total_steps=steps, ckpt_every=10,
                         ckpt_dir=str(tmp_path / "ckpt"), log_every=100)
    return Trainer(cfg, data, tcfg, device="cpu", failure_hook=hook)


def test_train_loss_decreases(tmp_path):
    out = _trainer(tmp_path, steps=40).run()
    first5, last5 = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
    assert last5 < first5 - 0.1, (first5, last5)
    assert all(np.isfinite(out["losses"]))


def test_failure_recovery_resumes_from_checkpoint(tmp_path):
    """A failure at step 25 restores step 20 and reruns 20..29: 25 + 10
    losses, the rerun's first five equal to the first run's steps 20..24
    (the same state and batches on the CPU), and step 30 saved."""
    tr = _trainer(tmp_path, steps=30, hook=make_failure_hook([25]))
    out = tr.run()
    assert len(out["losses"]) == 35
    assert out["losses"][25:30] == out["losses"][20:25]
    assert tckpt.latest_step(str(tmp_path / "ckpt")) == 30


def test_restart_budget_exhausted(tmp_path):
    tr = _trainer(tmp_path, steps=10,
                  hook=make_failure_hook([0, 1, 2, 3, 4, 5, 6, 7]))
    tr.cfg.max_restarts = 2
    with pytest.raises(RuntimeError, match="restart budget"):
        tr.run()


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    out = ttrain.main(["--arch", "mamba2-1.3b", "--smoke", "--steps", "3",
                       "--seq", "32", "--device", "cpu", "--ckpt-dir",
                       str(tmp_path)])
    assert len(out["losses"]) == 3
    assert "final loss:" in capsys.readouterr().out


def test_no_port_module_imports_jax_or_the_reference():
    """No module of ``repro_torch`` and not ``chip_smoke.py`` imports
    ``jax`` or the JAX package ``repro`` (at any depth, inside functions
    too)."""
    files = list((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 50
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro", "jaxlib"), \
                    (f, n)
