"""The port's ``distributed/`` layer on the CPU, against the JAX package.

In process, with no process group: ``resolve_param_spec`` /
``match_partition_rules`` give JAX's spec for every param of the 10
archs at published width (JAX's ``jax.eval_shape`` trees, handed to the
port as meta tensors) and for every decode-cache leaf (JAX's
``init_caches(8, 64)`` at smoke width), on JAX's production meshes
(16, 16) and (2, 16, 16): resolution reads only the mesh's axis names
and sizes, so both sides take a stub of them.  Specs compare as strings.

In a 4-rank gloo world (``tests/torch_dist_world.py``, started once by a
module fixture, beside one JAX subprocess on 4 fake CPU devices):
  * every collective against its ``jax.lax`` meaning on a (2, 2) mesh,
    forward exactly and its backward (the gradient of the SUM over ranks
    of each rank's objective) within 1e-6;
  * ``compressed_psum`` bit-equal to its numpy formula and within JAX's
    relative 0.01 of the plain sum;
  * the MoE dispatcher ``moe``: ``moe_shard_map`` in ``a2a`` and
    ``repl`` on (2, 2) and ``tp`` on (1, 4), and the global batch's path
    (``_moe_global``) on (4, 1) and with 3 experts on (2, 2), where no
    mode applies, at capacity factor 8 and at 0.5 (where tokens drop),
    with float expert weights as the rank's blocks and W8 ones whole,
    against JAX's ``moe`` on the same inputs (its ``moe_dense`` on the
    global batch where no mode applies, since JAX's sharding constraint
    there fails, ROADMAP R2): y within 1e-5, aux within 1e-6, the same
    dropped assignments per rank, gradients finite and non-zero;
  * ``reshard_tree`` and the cross-mesh checkpoint: a (2, 2) save
    restored and live-resharded onto a (1, 2) mesh of 2 survivors, leaves
    bit-equal, the files byte-equal to a single-device save.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import smoke_variant as jsmoke
from repro.distributed import partition as jpart
from repro.distributed.rules import CACHE_RULES as JCACHE_RULES
from repro.distributed.rules import LM_RULES as JLM_RULES
from repro.models.registry import build_model as jbuild
from repro_torch.common.tree import flatten_with_paths
from repro_torch.distributed import partition as tpart
from repro_torch.distributed.rules import CACHE_RULES, LM_RULES

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
WORLD_TIMEOUT_S = 300
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


class _StubMesh:
    """What resolution reads of a mesh: axis names, a devices shape."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _meta(tree):
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return torch.empty(tuple(tree.shape), device="meta")


def _jax_specs(rules, shapes, mesh):
    from repro.common.tree import flatten_with_paths as jflat

    specs = jpart.match_partition_rules(rules, shapes, jpart.make_ctx(mesh))
    return {p: str(s) for p, s in jflat(specs)}


def _port_specs(rules, shapes, mesh):
    specs = tpart.match_partition_rules(rules, _meta(shapes),
                                        tpart.make_ctx(mesh))
    return {p: str(s) for p, s in flatten_with_paths(specs)}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_param_specs_match_jax(arch, mesh):
    model = jbuild(JARCHS[arch])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    stub = _StubMesh(*MESHES[mesh])
    want = _jax_specs(JLM_RULES, shapes, stub)
    got = _port_specs(LM_RULES, shapes, stub)
    assert got == want
    assert any("'model'" in s for s in want.values())   # something splits


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(JARCHS))
def test_cache_specs_match_jax(arch, mesh):
    model = jbuild(jsmoke(JARCHS[arch]))
    shapes = jax.eval_shape(lambda: model.init_caches(8, 64))
    stub = _StubMesh(*MESHES[mesh])
    want = _jax_specs(JCACHE_RULES, shapes, stub)
    assert want
    assert _port_specs(CACHE_RULES, shapes, stub) == want


@pytest.mark.parametrize("logical,shape,want", [
    (("fsdp", "tp"), (8, 16), "PartitionSpec('data', 'model')"),
    (("ep", "fsdp", "tp"), (3, 8, 16), "PartitionSpec(None, 'data', 'model')"),
    (("fsdp", "tp"), (7, 8, 16), "PartitionSpec(None, 'data', 'model')"),
    (("dp", "tp"), (6, 16), "PartitionSpec('data', 'model')"),
])
def test_resolution_cases(logical, shape, want):
    """JAX's own resolution cases on a (2, 4) mesh: divisibility release,
    right alignment."""
    stub = _StubMesh((2, 4), ("data", "model"))
    jspec = jpart.resolve_param_spec(jpart.make_ctx(stub), logical, shape)
    tspec = tpart.resolve_param_spec(tpart.make_ctx(stub), logical, shape)
    assert str(tspec) == str(jspec) == want


def test_data_parallel_specs_replicate():
    stub = _StubMesh((4,), ("batch",))
    params = {"a": torch.empty((3, 4), device="meta"),
              "b": {"c": torch.empty((5,), device="meta")}}
    specs, act = tpart.data_parallel_specs(stub, params)
    assert str(act) == "PartitionSpec('batch',)"
    assert {p: str(s) for p, s in flatten_with_paths(specs)} == {
        "a": "PartitionSpec(None, None)", "b/c": "PartitionSpec(None,)"}


def test_named_sharding_placements():
    from torch.distributed.tensor import Shard
    from repro_torch.distributed.ctx import (
        NamedSharding, ShardingCtx, named_sharding, use_sharding)
    stub = _StubMesh((2, 4, 8), ("pod", "data", "model"))
    ns = NamedSharding(stub, tpart.PartitionSpec(("pod", "data"), None,
                                                 "model"))
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    ctx = tpart.make_ctx(stub)
    assert named_sharding("dp", None) is None
    with use_sharding(ctx):
        got = named_sharding("dp", None, "tp")
    assert isinstance(got, NamedSharding) and isinstance(ctx, ShardingCtx)
    assert str(got.spec) == "PartitionSpec(('pod', 'data'), None, 'model')"
    assert got.placements == (Shard(0), Shard(0), Shard(2))


def test_shard_checks_rank_under_a_ctx():
    from repro_torch.distributed.ctx import shard, use_sharding
    x = torch.zeros((2, 3))
    assert shard(x, "dp") is x                    # no ctx: no check
    with use_sharding(tpart.make_ctx(_StubMesh((2, 2), ("data", "model")))):
        assert shard(x, "dp", None) is x
        with pytest.raises(ValueError, match="rank 2"):
            shard(x, "dp")


def test_moe_groups_refused_under_a_ctx():
    """Token groups run under a ctx too (the sharded decode's rows; the
    gloo world holds them against one device), but groups that do not
    split the rank's tokens are refused there, before any collective."""
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.layers.moe import MoeConfig, init_moe, moe
    cfg = MoeConfig(d_model=8, d_ff=16, n_experts=4, top_k=2)
    params = init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.zeros((2, 1, 8))
    moe(params, x, cfg, groups=2)                 # one device: fine
    with use_sharding(tpart.make_ctx(_StubMesh((1, 2), ("data", "model")))):
        with pytest.raises(ValueError, match="do not split"):
            moe(params, x, cfg, groups=3)


def test_meshes_need_a_process_group():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(device="cpu")


# ---------------------------------------------------------------------------
# the 4-rank world and the JAX reference
# ---------------------------------------------------------------------------

MOE_CASES = {   # name: (mesh, n_experts, top_k, x shape)
    "a2a": ("2x2", 8, 2, (4, 64, 32)),
    "repl": ("2x2", 8, 2, (64, 1, 32)),
    "tp": ("1x4", 2, 1, (4, 64, 32)),
    # no mode applies (model 1; 3 experts on 2): the global batch
    "global": ("4x1", 8, 2, (8, 16, 32)),
    "nomode": ("2x2", 3, 1, (4, 16, 32)),
}
MESH_SHAPES = {"2x2": (2, 2), "1x4": (1, 4), "4x1": (4, 1)}
CAPACITY = {"cf8": 8.0, "drop": 0.5}


def _moe_inputs():
    cases = []
    for i, (mode, (mesh, E, k, xshape)) in enumerate(sorted(
            MOE_CASES.items())):
        rng = np.random.default_rng(40 + i)
        D, F = 32, 64
        params = {
            "router": {"w": (rng.standard_normal((D, E)) * D ** -0.5)},
            "w_in": rng.standard_normal((E, D, F)) * D ** -0.5,
            "w_gate": rng.standard_normal((E, D, F)) * D ** -0.5,
            "w_out": rng.standard_normal((E, F, D)) * F ** -0.5}
        params = {k_: ({kk: v.astype(np.float32) for kk, v in p.items()}
                       if isinstance(p, dict) else p.astype(np.float32))
                  for k_, p in params.items()}
        x = rng.standard_normal(xshape).astype(np.float32)
        cfg = dict(d_model=D, d_ff=F, n_experts=E, top_k=k)
        for tag, cf in sorted(CAPACITY.items()):
            cases.append({"name": f"{mode}-{tag}", "mesh": mesh, "x": x,
                          "params": params,
                          "cfg": dict(cfg, capacity_factor=cf)})
        w8 = dict(params, **{n: _w8(params[n]) for n in
                             ("w_in", "w_gate", "w_out")})
        cases.append({"name": f"{mode}-w8", "mesh": mesh, "x": x,
                      "params": w8, "cfg": dict(cfg, capacity_factor=8.0)})
    return cases


def _w8(w):
    """A W8 expert weight: int8 codes and a per-(expert, column) fp32
    scale (E, 1, out), as ``quantize_lm_params`` lays it out."""
    scale = np.maximum(np.abs(w).max(axis=1, keepdims=True), 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return {"q": q, "scale": scale.astype(np.float32)}


_JAX_MOE = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import importlib, json, sys
import jax, jax.numpy as jnp
import numpy as np
from repro.distributed.ctx import use_sharding
from repro.distributed.partition import make_ctx
M = importlib.import_module("repro.layers.moe")

out = sys.argv[1]
cases = json.load(open(os.path.join(out, "moe_cases.json")))
arrays = np.load(os.path.join(out, "moe_inputs.npz"))
res = {}
for c in cases:
    n = c["name"]
    if n == "tp-w8":      # JAX's tp mode cannot dequantize W8 weights
        continue
    cfg = M.MoeConfig(**c["cfg"])
    def w(k):
        if n + "/" + k + "/q" in arrays:
            return {"q": jnp.asarray(arrays[n + "/" + k + "/q"]),
                    "scale": jnp.asarray(arrays[n + "/" + k + "/scale"])}
        return jnp.asarray(arrays[n + "/" + k])
    p = {"router": {"w": jnp.asarray(arrays[n + "/router"])},
         "w_in": w("w_in"), "w_gate": w("w_gate"), "w_out": w("w_out")}
    x = jnp.asarray(arrays[n + "/x"])
    shape = tuple(c["shape"])
    dp, ep = shape
    B, S, D = x.shape
    E = cfg.n_experts
    sharded = ep > 1 and (E % ep == 0 or ep % E == 0)
    if sharded:
        mesh = jax.make_mesh(shape, ("data", "model"))
        ctx = make_ctx(mesh)
        with use_sharding(ctx), mesh:
            y, aux = jax.jit(lambda p, x: M.moe(p, x, cfg))(p, x)
    else:   # what JAX's moe computes there (its sharding constraint on
        # the global array fails under this JAX, ROADMAP R2): moe_dense
        y, aux = jax.jit(lambda p, x: M.moe_dense(p, x, cfg))(p, x)
    res[n + "/y"] = np.asarray(y)
    res[n + "/aux"] = np.asarray(aux)
    a2a = sharded and E % ep == 0 and S % ep == 0 and S > 1
    if not sharded:       # moe_dense on the global batch
        _, idx, _ = M._route(x.reshape(-1, D), p["router"]["w"], cfg)
        _, valid = M._slot_assign(idx, E, M._capacity(cfg, B * S))
        valid = np.asarray(valid).reshape(dp, -1, cfg.top_k)
    for d in range(dp):
        for j in range(ep):
            if not sharded:
                res[f"{n}/dropped/{d * ep + j}"] = ~valid[d]
                continue
            xs = x[d * B // dp:(d + 1) * B // dp]
            if a2a:
                xs = xs[:, j * S // ep:(j + 1) * S // ep]
            xt = xs.reshape(-1, D)
            _, idx, _ = M._route(xt, p["router"]["w"], cfg)
            _, valid_r = M._slot_assign(idx, E,
                                        M._capacity(cfg, xt.shape[0]))
            res[f"{n}/dropped/{d * ep + j}"] = ~np.asarray(valid_r)
np.savez(os.path.join(out, "jax_moe.npz"), **res)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_dist"))
    cases = _moe_inputs()
    torch.save({"moe": cases}, os.path.join(out, "inputs.pt"))
    arrays = {}
    for c in cases:
        arrays[c["name"] + "/x"] = c["x"]
        arrays[c["name"] + "/router"] = c["params"]["router"]["w"]
        for k in ("w_in", "w_gate", "w_out"):
            w = c["params"][k]
            if isinstance(w, dict):
                for kk, v in w.items():
                    arrays[f"{c['name']}/{k}/{kk}"] = v
            else:
                arrays[c["name"] + "/" + k] = w
    np.savez(os.path.join(out, "moe_inputs.npz"), **arrays)
    with open(os.path.join(out, "moe_cases.json"), "w") as f:
        json.dump([dict({k: c[k] for k in ("name", "mesh", "cfg")},
                        shape=MESH_SHAPES[c["mesh"]]) for c in cases], f)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_MOE), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        run = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_dist_world.py"),
             "dist", out], env=env, capture_output=True, text=True,
            timeout=WORLD_TIMEOUT_S)
        _, jerr = jax_proc.communicate(timeout=WORLD_TIMEOUT_S)
    finally:
        jax_proc.kill()
    assert run.returncode == 0, run.stderr[-4000:]
    assert jax_proc.returncode == 0, jerr[-4000:]
    ranks = [torch.load(os.path.join(out, f"dist_rank{r}.pt"),
                        weights_only=False) for r in range(4)]
    jref = dict(np.load(os.path.join(out, "jax_moe.npz")))
    return {"ranks": ranks, "jax": jref, "out": out}


# ---------------------------------------------------------------------------
# collectives: rank r sits at (data, model) = divmod(r, 2)
# ---------------------------------------------------------------------------

GROUPS = {"data": lambda r: [r % 2, 2 + r % 2],
          "model": lambda r: [r - r % 2, r - r % 2 + 1],
          "data+model": lambda r: [0, 1, 2, 3]}
INDEX = {"data": lambda r: r // 2, "model": lambda r: r % 2,
         "data+model": lambda r: r}


def _col(world, r, key):
    return world["ranks"][r]["collectives"][key]


def _w(r, shape):
    """The cotangent rank r used for the op (the worker's seeds)."""
    return np.random.default_rng(100 + r).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("axes", sorted(GROUPS))
def test_axis_index_and_size(world, axes):
    for r in range(4):
        assert _col(world, r, f"axis_index/{axes}") == INDEX[axes](r)
        assert _col(world, r, f"axis_size/{axes}") == len(GROUPS[axes](r))


@pytest.mark.parametrize("op", ["psum", "pmean", "pmax"])
@pytest.mark.parametrize("axes", sorted(GROUPS))
def test_reductions(world, op, axes):
    for r in range(4):
        xs = np.stack([_col(world, q, "x") for q in GROUPS[axes](r)])
        x = _col(world, r, "x")
        y = _col(world, r, f"{op}/{axes}")
        ws = np.stack([_w(q, x.shape) for q in GROUPS[axes](r)])
        n = len(xs)
        if op == "psum":
            want, grad = xs.sum(0), ws.sum(0)
        elif op == "pmean":
            want, grad = xs.sum(0) / np.float32(n), ws.sum(0) / n
        else:
            want = xs.max(0)
            grad = ws.sum(0) * (x == want)
        np.testing.assert_allclose(y, want, rtol=1e-6, atol=1e-6)
        if op == "pmax":
            assert np.array_equal(y, want)
        np.testing.assert_allclose(_col(world, r, f"{op}/{axes}/grad"), grad,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("ax", [0, 1])
@pytest.mark.parametrize("axes", sorted(GROUPS))
def test_all_gather(world, axes, ax):
    for r in range(4):
        group = GROUPS[axes](r)
        want = np.concatenate([_col(world, q, "x") for q in group], axis=ax)
        assert np.array_equal(_col(world, r, f"all_gather/{axes}/{ax}"), want)
        # backward: the sum over the group of each rank's cotangent, cut
        # to this rank's block
        w = sum(_w(q, want.shape) for q in group)
        n = _col(world, r, "x").shape[ax]
        blk = np.take(w, range(INDEX[axes](r) * n, (INDEX[axes](r) + 1) * n),
                      axis=ax)
        np.testing.assert_allclose(
            _col(world, r, f"all_gather/{axes}/{ax}/grad"), blk, rtol=1e-6,
            atol=1e-6)


def _np_a2a(xs, me, split, concat):
    """lax.all_to_all(tiled) for index ``me`` of a group holding ``xs``."""
    return np.concatenate([np.array_split(x, len(xs), axis=split)[me]
                           for x in xs], axis=concat)


@pytest.mark.parametrize("sc", ["01", "10", "00"])
def test_all_to_all(world, sc):
    s, c = int(sc[0]), int(sc[1])
    for r in range(4):
        group = GROUPS["model"](r)
        me = INDEX["model"](r)
        want = _np_a2a([_col(world, q, "x") for q in group], me, s, c)
        assert np.array_equal(_col(world, r, f"all_to_all/{sc}"), want)
        ws = [_w(q, want.shape) for q in group]
        np.testing.assert_allclose(_col(world, r, f"all_to_all/{sc}/grad"),
                                   _np_a2a(ws, me, c, s), rtol=0, atol=0)


def test_ppermute(world):
    for r in range(4):
        x = _col(world, r, "x")
        partner = r ^ 1                       # the model swap
        assert np.array_equal(_col(world, r, "ppermute/swap"),
                              _col(world, partner, "x"))
        assert np.array_equal(_col(world, r, "ppermute/swap/grad"),
                              _w(partner, x.shape))
        # data: (0 -> 1) only; index 0 receives nothing
        d = r // 2
        want = _col(world, r - 2, "x") if d == 1 else np.zeros_like(x)
        assert np.array_equal(_col(world, r, "ppermute/shift"), want)
        gwant = _w(r + 2, x.shape) if d == 0 else np.zeros_like(x)
        assert np.array_equal(_col(world, r, "ppermute/shift/grad"), gwant)


def test_compressed_psum_formula_bit_exact(world):
    gs = [world["ranks"][r]["compressed"]["g"] for r in range(4)]
    top = np.float32(max(np.abs(g).max() for g in gs))
    scale = np.maximum(top / np.float32(127.0), np.float32(1e-30))
    total = sum(np.round(g / scale).astype(np.int32) for g in gs)
    want = (total.astype(np.float32) * scale) / np.float32(4)
    for r in range(4):
        out = world["ranks"][r]["compressed"]["out"]
        assert out.dtype == np.float32
        assert np.array_equal(out, want)


def test_compressed_psum_close_to_exact(world):
    gs = [world["ranks"][r]["compressed"]["g"] for r in range(4)]
    exact = sum(g.astype(np.float64) for g in gs)
    a = world["ranks"][0]["compressed"]["out"] * 4.0      # sum, not mean
    rel = np.linalg.norm(a - exact) / np.linalg.norm(exact)
    assert rel < 0.01, rel


# ---------------------------------------------------------------------------
# the MoE dispatcher against JAX's
# ---------------------------------------------------------------------------

MOE_NAMES = [f"{m}-{c}" for m in sorted(MOE_CASES)
             for c in sorted(CAPACITY) + ["w8"]]
# JAX's tp mode keeps a W8 scale (E, 1, F) whole while its codes' F is
# split over model, so its dequantize fails on the shapes; the port's
# tp-w8 is held against its own moe_dense instead
JAX_MOE_NAMES = [n for n in MOE_NAMES if n != "tp-w8"]


def _dp_rows(name, r):
    mesh, _, _, xshape = MOE_CASES[name.split("-")[0]]
    dp, ep = MESH_SHAPES[mesh]
    d = r // ep
    B = xshape[0] // dp
    return slice(d * B, (d + 1) * B)


@pytest.mark.parametrize("name", JAX_MOE_NAMES)
def test_moe_y_matches_jax(world, name):
    ref = world["jax"][name + "/y"]
    for r in range(4):
        y = world["ranks"][r]["moe"][name]["y"]
        np.testing.assert_allclose(y, ref[_dp_rows(name, r)], rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("name", JAX_MOE_NAMES)
def test_moe_aux_matches_jax(world, name):
    for r in range(4):
        assert abs(world["ranks"][r]["moe"][name]["aux"]
                   - float(world["jax"][name + "/aux"])) < 1e-6


@pytest.mark.parametrize("name", JAX_MOE_NAMES)
def test_moe_drops_match_jax(world, name):
    total = 0
    for r in range(4):
        got = world["ranks"][r]["moe"][name]["dropped"]
        want = world["jax"][f"{name}/dropped/{r}"]
        assert np.array_equal(got, want)
        total += int(want.sum())
    # capacity factor 8 keeps every assignment; 0.5 drops some
    assert (total > 0) == name.endswith("drop"), total


def test_moe_tp_w8_matches_dense(world):
    """tp mode with W8 experts against the port's moe_dense on the same
    tokens (dp = 1 on (1, 4): the same capacity, no drops at factor 8)."""
    from repro_torch.layers.moe import MoeConfig, moe_dense
    case = next(c for c in _moe_inputs() if c["name"] == "tp-w8")
    params = {k: ({kk: torch.tensor(vv) for kk, vv in v.items()}
                  if isinstance(v, dict) else torch.tensor(v))
              for k, v in case["params"].items()}
    y, aux = moe_dense(params, torch.tensor(case["x"]),
                       MoeConfig(**case["cfg"]))
    for r in range(4):
        m = world["ranks"][r]["moe"]["tp-w8"]
        np.testing.assert_allclose(m["y"], y.numpy(), rtol=0, atol=1e-5)
        assert abs(m["aux"] - float(aux)) < 1e-6
        assert not m["dropped"].any()


@pytest.mark.parametrize("name", MOE_NAMES)
def test_moe_grads_flow(world, name):
    for r in range(4):
        m = world["ranks"][r]["moe"][name]
        assert m["grads_finite"]
        assert all(n > 0 for n in m["grad_norms"]), m["grad_norms"]


# ---------------------------------------------------------------------------
# elastic reshard and the cross-mesh checkpoint
# ---------------------------------------------------------------------------

def test_reshard_from_full_equals_blocks(world):
    assert all(world["ranks"][r]["elastic"]["reshard_full_equal"]
               for r in range(4))


def test_restore_onto_survivor_mesh_bit_equal(world):
    for r in (0, 1):
        e = world["ranks"][r]["elastic"]
        assert e["step"] == 3 and e["restored_equal"]


def test_live_reshard_onto_survivor_mesh_bit_equal(world):
    for r in (0, 1):
        assert world["ranks"][r]["elastic"]["live_equal"]
        assert world["ranks"][r]["elastic"]["other_dtypes_equal"]
    for r in (2, 3):
        assert world["ranks"][r]["elastic"]["live_none"]


def test_sharded_save_files_equal_single_device_save(world):
    a = os.path.join(world["out"], "ckpt_sharded", "step_00000003")
    b = os.path.join(world["out"], "ckpt_single", "step_00000003")
    names = sorted(os.listdir(b))
    assert sorted(os.listdir(a)) == names and "MANIFEST.json" in names
    for n in names:
        with open(os.path.join(a, n), "rb") as fa, \
                open(os.path.join(b, n), "rb") as fb:
            assert fa.read() == fb.read(), n


def test_smoke_specs_on_2x2_match_jax(world):
    """The specs the world sharded by are JAX's for the same tree."""
    model = jbuild(jsmoke(JARCHS["granite-3-2b"]))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    want = _jax_specs(JLM_RULES, shapes, _StubMesh((2, 2), ("data", "model")))
    assert world["ranks"][0]["elastic"]["specs1"] == want
