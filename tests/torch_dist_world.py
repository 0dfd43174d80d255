"""A 4-rank gloo world on the CPU for the PyTorch port's distributed
tests (``tests/test_torch_distributed*.py``).

    PYTHONPATH=src python tests/torch_dist_world.py SUITE OUT_DIR

starts 4 processes (``torch.multiprocessing``, spawn) that meet through
a ``file://`` store in OUT_DIR; each runs SUITE (``dist``, ``train`` or
``tp``)
and writes its results to ``OUT_DIR/SUITE_rank<r>.pt``.  Inputs that the
tests share with JAX are read from ``OUT_DIR/inputs.pt``.  Every
collective times out after ``TIMEOUT_S`` seconds, so a hung rank fails
the run instead of stalling it.
"""
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT_S = 120


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else t


# ---------------------------------------------------------------------------
# suite "dist": collectives, compressed_psum, moe_shard_map, elastic
# ---------------------------------------------------------------------------

def _collectives(rank, mesh):
    from repro_torch.distributed import collectives as C

    x = torch.tensor(np.random.default_rng(rank).standard_normal((4, 6)),
                     dtype=torch.float32)
    res = {"x": _np(x)}

    def record(name, fn):
        xg = x.clone().requires_grad_()
        y = fn(xg)
        w = torch.tensor(np.random.default_rng(100 + rank).standard_normal(
            tuple(y.shape)), dtype=torch.float32)
        (g,) = torch.autograd.grad((y * w).sum(), xg)
        res[name] = _np(y)
        res[name + "/grad"] = _np(g)

    for axes in ("data", "model", ("data", "model")):
        key = "+".join((axes,) if isinstance(axes, str) else axes)
        res[f"axis_index/{key}"] = C.axis_index(axes, mesh)
        res[f"axis_size/{key}"] = C.axis_size(axes, mesh)
        record(f"psum/{key}", lambda v: C.psum(v, axes, mesh))
        record(f"pmean/{key}", lambda v: C.pmean(v, axes, mesh))
        record(f"pmax/{key}", lambda v: C.pmax(v, axes, mesh))
        for ax in (0, 1):
            record(f"all_gather/{key}/{ax}",
                   lambda v: C.all_gather(v, axes, axis=ax, mesh=mesh))
    for s, c in ((0, 1), (1, 0), (0, 0)):
        record(f"all_to_all/{s}{c}",
               lambda v: C.all_to_all(v, "model", s, c, mesh=mesh))
    record("ppermute/swap",
           lambda v: C.ppermute(v, "model", [(0, 1), (1, 0)], mesh=mesh))
    record("ppermute/shift",
           lambda v: C.ppermute(v, "data", [(0, 1)], mesh=mesh))
    return res


def _compressed(rank, mesh):
    from repro_torch.optim.compression import compressed_psum

    g = torch.tensor(np.random.default_rng(200 + rank).standard_normal(
        (8, 64)), dtype=torch.float32)
    return {"g": _np(g), "out": _np(compressed_psum(g, "pod", mesh))}


def _moe(rank, meshes, inputs):
    """Each case through the dispatcher ``moe`` under its mesh's
    context: the float cases with each expert weight as the rank's block
    under ``MOE_RULES`` (as the sharded train step passes them), the W8
    cases whole."""
    from repro_torch.common.tree import match_first
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.ctx import use_sharding
    from repro_torch.distributed.partition import (
        local_block, make_ctx, resolve_param_spec)
    from repro_torch.layers import moe as M

    res = {}
    for case in inputs["moe"]:
        ctx = make_ctx(meshes[case["mesh"]])
        cfg = M.MoeConfig(**case["cfg"])
        params = {k: (torch.tensor(v) if not isinstance(v, dict) else
                      {kk: torch.tensor(vv) for kk, vv in v.items()})
                  for k, v in case["params"].items()}
        for n in ("w_in", "w_gate", "w_out"):
            if torch.is_tensor(params[n]):
                spec = resolve_param_spec(
                    ctx, match_first(M.MOE_RULES, n), params[n].shape)
                params[n] = local_block(params[n], spec, ctx.mesh).clone()
        x_all = torch.tensor(case["x"])
        dp = C.axis_size("data", ctx.mesh)
        i = C.axis_index("data", ctx.mesh)
        B = x_all.shape[0] // dp
        x = x_all[i * B:(i + 1) * B]
        leaves = [params["router"]["w"]] + [
            w["scale"] if isinstance(w, dict) else w
            for w in (params["w_in"], params["w_out"])]
        for t in leaves:
            t.requires_grad_()
        with use_sharding(ctx):
            y, aux = M.moe(params, x, cfg)
        grads = torch.autograd.grad((y.float() ** 2).sum() + aux, leaves)
        # the assignments this rank's mode routes and drops
        ep = C.axis_size("model", ctx.mesh)
        E, S = cfg.n_experts, x.shape[1]
        if ep > 1 and (E % ep == 0 or ep % E == 0):
            if E % ep == 0 and S % ep == 0 and S > 1:           # a2a
                j = C.axis_index("model", ctx.mesh)
                x = x[:, j * S // ep:(j + 1) * S // ep]
            rows, xt = slice(None), x.reshape(1, -1, x.shape[-1])
        else:        # the global batch's order and capacity: our rows
            T = x.shape[0] * S
            rows = slice(i * T, (i + 1) * T)
            xt = x_all.reshape(1, -1, x.shape[-1])
        xt = xt.detach()
        _, idx, _ = M._route(xt, params["router"]["w"].detach(), cfg)
        _, valid = M._slot_assign(idx, E, M._capacity(cfg, xt.shape[1]))
        res[case["name"]] = {
            "y": _np(y), "aux": float(aux), "dropped": _np(~valid[0][rows]),
            "grad_norms": [float(torch.linalg.norm(g)) for g in grads],
            "grads_finite": all(bool(torch.isfinite(g).all())
                                for g in grads)}
    return res


def _elastic(rank, out):
    from repro_torch.checkpoint.checkpoint import barrier, restore, save
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import smoke_variant
    from repro_torch.common.tree import flatten_with_paths, tree_map
    from repro_torch.distributed.partition import (
        make_ctx, match_partition_rules, named_shardings, shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.registry import build_model
    from repro_torch.runtime.elastic import reshard_tree

    model = build_model(smoke_variant(get_arch("granite-3-2b")))
    params = model.init(0, "cpu")
    mesh1 = make_mesh((2, 2), ("data", "model"), device="cpu")
    ctx1 = make_ctx(mesh1)
    specs1 = match_partition_rules(LM_RULES, params, ctx1)
    named1 = named_shardings(specs1, mesh1)
    blocks1 = reshard_tree(params, LM_RULES, ctx1)
    res = {"specs1": {p: str(s) for p, s in flatten_with_paths(specs1)},
           "reshard_full_equal": _equal(blocks1,
                                        shard_tree(params, specs1, mesh1))}
    save(os.path.join(out, "ckpt_sharded"), 3, blocks1, shardings=named1)
    if rank == 0:
        save(os.path.join(out, "ckpt_single"), 3, params)
    barrier(mesh1)
    # lose ranks 2 and 3: a (1, 2) mesh over the survivors
    mesh2 = make_mesh((1, 2), ("data", "model"), ranks=[0, 1], device="cpu")
    live = reshard_tree(blocks1, LM_RULES, make_ctx(mesh2), old=named1)
    if rank < 2:
        ctx2 = make_ctx(mesh2)
        specs2 = match_partition_rules(LM_RULES, params, ctx2)
        want = shard_tree(params, specs2, mesh2)
        meta = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device="meta"), params)
        restored, step, _ = restore(os.path.join(out, "ckpt_sharded"), meta,
                                    shardings=named_shardings(specs2, mesh2),
                                    device="cpu")
        res.update(step=step, restored_equal=_equal(restored, want),
                   live_equal=_equal(live, want),
                   shapes2=[tuple(t.shape) for _, t in
                            flatten_with_paths(restored)])
    else:
        res["live_none"] = all(t is None for _, t in
                               flatten_with_paths(live))
    # other dtypes travel as bytes: bf16 blocks and a 0-dim int32 leaf
    other = {"w": params["lm_head"]["w"].to(torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32)}
    rules = [(r"^w$", ("fsdp", "tp"))]
    specs_o = match_partition_rules(rules, other, ctx1)
    blocks_o = reshard_tree(other, rules, ctx1)
    moved = reshard_tree(blocks_o, rules, make_ctx(mesh2),
                         old=named_shardings(specs_o, mesh1))
    if rank < 2:
        want_o = shard_tree(other, match_partition_rules(
            rules, other, make_ctx(mesh2)), mesh2)
        res["other_dtypes_equal"] = _equal(moved, want_o)
    return res


def _equal(a, b) -> bool:
    from repro_torch.common.tree import tree_leaves

    return all(x.shape == y.shape and x.dtype == y.dtype
               and torch.equal(x, y)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def suite_dist(rank, out):
    from repro_torch.launch.mesh import make_mesh

    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    meshes = {name: make_mesh(shape, ("data", "model"), device="cpu")
              for name, shape in (("2x2", (2, 2)), ("1x4", (1, 4)),
                                  ("4x1", (4, 1)))}
    pod = make_mesh((4,), ("pod",), device="cpu")
    return {"collectives": _collectives(rank, meshes["2x2"]),
            "compressed": _compressed(rank, pod),
            "moe": _moe(rank, meshes, inputs),
            "elastic": _elastic(rank, out)}


# ---------------------------------------------------------------------------
# suite "train": the sharded step, the sharded Trainer, the pipeline
# ---------------------------------------------------------------------------

# arch[@mesh]: (2, 2) unless named; grok-1's 4 experts take
# ``moe_shard_map``'s a2a on (2, 2) and ``_moe_global`` on (4, 1)
TRAIN_CASES = ("granite-3-2b", "zamba2-1.2b", "grok-1-314b",
               "grok-1-314b@4x1")
TRAIN_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}


def train_arch(name):
    """The smoke config; an MoE's capacity holds every token (C >= T at
    any token count, so no path drops one)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import smoke_variant

    cfg = smoke_variant(get_arch(name))
    if cfg.n_experts:
        cfg = cfg.scaled(capacity_factor=cfg.n_experts / cfg.top_k)
    return cfg


def _train_steps(rank):
    from repro_torch.common.tree import (
        flatten_with_paths, global_norm, tree_map)
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.partition import (
        gather_tree, local_block, make_ctx, match_partition_rules,
        shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        default_opt_cfg, make_train_step, sharded_value_and_grad,
        value_and_grad)
    from repro_torch.layers.moe import EXPERT_LEAF
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init, adamw_update

    def diffs(a_tree, b_tree):
        """{path: (max|a - b|, max|a|, same shape)}"""
        return {p: (float((a - b).abs().max()), float(a.abs().max()),
                    a.shape == b.shape)
                for (p, a), (_, b) in zip(flatten_with_paths(a_tree),
                                          flatten_with_paths(b_tree))}

    res = {}
    for case in TRAIN_CASES:
        name, _, mesh_name = case.partition("@")
        mesh = make_mesh(TRAIN_MESHES[mesh_name or "2x2"],
                         ("data", "model"), device="cpu")
        ctx = make_ctx(mesh)
        cfg = train_arch(name)
        model = build_model(cfg)
        opt_cfg = default_opt_cfg(cfg)
        params = model.init(0, "cpu")
        opt = adamw_init(params, opt_cfg)
        rng = np.random.default_rng(7)
        batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (8, 32))),
                 "targets": torch.tensor(rng.integers(0, cfg.vocab,
                                                      (8, 32)))}
        if name == "granite-3-2b":     # uneven token counts per dp shard
            mask = (rng.random((8, 32)) < np.linspace(0.2, 0.9, 8)[:, None])
            batch["mask"] = torch.tensor(mask.astype(np.float32))
        l1, g1 = value_and_grad(model.loss)(params, batch)
        specs = match_partition_rules(LM_RULES, params, ctx)
        opt_specs = {"step": P(), "m": specs, "v": specs}
        if "master" in opt:
            opt_specs["master"] = specs
        local = tree_map(lambda x, s: s.shard(x), batch,
                         make_batch_specs(batch, ctx, "dp"))
        blocks = shard_tree(params, specs, mesh)
        oblocks = shard_tree(opt, opt_specs, mesh)
        _, g2, gnorm2 = sharded_value_and_grad(model, ctx, specs)(blocks,
                                                                  local)
        step = make_train_step(model, opt_cfg, ctx=ctx, specs=specs)
        p2, _, l2 = step(blocks, oblocks, local)
        # AdamW on the full tree with the gathered gradient and its norm
        p_ref, _ = adamw_update(gather_tree(g2, specs, mesh), opt, params,
                                opt_cfg, gnorm=gnorm2)
        res[case] = {
            "loss": (float(l1), float(l2)),
            "grads": diffs(tree_map(lambda g, s: local_block(g, s, mesh),
                                    g1, specs), g2),
            "gnorm": (float(global_norm(g1)), float(gnorm2)),
            "params": diffs(p_ref, gather_tree(p2, specs, mesh)),
            "expert_blocks": [
                (tuple(b.shape), tuple(g.shape)) for (p, b), (_, g) in zip(
                    flatten_with_paths(blocks), flatten_with_paths(g2))
                if EXPERT_LEAF.search(p)],
            "sharded_leaves": sum(
                1 for (_, a), (_, b) in zip(flatten_with_paths(p2),
                                            flatten_with_paths(params))
                if a.numel() < b.numel()),
            "local_batch": tuple(local["tokens"].shape)}
    return res


def _trainer(rank, mesh, out):
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim.schedule import ScheduleConfig
    from repro_torch.runtime.trainer import (
        Trainer, TrainerConfig, make_failure_hook)

    cfg = train_arch("granite-3-2b")
    data = DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0)
    tcfg = TrainerConfig(total_steps=8, ckpt_every=4,
                         ckpt_dir=os.path.join(out, "trainer_ckpt"),
                         log_every=100, schedule=ScheduleConfig(
                             warmup_steps=2, total_steps=8))
    tr = Trainer(cfg, data, tcfg, device="cpu", mesh=mesh,
                 failure_hook=make_failure_hook([6]))
    out_ = tr.run()
    return {"losses": list(out_["losses"]),
            "mesh": tuple(tr.mesh.shape),
            "final_shapes": {k: tuple(v.shape) for k, v in
                             out_["params"]["embed"].items()}}


def _pipeline(rank, mesh):
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.pipeline import pipelined_apply, split_stages

    def stage_fn(ws, h):
        for w in ws:
            h = torch.tanh(h @ w)
        return h

    res = {}
    for name, (L, D, M, mb, S, dp) in {"alone": (4, 16, 4, 2, 8, False),
                                       "dp": (2, 8, 2, 8, 4, True)}.items():
        rng = np.random.default_rng(0)
        Ws = torch.tensor(rng.standard_normal((L, D, D)) * 0.3,
                          dtype=torch.float32)
        x = torch.tensor(rng.standard_normal((M, mb, S, D)),
                         dtype=torch.float32)
        sid = C.axis_index("pod", mesh)
        stage = split_stages(Ws, 2)[sid:sid + 1].clone().requires_grad_()
        if dp:
            n, i = C.axis_size("data", mesh), C.axis_index("data", mesh)
            x = x[:, i * mb // n:(i + 1) * mb // n]
        y = pipelined_apply(stage_fn, stage, x, mesh=mesh, pipe_axis="pod")
        (g,) = torch.autograd.grad((y ** 2).sum(), stage)
        if dp:
            g = C.psum(g, "data", mesh)
        g_all = C.all_gather(g, "pod", axis=0, mesh=mesh).reshape(L, D, D)
        res[name] = {"y": _np(y), "grad": _np(g_all),
                     "x_slice": tuple(x.shape)}
    return res


def _grad_accum(rank, mesh):
    """granite-3-2b's sharded step with ``grad_accum=2`` on (2, 2), the
    batch the rank's rows of each global microbatch
    (``microbatch_shard``), a mask whose token counts differ between the
    microbatches, against the single-device ``grad_accum=2`` step on the
    global batch: the loss, the averaged gradient's blocks, its norm and
    the updated params."""
    from repro_torch.common.tree import flatten_with_paths, global_norm, \
        tree_map
    from repro_torch.data.pipeline import microbatch_shard
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.partition import (
        gather_tree, local_block, make_ctx, match_partition_rules,
        shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch.steps import (
        default_opt_cfg, make_train_step, sharded_value_and_grad,
        value_and_grad)
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init

    ctx = make_ctx(mesh)
    cfg = train_arch("granite-3-2b")
    model = build_model(cfg)
    opt_cfg = default_opt_cfg(cfg)
    params = model.init(0, "cpu")
    opt = adamw_init(params, opt_cfg)
    rng = np.random.default_rng(11)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (8, 32))),
             "targets": torch.tensor(rng.integers(0, cfg.vocab, (8, 32)))}
    mask = rng.random((8, 32)) < np.linspace(0.1, 0.95, 8)[:, None]
    batch["mask"] = torch.tensor(mask.astype(np.float32))
    counts = [float(batch["mask"][i * 4:(i + 1) * 4].sum()) for i in (0, 1)]
    p1, _, l1 = make_train_step(model, opt_cfg, grad_accum=2)(params, opt,
                                                             batch)
    vg = value_and_grad(model.loss)
    g1 = [vg(params, tree_map(lambda x: x[i * 4:(i + 1) * 4], batch))[1]
          for i in (0, 1)]
    g1 = tree_map(lambda a, b, p: ((a.float() + b.float()) / 2).to(p.dtype),
                  g1[0], g1[1], params)
    specs = match_partition_rules(LM_RULES, params, ctx)
    opt_specs = {"step": P(), "m": specs, "v": specs}
    if "master" in opt:
        opt_specs["master"] = specs
    local = microbatch_shard(batch, ctx, 2)
    blocks = shard_tree(params, specs, mesh)
    _, g2, gnorm2 = sharded_value_and_grad(model, ctx, specs, 2)(blocks,
                                                                 local)
    step = make_train_step(model, opt_cfg, grad_accum=2, ctx=ctx,
                           specs=specs)
    p2, _, l2 = step(blocks, shard_tree(opt, opt_specs, mesh), local)

    def diffs(a_tree, b_tree):
        return {p: (float((a - b).abs().max()), float(a.abs().max()),
                    a.shape == b.shape)
                for (p, a), (_, b) in zip(flatten_with_paths(a_tree),
                                          flatten_with_paths(b_tree))}

    return {"loss": (float(l1), float(l2)), "counts": counts,
            "grads": diffs(tree_map(lambda g, s: local_block(g, s, mesh),
                                    g1, specs), g2),
            "gnorm": (float(global_norm(g1)), float(gnorm2)),
            "params": diffs(p1, gather_tree(p2, specs, mesh)),
            "local_batch": tuple(local["tokens"].shape)}


# arch[@mesh]: the sharded prefill and decode cases, (2, 2) unless named
SERVE_CASES = ("granite-3-2b", "gemma3-12b", "zamba2-1.2b", "grok-1-314b",
               "grok-1-314b@4x1")
SERVE_PROMPT = 30          # tokens a row; gemma3's ring (32) wraps at 32
SERVE_STEPS = 4
SERVE_MAX_LEN = 36


def serve_arch(case):
    """The smoke config with fp32 caches; relu_linear for zamba2; grok on
    (4, 1) at capacity factor 0.5, where the prefill drops tokens (its
    path, ``_moe_global``, is the global batch's ``moe_dense``); on (2,
    2) the capacity holds every token (``a2a`` routes each rank's slice
    against its own capacity, as JAX's does)."""
    name, _, mesh_name = case.partition("@")
    cfg = train_arch(name).scaled(kv_dtype="float32")
    if name == "zamba2-1.2b":
        cfg = cfg.scaled(attn_backend="relu_linear")
    if mesh_name == "4x1":
        cfg = cfg.scaled(capacity_factor=0.5)
    return cfg


def _pad_to(tree, template):
    """Zero-pad every leaf of ``tree`` up to ``template``'s shape."""
    from repro_torch.common.tree import tree_map

    def pad(a, t):
        out = a.new_zeros(t.shape)
        region = out
        for i, n in enumerate(a.shape):
            region = region.narrow(i, 0, n)
        region.copy_(a)
        return out

    return tree_map(pad, tree, template)


def _serve_one(model, params, mesh, tokens, steps, max_len):
    """The sharded prefill (``make_prefill_step(ctx=)``) and the decode
    steps ``steps`` (``make_serve_step(ctx=)``) against the
    single-device ones on the global batch, both decoding the same
    tokens from the prefill's caches zero-padded to ``max_len``: each
    rank's logits block and cache blocks against the single-device
    ones' blocks (``err``: max|d|, max|ref|, the block's shape)."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.partition import (
        local_block, make_ctx, match_partition_rules, shard_tree)
    from repro_torch.distributed.rules import CACHE_RULES, LM_RULES
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    ctx = make_ctx(mesh)
    cfg = model.cfg
    B = tokens.shape[0]
    logits1, caches1 = model.prefill(params, {"tokens": tokens})
    padded = _pad_to(caches1, model.init_caches(B, max_len, "cpu"))
    specs = match_partition_rules(LM_RULES, params, ctx)
    c_specs = match_partition_rules(CACHE_RULES, caches1, ctx)
    d_specs = match_partition_rules(CACHE_RULES, padded, ctx)
    blocks = shard_tree(params, specs, mesh)
    dp = C.axis_size("data", mesh)
    rows = slice(C.axis_index("data", mesh) * B // dp,
                 (C.axis_index("data", mesh) + 1) * B // dp)
    logits2, caches2 = make_prefill_step(
        model, ctx=ctx, specs=specs, cache_specs=c_specs)(
        blocks, {"tokens": tokens[rows]})
    vocab = logits2.shape[1]
    v0 = C.axis_index("model", mesh) * vocab if vocab < cfg.vocab else 0

    def err(want, got):
        return (float((want - got).abs().max()),
                float(want.abs().max()), tuple(got.shape))

    entry = {"prefill": err(logits1[rows, v0:v0 + vocab], logits2),
             "prefill_caches": {
                 p: err(local_block(a, s, mesh), b)
                 for (p, a), (_, s), (_, b) in zip(
                     flatten_with_paths(caches1),
                     flatten_with_paths(c_specs),
                     flatten_with_paths(caches2))},
             "decode": [], "decode_caches": {}}
    serve = make_serve_step(model, ctx=ctx, specs=specs,
                            cache_specs=d_specs)
    c1, c2 = padded, shard_tree(padded, d_specs, mesh)
    for t in range(steps.shape[0]):
        pos = tokens.shape[1] + t
        l1, c1 = model.decode(params, c1, steps[t], pos)
        l2, c2 = serve(blocks, c2, steps[t][rows], pos)
        entry["decode"].append(err(l1[rows, v0:v0 + vocab], l2))
    entry["decode_caches"] = {
        p: err(local_block(a, s, mesh), b)
        for (p, a), (_, s), (_, b) in zip(
            flatten_with_paths(c1), flatten_with_paths(d_specs),
            flatten_with_paths(c2))}
    entry["split"] = {p: str(s) for p, s in flatten_with_paths(d_specs)}
    return entry


def _serve(rank):
    """Every ``SERVE_CASES`` case through ``_serve_one`` on a global
    batch of 4 rows, ``SERVE_STEPS`` decode steps; the prefill's MoE
    drops counted."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.layers import moe as M
    from repro_torch.models.registry import build_model

    res = {}
    for case in SERVE_CASES:
        _, _, mesh_name = case.partition("@")
        mesh = make_mesh(TRAIN_MESHES[mesh_name or "2x2"], ("data", "model"),
                         device="cpu")
        cfg = serve_arch(case)
        model = build_model(cfg)
        params = model.init(0, "cpu")
        rng = np.random.default_rng(5)
        B = 4
        tokens = torch.tensor(rng.integers(0, cfg.vocab, (B, SERVE_PROMPT)))
        steps = torch.tensor(rng.integers(0, cfg.vocab,
                                          (SERVE_STEPS, B, 1)))
        dropped = []
        slot_assign = M._slot_assign

        def counting(idx, n, c):
            out = slot_assign(idx, n, c)
            dropped.append(int((~out[1]).sum()))
            return out

        M._slot_assign = counting
        try:
            model.prefill(params, {"tokens": tokens})
        finally:
            M._slot_assign = slot_assign
        entry = _serve_one(model, params, mesh, tokens, steps,
                           SERVE_MAX_LEN)
        entry["dropped"] = sum(dropped)
        res[case] = entry
    return res


def suite_train(rank, out):
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    pipe = make_mesh((2, 2), ("pod", "data"), device="cpu")
    return {"steps": _train_steps(rank),
            "trainer": _trainer(rank, mesh, out),
            "pipeline": _pipeline(rank, pipe),
            "accum": _grad_accum(rank, mesh),
            "serve": _serve(rank)}


# ---------------------------------------------------------------------------
# suite "tp": the dense layers split over ``model`` (tensor parallelism)
# ---------------------------------------------------------------------------

TP_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
TP_SERVE_PROMPT = 28     # tokens a row; the decode's caches hold 32
TP_SERVE_STEPS = 4


def _seen(model, record):
    """``model`` with its loss, prefill and decode recording, when they
    run under a ``ShardingCtx`` (the sharded steps), the shape of every
    param leaf they are handed (``record``: {call: {path: shape}})."""
    import dataclasses

    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.distributed.ctx import current_ctx

    def wrap(name, fn):
        def run(params, *a, **k):
            if current_ctx() is not None:
                record[name] = {p: tuple(x.shape)
                                for p, x in flatten_with_paths(params)}
            return fn(params, *a, **k)
        return run

    return dataclasses.replace(
        model, loss_terms=wrap("train", model.loss_terms),
        prefill=wrap("prefill", model.prefill),
        decode=wrap("decode", model.decode))


def _model_gathered(params, specs, mesh, seen):
    """The dense leaves a step was handed (``seen``: {path: shape}) that
    are not their ``model`` block (gathered over ``model``), and how
    many leaves ``model`` splits."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.partition import local_block
    from repro_torch.layers.moe import EXPERT_LEAF

    over, split = [], 0
    for (p, x), (_, s) in zip(flatten_with_paths(params),
                              flatten_with_paths(specs)):
        if EXPERT_LEAF.search(p):
            continue
        model_only = P(*(("model" if "model" in s.axes(d) else None)
                         for d in range(len(s))))
        want = tuple(local_block(x, model_only, mesh).shape)
        split += want != tuple(x.shape)
        if seen[p] != want:
            over.append((p, seen[p], want))
    return over, split


def _tp_case(rank, case):
    """One ``tp`` case on its mesh: the sharded step's loss, gradient
    blocks, norm and updated params against the single-device step's,
    the leaves the layers were handed against their ``model`` blocks,
    and the sharded prefill / decode against the single-device ones."""
    from repro_torch.common.tree import flatten_with_paths, global_norm, \
        tree_map
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import smoke_variant
    from repro_torch.convert import params_from_jax
    from repro_torch.data.pipeline import make_batch_specs
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.partition import (
        gather_tree, local_block, make_ctx, match_partition_rules,
        shard_tree)
    from repro_torch.distributed.rules import LM_RULES
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (
        default_opt_cfg, make_train_step, sharded_value_and_grad,
        value_and_grad)
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_init, adamw_update

    mesh = make_mesh(TP_MESHES[case["mesh"]], ("data", "model"),
                     device="cpu")
    ctx = make_ctx(mesh)
    # fp32 caches: the serve gates compare them at fp32 rounding
    cfg = smoke_variant(get_arch(case["arch"])).scaled(
        kv_dtype="float32", **case["kw"])
    params = params_from_jax(case["params"], "cpu")
    if case["w8"]:
        from repro_torch.core.quantization import quantize_lm_params
        params = quantize_lm_params(params)
    seen: dict = {}
    model = _seen(build_model(cfg), seen)
    specs = match_partition_rules(LM_RULES, params, ctx)
    res = {}

    def diffs(a_tree, b_tree):
        return {p: (float((a - b).abs().max()), float(a.abs().max()),
                    a.shape == b.shape)
                for (p, a), (_, b) in zip(flatten_with_paths(a_tree),
                                          flatten_with_paths(b_tree))}

    if not case["w8"]:
        batch = {k: torch.tensor(v) for k, v in case["batch"].items()}
        opt_cfg = default_opt_cfg(cfg)
        opt = adamw_init(params, opt_cfg)
        l1, g1 = value_and_grad(model.loss)(params, batch)
        opt_specs = {"step": P(), "m": specs, "v": specs}
        if "master" in opt:
            opt_specs["master"] = specs
        local = tree_map(lambda x, s: s.shard(x), batch,
                         make_batch_specs(batch, ctx, "dp"))
        blocks = shard_tree(params, specs, mesh)
        _, g2, gnorm2 = sharded_value_and_grad(model, ctx, specs)(blocks,
                                                                  local)
        step = make_train_step(model, opt_cfg, ctx=ctx, specs=specs)
        p2, _, l2 = step(blocks, shard_tree(opt, opt_specs, mesh), local)
        p_ref, _ = adamw_update(gather_tree(g2, specs, mesh), opt, params,
                                opt_cfg, gnorm=gnorm2)
        res.update({
            "loss": (float(l1), float(l2)),
            "grads": diffs(tree_map(lambda g, s: local_block(g, s, mesh),
                                    g1, specs), g2),
            "gnorm": (float(global_norm(g1)), float(gnorm2)),
            "params": diffs(p_ref, gather_tree(p2, specs, mesh))})
    if case["serve"]:
        rng = np.random.default_rng(9)
        B = 4
        tokens = torch.tensor(rng.integers(0, cfg.vocab,
                                           (B, TP_SERVE_PROMPT)))
        steps = torch.tensor(rng.integers(0, cfg.vocab,
                                          (TP_SERVE_STEPS, B, 1)))
        if cfg.family == "encdec":
            frames = torch.tensor(rng.standard_normal(
                (B, 16, cfg.d_model)).astype(np.float32))
            res["serve"] = _serve_encdec(model, params, mesh, frames,
                                         tokens, steps)
        else:
            res["serve"] = _serve_one(model, params, mesh, tokens, steps,
                                      TP_SERVE_PROMPT + TP_SERVE_STEPS)
    res["over"], res["split"] = {}, {}
    for call, shapes in seen.items():
        res["over"][call], res["split"][call] = _model_gathered(
            params, specs, mesh, shapes)
    return res


def _serve_encdec(model, params, mesh, frames, tokens, steps):
    """The enc-dec's sharded prefill (its state) and decode steps
    against the single-device ones, as ``_serve_one``'s; both decodes
    start from the sharded prefill's state (gathered for the single
    device)."""
    from repro_torch.common.tree import flatten_with_paths
    from repro_torch.distributed import collectives as C
    from repro_torch.distributed.partition import (
        gather_tree, local_block, make_ctx, match_partition_rules,
        shard_tree)
    from repro_torch.distributed.rules import CACHE_RULES, LM_RULES
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    ctx = make_ctx(mesh)
    B, S = tokens.shape[0], steps.shape[0]
    batch = {"frames": frames, "tokens": tokens[:, :S]}
    state1 = model.prefill(params, batch)
    specs = match_partition_rules(LM_RULES, params, ctx)
    s_specs = match_partition_rules(CACHE_RULES, state1, ctx)
    blocks = shard_tree(params, specs, mesh)
    dp = C.axis_size("data", mesh)
    i = C.axis_index("data", mesh)
    rows = slice(i * B // dp, (i + 1) * B // dp)
    state2 = make_prefill_step(model, ctx=ctx, specs=specs,
                               cache_specs=s_specs)(
        blocks, {k: v[rows] for k, v in batch.items()})

    def err(want, got):
        return (float((want.float() - got.float()).abs().max()),
                float(want.float().abs().max()), tuple(got.shape),
                str(got.dtype))

    def tree_err(a_tree, b_tree):
        return {p: err(local_block(a, s, mesh), b)
                for (p, a), (_, s), (_, b) in zip(
                    flatten_with_paths(a_tree), flatten_with_paths(s_specs),
                    flatten_with_paths(b_tree))}

    entry = {"prefill_caches": tree_err(state1, state2), "decode": []}
    # the decode from the sharded prefill's state on both sides: its
    # bf16 K/V can sit a rounding away from the single-device prefill's
    state1 = gather_tree(state2, s_specs, mesh)
    serve = make_serve_step(model, ctx=ctx, specs=specs,
                            cache_specs=s_specs)
    vocab = model.cfg.vocab
    for t in range(S):
        l1, state1 = model.decode(params, state1, steps[t], t)
        l2, state2 = serve(blocks, state2, steps[t][rows], t)
        v = l2.shape[1]
        v0 = C.axis_index("model", mesh) * v if v < vocab else 0
        entry["decode"].append(err(l1[rows, v0:v0 + v], l2))
    entry["decode_caches"] = tree_err(state1, state2)
    return entry


def suite_tp(rank, out):
    inputs = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    return {f"{c['name']}@{c['mesh']}": _tp_case(rank, c)
            for c in inputs["tp"]}


SUITES = {"dist": suite_dist, "train": suite_train, "tp": suite_tp}


def _rank_main(rank, suite, out):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(out, 'store')}",
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        res = SUITES[suite](rank, out)
        torch.save(res, os.path.join(out, f"{suite}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    suite_name, out_dir = sys.argv[1:3]
    mp.start_processes(_rank_main, args=(suite_name, out_dir), nprocs=WORLD,
                       start_method="spawn", join=True)
