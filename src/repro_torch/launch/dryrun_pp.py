"""Pipeline-parallel multi-pod dry-run (PP over the pod axis),
counterpart of ``repro/launch/dryrun_pp.py``.

The alternative to the default DP-over-pods layout: each pod owns HALF
the layers (pipeline stages), and microbatch activations cross the
inter-pod links instead of a full gradient all-reduce.  As JAX's, the
pipeline is fully manual with data parallelism inside each stage: the
stage weights are split over ``pod`` (their stage dim) and replicated
inside the pod; embed / head follow ``LM_RULES``.

The step is built from the port's ``distributed/pipeline.py``
(``split_stages``, ``pipelined_apply``: M + P - 1 ticks of
``ppermute``) and counted on the meta device under a fake process group
of 512 ranks, as ``launch/dryrun.py`` counts its cells.  Only the last
stage's loss enters the objective (``torch.where`` on a mask: every
stage runs the same collectives); the stage gradients are summed over
``data``, the others over ``pod`` and ``data``, then AdamW updates the
rank's blocks.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pp \\
        --arch granite-3-2b [--micro 8]

Writes ``artifacts/dryrun_torch/<arch>__train_4k__multi_pp2.json`` and
prints the pod-crossing bytes beside the DP-over-pods cell's (that
cell is run here too, its record written beside).  The
numbers are computed for a 512-H100 mesh, not measured.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.common.tree import map_with_path, tree_leaves, tree_map
from repro_torch.configs import SHAPES, get_arch
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.ctx import P, use_sharding
from repro_torch.distributed.partition import (
    gather_leaf, local_block, make_ctx, match_partition_rules, replication,
    shard_tree)
from repro_torch.distributed.pipeline import pipelined_apply, split_stages
from repro_torch.distributed.rules import LM_RULES
from repro_torch.launch.analysis import HBM_BYTES, RooflineTerms
from repro_torch.launch.cost import measure_step
from repro_torch.launch.dryrun import (
    ARTIFACT_DIR, _mesh_size, active_params, fake_world, production_mesh,
    run_cell)
from repro_torch.launch.steps import value_and_grad
from repro_torch.layers.linear import embed
from repro_torch.layers.norms import rmsnorm
from repro_torch.models.lm import (
    _maybe_remat, _unstack, block_apply, chunked_ce_terms)
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["build_pp_step", "run_pp", "main"]


def build_pp_step(cfg: ArchConfig, mesh, specs, n_micro: int):
    """-> train_step(params, opt_state, batch) on the rank's blocks:
    ``params["stages"]`` the rank's stage (leading dim 1), the rest
    blocks of ``specs``; ``batch`` the rank's ``data`` rows."""
    n_stages = collectives.axis_size("pod", mesh)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers do not split into "
                         f"{n_stages} stages")
    opt_cfg = AdamWConfig()
    stage_leaf = map_with_path(lambda p, _: p.startswith("stages"), specs)
    reps = tree_map(lambda s: replication(s, mesh), specs)
    every = tuple(mesh.mesh_dim_names)
    block = _maybe_remat(block_apply, cfg)

    def stage_fn(stage_blocks, h):
        positions = torch.arange(h.shape[1], dtype=torch.int32,
                                 device=h.device)
        for p in _unstack(stage_blocks):
            h = block(p, h, cfg, "attn_mlp", positions)[0]
        return h

    def loss_fn(params, batch):
        tokens, targets = batch["tokens"], batch["targets"]
        B, S = tokens.shape
        x = embed(params["embed"], tokens, cfg.cdtype)
        xm = x.reshape(n_micro, B // n_micro, S, cfg.d_model)
        hm = pipelined_apply(stage_fn, params["stages"], xm, mesh=mesh,
                             pipe_axis="pod")
        h = rmsnorm(params["final_norm"], hm.reshape(B, S, cfg.d_model),
                    cfg.norm_eps)
        tot, cnt = chunked_ce_terms(params, h, targets, cfg)
        total = torch.clamp(collectives.psum(cnt.detach(), "data", mesh),
                            min=1.0)
        last = torch.tensor(collectives.axis_index("pod", mesh)
                            == n_stages - 1, device=tot.device)
        return torch.where(last, tot / total, torch.zeros_like(tot))

    vg = value_and_grad(loss_fn)

    @torch.no_grad()
    def reduce(g, s, stage):
        if stage:        # the stage's own: summed over its data ranks
            return collectives.psum(g.float(), "data", mesh).to(g.dtype)
        full = collectives.psum(g.float(), ("pod", "data"), mesh)
        return local_block(full, s, mesh).to(g.dtype)

    def train_step(params, opt_state, batch):
        full = tree_map(lambda x, s, stage: x if stage else
                        gather_leaf(x, s, mesh), params, specs, stage_leaf)
        with use_sharding(None):
            loss, grads = vg(full, batch)
        del full
        grads = tree_map(reduce, grads, specs, stage_leaf)
        sq = sum(torch.sum(torch.square(g.float())) / r
                 for g, r in zip(tree_leaves(grads), tree_leaves(reps)))
        gnorm = torch.sqrt(collectives.psum(sq, every, mesh))
        new_p, new_o = adamw_update(grads, opt_state, params, opt_cfg,
                                    gnorm=gnorm)
        return new_p, new_o, collectives.psum(loss, every, mesh).float()

    return train_step, opt_cfg


def build_pp_cell(cfg: ArchConfig, mesh, n_micro: int, shape=None):
    """-> (train_step, args, n_params): the rank's stage and blocks, its
    AdamW state and its rows of train_4k's (or ``shape``'s) global
    batch, on meta."""
    shape = shape or SHAPES["train_4k"]
    n_stages = collectives.axis_size("pod", mesh)
    params = build_model(cfg).init(0, "meta")
    pp = {"embed": params["embed"], "final_norm": params["final_norm"],
          "stages": split_stages(params["blocks"], n_stages)}
    if "lm_head" in params:
        pp["lm_head"] = params["lm_head"]
    n_params = sum(x.numel() for x in tree_leaves(pp))
    ctx = make_ctx(mesh, {"sp": ("model",), "dp": ("data",)})
    specs = match_partition_rules(LM_RULES, pp, ctx)
    specs["stages"] = tree_map(lambda s: P("pod"), specs["stages"])
    blocks = shard_tree(pp, specs, mesh)
    step, opt_cfg = build_pp_step(cfg, mesh, specs, n_micro)
    opt = adamw_init(blocks, opt_cfg)
    B, S = shape.global_batch, shape.seq_len
    rows = B // collectives.axis_size("data", mesh)
    batch = {k: torch.empty((rows, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "targets")}
    return step, (blocks, opt, batch), n_params


def run_pp(arch: str, n_micro: int = 8, *, out_dir: str = ARTIFACT_DIR,
           cfg: ArchConfig = None, mesh_shape=None, shape=None) -> dict:
    """The PP cell's record (written to ``out_dir``); ``cfg`` /
    ``mesh_shape`` / ``shape`` stand in for the arch, the (2, 16, 16)
    mesh and train_4k (tests)."""
    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES["train_4k"]
    t0 = time.time()
    n_dev = _mesh_size(True, mesh_shape)
    with fake_world(n_dev):
        mesh = production_mesh(True, mesh_shape)
        step, args, n_params = build_pp_cell(cfg, mesh, n_micro, shape)
        cost = measure_step(step, *args, mesh=mesh)
        n_stages = collectives.axis_size("pod", mesh)
    terms = RooflineTerms(
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_bytes,
        model_flops_per_device=6.0 * active_params(cfg, n_params)
        * shape.global_batch * shape.seq_len / n_dev)
    peak = cost.peak_bytes + cost.argument_bytes
    rec = {"arch": arch, "shape": "train_4k", "mesh": "multi",
           "tag": f"pp{n_stages}", "status": "ok",
           "seconds": round(time.time() - t0, 1), "devices": n_dev,
           "n_micro": n_micro,
           "memory": {"temp_size_in_bytes": int(cost.peak_bytes),
                      "argument_size_in_bytes": int(cost.argument_bytes)},
           "peak_bytes_per_device": int(peak),
           "fits_hbm": bool(peak <= HBM_BYTES),
           "collectives": {k: float(v) for k, v in cost.coll_by_kind.items()},
           "collectives_by_axis": {k: float(v)
                                   for k, v in cost.coll_by_axis.items()},
           "cost": {"flops": cost.flops, "bytes": cost.bytes,
                    "dot_flops": cost.dot_flops,
                    "collective_bytes": cost.collective_bytes,
                    "kernels": cost.kernels,
                    "off_meta_ops": cost.off_meta_ops},
           "roofline": terms.to_dict()}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__train_4k__multi_pp"
                           f"{n_stages}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def pod_bytes(rec: dict) -> float:
    """The collective bytes a rank sends over the pod axis."""
    return rec.get("collectives_by_axis", {}).get("pod", 0.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--micro", type=int, default=8)
    ap.add_argument("--out", default=ARTIFACT_DIR)
    args = ap.parse_args(argv)

    rec = run_pp(args.arch, args.micro, out_dir=args.out)
    t = rec["roofline"]
    print(f"[ok] PP{rec['tag'][2:]} {args.arch} train_4k multi: "
          f"comp={t['compute_s']:.2f}s mem={t['memory_s']:.2f}s "
          f"coll={t['collective_s']:.2f}s roofline="
          f"{t['roofline_fraction']:.3f} "
          f"peakGB={rec['peak_bytes_per_device'] / 2**30:.1f} "
          f"args={rec['memory']['argument_size_in_bytes'] / 2**30:.1f}GB")
    dp = run_cell(args.arch, "train_4k", True, out_dir=args.out)
    print(f"pod-crossing bytes per rank: PP {pod_bytes(rec):.4e} "
          f"(ppermute + broadcast + the pod's gradient sums), DP over pods "
          f"{pod_bytes(dp):.4e} (the gradient all-reduce)")


if __name__ == "__main__":
    main()
