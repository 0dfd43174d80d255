"""Multi-pod dry-run, counterpart of ``repro/launch/dryrun.py``: every
(arch x shape x mesh) cell's step built at production sharding and
counted, with no card.

JAX lowers and compiles each cell's jitted step for its 256- or 512-chip
mesh and asks the compiler.  The port has no compiler to ask, so each
cell runs its step once, in explicit SPMD as rank 0 of the production
mesh, on the meta device (shapes and dtypes, no values, no work):

  * the mesh is a ``DeviceMesh`` of the production shape, (16, 16) or
    (2, 16, 16), over a fake process group of 256 or 512 ranks in this
    one process (``fake_world``): its collectives return at once;
  * params, AdamW state, batch and caches are the rank's blocks,
    resolved by ``match_partition_rules`` (``LM_RULES`` /
    ``CACHE_RULES``; the batch on ``dp``, divisibility-aware), made on
    meta (``Model.init(device="meta")``, ``input_specs``);
  * the step is the port's own sharded step (``make_train_step(ctx=)``
    with ``cfg.grad_accum``, ``make_prefill_step`` /
    ``make_serve_step(ctx=)``) and ``launch/cost.py::measure_step``
    counts it: per-rank FLOPs, bytes, collective bytes and the peak of
    the step's own tensors.

Each cell writes one JSON record under ``artifacts/dryrun_torch/``, with
JAX's keys where the meaning carries: ``memory`` has
``temp_size_in_bytes`` (the step's tracked peak) and
``argument_size_in_bytes``; ``hlo_cost`` is ``cost`` (without
``n_while`` / ``unknown_loops``: eager torch runs every loop); JAX's
``xla_cost`` has no counterpart.  The numbers are computed for a 256- or
512-H100 mesh, not measured.  The port's dense layers split over
``model`` as GSPMD's (``distributed/tp.py``), but a step gathers each
dense param whole over ``data`` at its start (``_gather_dense``, where
GSPMD gathers layer by layer), so per-rank bytes exceed JAX's in some
cells.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-2b \\
        --shape decode_32k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import resource
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import ARCHS, SHAPES, get_arch, supports
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.partition import (
    local_block, make_ctx, match_partition_rules, resolve_param_spec,
    shard_tree)
from repro_torch.distributed.rules import CACHE_RULES, LM_RULES
from repro_torch.launch.analysis import (
    HBM_BYTES, RooflineTerms, model_flops_decode, model_flops_train)
from repro_torch.launch.cost import measure_step
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import (
    default_opt_cfg, make_prefill_step, make_serve_step, make_train_step)
from repro_torch.models.registry import build_model, input_specs
from repro_torch.optim.adamw import adamw_init

__all__ = ["ARTIFACT_DIR", "fake_world", "production_mesh", "ctx_overrides",
           "long_ctx_variant", "build_cell", "active_params",
           "parse_variant", "run_cell", "summarize", "main"]

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__),
                            "..", "..", "..", "artifacts", "dryrun_torch")
MESH_SHAPES = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the fake world and the mesh
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks in this process, as rank 0
    (its collectives return at once: the dry-run's tensors are on meta).
    An initialized group of ``n`` ranks is used as it is."""
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()} "
                               f"ranks is live; the dry-run needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def production_mesh(multi_pod: bool = False, shape=None):
    """The production mesh of the live (fake) group: (16, 16) ``("data",
    "model")``, or (2, 16, 16) with ``"pod"``; ``shape`` another shape
    of the same axes (tests)."""
    default, names = MESH_SHAPES[multi_pod]
    return make_mesh(tuple(shape or default), names, device="cpu")


def _mesh_size(multi_pod: bool, shape=None) -> int:
    return math.prod(shape or MESH_SHAPES[multi_pod][0])


# ---------------------------------------------------------------------------
# per-shape sharding policy
# ---------------------------------------------------------------------------

def ctx_overrides(shape: ShapeSpec, cfg: ArchConfig) -> dict:
    """Train/prefill shard the sequence dim over the model axis (sequence
    parallelism) — without it the 4k x 5120 residual carries of a 40-layer
    remat'd scan exceed HBM.  Decode keeps sp off (single-token)."""
    overrides = {}
    if shape.kind in ("train", "prefill"):
        overrides["sp"] = ("model",)
    if shape.kind in ("prefill", "decode") and not cfg.zero_infer:
        overrides["fsdp"] = None      # replicate params over the data axis
    return overrides


def long_ctx_variant(cfg: ArchConfig, shape: ShapeSpec) -> ArchConfig:
    """At long_500k the hybrid archs switch their global-attention slots
    to the paper's relu_linear backend (O(1) state) per DESIGN.md §6."""
    if shape.name == "long_500k" and cfg.family in ("zamba2", "gemma3"):
        return cfg.scaled(attn_backend="relu_linear")
    return cfg


# ---------------------------------------------------------------------------
# the cell's step and its arguments, as the rank's blocks
# ---------------------------------------------------------------------------

def _rows(tree, ctx):
    """Each batch leaf's rank rows: ``dp`` on its leading dim,
    divisibility-aware (JAX's ``_nsh``: the batch-1 long_500k cells keep
    every row)."""
    def cut(x):
        spec = resolve_param_spec(ctx, ("dp",) + (None,) * (x.dim() - 1),
                                  tuple(x.shape))
        return local_block(x, spec, ctx.mesh)

    return tree_map(cut, tree)


def _prefill_caches(model, cfg: ArchConfig, shape: ShapeSpec):
    """The global caches (meta) the prefill returns: ``init_caches`` of
    ``seq_len`` positions; enc-dec the state, its cross K/V as long as
    the frames."""
    B, S = shape.global_batch, shape.seq_len
    caches = model.init_caches(B, S, "meta")
    if cfg.family == "encdec":
        caches["cross"] = {k: torch.empty(v.shape[:2] + (S,) + v.shape[3:],
                                          dtype=v.dtype, device="meta")
                           for k, v in caches["cross"].items()}
    return caches


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh):
    """-> (fn, args, ctx, meta): the cell's step and its arguments (meta
    tensors, the rank's blocks) on ``mesh`` (a ``DeviceMesh`` of the live
    process group)."""
    cfg = long_ctx_variant(cfg, shape)
    model = build_model(cfg)
    ctx = make_ctx(mesh, ctx_overrides(shape, cfg))
    params = model.init(0, "meta")
    if cfg.w8 and shape.kind in ("prefill", "decode"):
        from repro_torch.core.quantization import quantize_lm_params
        params = quantize_lm_params(params)
    n_params = sum(x.numel() for x in tree_leaves(params))
    p_specs = match_partition_rules(LM_RULES, params, ctx)
    blocks = shard_tree(params, p_specs, mesh)
    del params
    specs = input_specs(cfg, shape)
    meta = {"kind": shape.kind, "n_params": n_params}

    if shape.kind == "train":
        opt_cfg = default_opt_cfg(cfg)
        opt = adamw_init(blocks, opt_cfg)
        fn = make_train_step(model, opt_cfg, grad_accum=cfg.grad_accum,
                             ctx=ctx, specs=p_specs)
        return fn, (blocks, opt, _rows(specs, ctx)), ctx, meta

    if shape.kind == "prefill":
        c_specs = match_partition_rules(
            CACHE_RULES, _prefill_caches(model, cfg, shape), ctx)
        fn = make_prefill_step(model, ctx=ctx, specs=p_specs,
                               cache_specs=c_specs)
        return fn, (blocks, _rows(specs, ctx)), ctx, meta

    c_specs = match_partition_rules(CACHE_RULES, specs["caches"], ctx)
    caches = shard_tree(specs["caches"], c_specs, mesh)
    fn = make_serve_step(model, ctx=ctx, specs=p_specs, cache_specs=c_specs)
    return (fn, (blocks, caches, _rows(specs["tokens"], ctx), specs["pos"]),
            ctx, meta)


# ---------------------------------------------------------------------------
# run one cell
# ---------------------------------------------------------------------------

def active_params(cfg: ArchConfig, n_params: int) -> float:
    """Active (per-token) parameter count for MODEL_FLOPS."""
    if cfg.n_experts and cfg.top_k:
        # replace total expert params by top_k of them
        per_expert = 3 * cfg.d_model * cfg.d_ff
        total_moe = cfg.n_layers * cfg.n_experts * per_expert
        active_moe = cfg.n_layers * cfg.top_k * per_expert
        return n_params - total_moe + active_moe
    return float(n_params)


def parse_variant(spec: str) -> dict:
    """'flash_vjp=True,q_chunk=512' -> typed override dict."""
    out = {}
    if not spec:
        return out
    for kv in spec.split(","):
        k, v = kv.split("=", 1)
        if v in ("True", "False"):
            out[k] = v == "True"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def _all_meta(args) -> bool:
    return all(t.device.type == "meta" for t in tree_leaves(list(args))
               if isinstance(t, torch.Tensor))


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             *, out_dir: str = ARTIFACT_DIR, tag: str = "",
             variant: str = "", cfg: ArchConfig = None,
             shape: ShapeSpec = None, mesh_shape=None) -> dict:
    """One cell's record (see the module docstring), written to
    ``out_dir``.  ``cfg`` / ``shape`` / ``mesh_shape`` stand in for the
    named arch, shape and production mesh shape (tests run the smoke
    configs on small meshes)."""
    cfg = cfg or get_arch(arch_name)
    if variant:
        cfg = cfg.scaled(**parse_variant(variant))
    shape = shape or SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = supports(cfg, shape)
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "tag": tag}
    if not ok:
        rec.update(status="skipped", reason=reason)
        return _write(rec, out_dir)

    t0 = time.time()
    n_dev = _mesh_size(multi_pod, mesh_shape)
    try:
        with fake_world(n_dev):
            mesh = production_mesh(multi_pod, mesh_shape)
            fn, args, ctx, meta = build_cell(cfg, shape, mesh)
            if not _all_meta(args):
                raise RuntimeError("a dry-run argument is off the meta "
                                   "device")
            cost = measure_step(fn, *args, mesh=mesh)
            del fn, args
        n_params = meta["n_params"]
        n_active = active_params(cfg, n_params)
        if shape.kind == "train":
            tokens = shape.global_batch * shape.seq_len
            mflops = model_flops_train(n_active, tokens) / n_dev
        elif shape.kind == "prefill":
            tokens = shape.global_batch * shape.seq_len
            mflops = 2.0 * n_active * tokens / n_dev
        else:
            mflops = model_flops_decode(n_active, shape.global_batch) / n_dev

        terms = RooflineTerms(
            flops_per_device=cost.flops,
            bytes_per_device=cost.bytes,
            collective_bytes_per_device=cost.collective_bytes,
            model_flops_per_device=mflops,
        )
        mem_fields = {"temp_size_in_bytes": int(cost.peak_bytes),
                      "argument_size_in_bytes": int(cost.argument_bytes)}
        peak = cost.peak_bytes + cost.argument_bytes
        rec.update(
            status="ok",
            seconds=round(time.time() - t0, 1),
            devices=n_dev,
            n_params=int(n_params),
            n_active_params=int(n_active),
            memory=mem_fields,
            fits_hbm=bool(peak <= HBM_BYTES),
            peak_bytes_per_device=int(peak),
            collectives={k: float(v) for k, v in cost.coll_by_kind.items()},
            collectives_by_axis={k: float(v)
                                 for k, v in cost.coll_by_axis.items()},
            cost={"flops": cost.flops, "bytes": cost.bytes,
                  "dot_flops": cost.dot_flops,
                  "collective_bytes": cost.collective_bytes,
                  "kernels": cost.kernels,
                  "off_meta_ops": cost.off_meta_ops},
            roofline=terms.to_dict(),
        )
    except Exception as e:  # record the failure — it is a bug to fix
        rec.update(status="error", seconds=round(time.time() - t0, 1),
                   error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    return _write(rec, out_dir)


def _write(rec: dict, out_dir: str) -> dict:
    os.makedirs(out_dir, exist_ok=True)
    tag = f"_{rec['tag']}" if rec.get("tag") else ""
    fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(rec, f, indent=1)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" dom={r['dominant']} roofline={r['roofline_fraction']:.2f}"
                 f" peakGB={rec['peak_bytes_per_device'] / 2**30:.1f}")
    elif status == "error":
        extra = " " + rec["error"][:120]
    elif status == "skipped":
        extra = " " + rec["reason"][:80]
    print(f"[{status}] {rec['arch']} x {rec['shape']} x {rec['mesh']}"
          f"{extra}", flush=True)
    return rec


def summarize(out_dir: str = ARTIFACT_DIR) -> dict:
    """The records in ``out_dir`` by status, and the ``ok`` cells whose
    step does not fit the card (``fits_hbm`` false) split by whether the
    rank's blocks alone (the arguments, what JAX's specs give a device)
    fit: where they do, the port's own peak (the dense params gathered
    over ``data`` for the whole step, the activations; ROADMAP C) is
    what does not fit.  Printed and returned."""
    recs = []
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".json"):
            with open(os.path.join(out_dir, name)) as f:
                recs.append(json.load(f))
    over = [r for r in recs if r["status"] == "ok" and not r["fits_hbm"]]
    out = {"status": {s: sum(r["status"] == s for r in recs)
                      for s in ("ok", "skipped", "error")},
           "over_hbm": [f"{r['arch']} x {r['shape']} x {r['mesh']}"
                        for r in over],
           "args_fit": [f"{r['arch']} x {r['shape']} x {r['mesh']}"
                        for r in over
                        if r["memory"]["argument_size_in_bytes"]
                        <= HBM_BYTES]}
    print(f"records {out['status']}; {len(over)} ok cells over "
          f"HBM_BYTES, {len(out['args_fit'])} of them with the rank's "
          f"blocks alone fitting: {', '.join(out['args_fit'])}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=ARTIFACT_DIR)
    ap.add_argument("--tag", default="")
    ap.add_argument("--variant", default="",
                    help="config overrides, e.g. flash_vjp=True,q_chunk=512")
    args = ap.parse_args(argv)

    if args.list:
        for a in ARCHS:
            for s in SHAPES:
                ok, why = supports(get_arch(a), SHAPES[s])
                print(f"{a:24s} {s:12s} {'RUN' if ok else 'SKIP: ' + why}")
        return

    archs = [args.arch] if args.arch else list(ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = args.mesh.split(",")

    results = []
    t0 = time.time()
    for a in archs:
        for s in shapes:
            for m in meshes:
                tag = f"_{args.tag}" if args.tag else ""
                fname = os.path.join(args.out, f"{a}__{s}__{m}{tag}.json")
                if args.skip_existing and os.path.exists(fname):
                    with open(fname) as f:
                        prev = json.load(f)
                    if prev.get("status") in ("ok", "skipped"):
                        print(f"[cached] {a} x {s} x {m}", flush=True)
                        continue
                results.append(run_cell(a, s, m == "multi",
                                        out_dir=args.out, tag=args.tag,
                                        variant=args.variant))
    bad = [r for r in results if r["status"] == "error"]
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    print(f"\n{len(results)} cells run, {len(bad)} errors in "
          f"{time.time() - t0:.1f} s, peak RSS {rss:.1f} MiB")
    summarize(args.out)
    if bad:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
