"""Per-op profile of one dry-run cell, counterpart of
``repro/launch/profile_cell.py``: the top contributors by bytes,
collective bytes and FLOPs, each an aten op (or a port kernel's own
report on meta), the call site in the port's code and the output shape
-- the structural profile of the perf-iteration loop (the dry-run runs
on the meta device: there is no wall clock to read).

    PYTHONPATH=src python -m repro_torch.launch.profile_cell \\
        --arch stablelm-12b --shape train_4k [--variant k=v,...] [--top 15]

It reuses ``launch/cost.py``'s counters; JAX's ``--save-hlo`` has no HLO
to save here.  The numbers are computed for one rank of the 256- (or,
with ``--multi``, 512-) H100 mesh, not measured.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import SHAPES, get_arch
from repro_torch.launch.analysis import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.cost import measure_step
from repro_torch.launch.dryrun import (
    _mesh_size, build_cell, fake_world, parse_variant, production_mesh)

__all__ = ["collect", "main"]


def collect(rows, kind: str = "bytes") -> list:
    """``measure_step(record=True)``'s rows of ``kind`` ("bytes",
    "coll" or "flops") summed per (op, call site, output shape), largest
    first: [(value, op, call site, output shape)]."""
    acc: dict = {}
    for k, op, site, shape, value in rows:
        if k == kind:
            key = (op, site, shape)
            acc[key] = acc.get(key, 0.0) + float(value)
    return sorted(((v,) + key for key, v in acc.items()), reverse=True)


def profile(arch: str, shape: str, variant: str = "", multi: bool = False):
    """-> the cell's ``StepCost`` with its rows."""
    cfg = get_arch(arch)
    if variant:
        cfg = cfg.scaled(**parse_variant(variant))
    with fake_world(_mesh_size(multi)):
        mesh = production_mesh(multi)
        fn, args, _, _ = build_cell(cfg, SHAPES[shape], mesh)
        return measure_step(fn, *args, record=True, mesh=mesh)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--variant", default="")
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)

    c = profile(args.arch, args.shape, args.variant, args.multi)
    print(f"== {args.arch} x {args.shape} "
          f"{'(variant ' + args.variant + ')' if args.variant else ''}")
    print(f"flops={c.flops:.3e}  bytes={c.bytes:.3e}  "
          f"coll={c.collective_bytes:.3e}")
    print(f"compute_s={c.flops / PEAK_FLOPS_BF16:.3f}  "
          f"memory_s={c.bytes / HBM_BW:.3f}  "
          f"coll_s={c.collective_bytes / NVLINK_BW:.3f}")
    print(f"peak temp {c.peak_bytes / 2**30:.1f} GB  "
          f"args {c.argument_bytes / 2**30:.1f} GB")
    for kind, unit in (("bytes", 1e9), ("coll", 1e9), ("flops", 1e12)):
        print(f"\n-- top {kind} --")
        for val, op, site, osh in collect(c.rows, kind)[: args.top]:
            print(f"  {val / unit:9.2f}{'GB' if unit == 1e9 else 'TF'} "
                  f"{op:18s} {site[:56]:56s} {osh}")


if __name__ == "__main__":
    main()
