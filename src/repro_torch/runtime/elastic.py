"""Elastic scaling: reshard live training state onto a new mesh,
counterpart of ``repro/runtime/elastic.py``.

When hosts die (or stragglers are evicted) the job re-meshes over the
survivors rather than blocking on replacement hardware:

  1. build the new (smaller or larger) mesh and its ``ShardingCtx``
     (every rank of the world builds it, members or not);
  2. re-resolve every leaf's spec under the new context
     (divisibility-aware, so axes that no longer divide fall back);
  3. move the blocks: each new rank keeps what it already holds and
     receives only the pieces it lacks, in one all-to-all over the world
     per leaf (JAX's ``device_put`` moves only the bytes that must move);
  4. the data pipeline needs no state migration at all: batches are a
     pure function of (seed, step) (``data/pipeline.py``), so the
     survivors re-slice the global batch.

A checkpoint restored onto another mesh takes the same specs
(``checkpoint.restore(shardings=)``).
"""
from __future__ import annotations

import itertools
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_map
from repro_torch.distributed.ctx import NamedSharding, ShardingCtx, mesh_axes
from repro_torch.distributed.partition import make_ctx, match_partition_rules

__all__ = ["reshard_tree", "replicate_tree"]


def _global_shape(local_shape, sharding: Optional[NamedSharding]) -> tuple:
    """The full shape of a block held under ``sharding`` (None: the
    block is the full tensor)."""
    if sharding is None:
        return tuple(local_shape)
    sizes = mesh_axes(sharding.mesh)
    out = []
    for d, n in enumerate(local_shape):
        for a in sharding.spec.axes(d):
            n *= sizes[a]
        out.append(n)
    return tuple(out)


def _regions(shape, sharding: Optional[NamedSharding], world: int) -> list:
    """Each world rank's region of the full tensor under ``sharding``:
    a tuple of (start, stop) per dim, or None for a rank outside the
    mesh (every rank holds the whole tensor when ``sharding`` is None)."""
    full = tuple((0, n) for n in shape)
    if sharding is None:
        return [full] * world
    mesh = sharding.mesh
    sizes = mesh_axes(mesh)
    names = list(sizes)
    out: list = [None] * world
    grid = mesh.mesh.reshape(tuple(sizes.values()))
    for coord in itertools.product(*(range(n) for n in sizes.values())):
        at = dict(zip(names, coord))
        region = []
        for d, n in enumerate(shape):
            axes = sharding.spec.axes(d)
            k, i = 1, 0
            for a in axes:
                k *= sizes[a]
                i = i * sizes[a] + at[a]
            region.append((i * n // k, (i + 1) * n // k))
        out[int(grid[coord])] = tuple(region)
    return out


def _cut(region, inner):
    """``inner`` (absolute) as slices of a tensor that holds ``region``."""
    return tuple(slice(a - r0, b - r0) for (a, b), (r0, _) in zip(inner,
                                                                 region))


def _nbytes(piece, itemsize: int) -> int:
    for a, b in piece:
        itemsize *= b - a
    return itemsize


def _move(local, shape, old, new):
    """One leaf from this rank's block under ``old`` to its block under
    ``new`` (None outside the new mesh).  Each piece a new rank lacks
    comes from one rank that holds it (the lowest), as bytes, in one
    all-to-all over the world."""
    world, me = dist.get_world_size(), dist.get_rank()
    src_of = _regions(shape, old, world)
    dst_of = _regions(shape, new, world)
    if any(r is None for r in src_of):
        raise ValueError("every rank of the world must hold its block "
                         "under the old layout")
    owners: dict = {}
    for r, have in enumerate(src_of):
        owners.setdefault(have, []).append(r)
    plan = []        # (src, dst, absolute region of the piece), dst-major
    for n, want in enumerate(dst_of):
        for have, ranks in owners.items() if want is not None else ():
            piece = tuple((max(a, c), min(b, d))
                          for (a, b), (c, d) in zip(want, have))
            if all(a < b for a, b in piece):
                plan.append((n if n in ranks else ranks[0], n, piece))
    mine = src_of[me]
    size = local.element_size()
    recv = sorted((p for p in plan if p[1] == me and p[0] != me),
                  key=lambda p: p[0])
    received = []
    if any(s != d for s, d, _ in plan):
        send = [p for p in plan if p[0] == me and p[1] != me]  # dst order
        in_bytes, out_bytes = [0] * world, [0] * world
        for _, d, piece in send:
            in_bytes[d] += _nbytes(piece, size)
        for s, _, piece in recv:
            out_bytes[s] += _nbytes(piece, size)
        parts = [local[_cut(mine, piece)].contiguous().view(-1)
                 .view(torch.uint8) for _, _, piece in send]
        inp = (torch.cat(parts) if parts else
               torch.empty(0, dtype=torch.uint8, device=local.device))
        out = torch.empty(sum(out_bytes), dtype=torch.uint8,
                          device=local.device)
        dist.all_to_all_single(out, inp, output_split_sizes=out_bytes,
                               input_split_sizes=in_bytes)
        received = out.split([_nbytes(p[2], size) for p in recv])
    want = dst_of[me]
    if want is None:
        return None
    block = torch.empty(tuple(b - a for a, b in want), dtype=local.dtype,
                        device=local.device)
    for s, d, piece in plan:
        if s == d == me:
            block[_cut(want, piece)] = local[_cut(mine, piece)]
    for (_, _, piece), raw in zip(recv, received):
        dst = block[_cut(want, piece)]
        dst.copy_(raw.view(local.dtype).view(dst.shape))
    return block


def reshard_tree(tree: Any, rules, new_ctx: ShardingCtx, *,
                 old: Any = None) -> Any:
    """Move ``tree`` onto ``new_ctx``'s mesh under ``rules`` -> this
    rank's blocks (None leaves on a rank outside the new mesh).  ``old``
    is the tree of ``NamedSharding`` under which every rank of the world
    holds its blocks now (None: every rank holds the full tensors)."""
    olds = old if old is not None else tree_map(lambda _: None, tree)
    shapes = tree_map(lambda x, o: torch.empty(_global_shape(x.shape, o),
                                               device="meta"), tree, olds)
    specs = match_partition_rules(rules, shapes, new_ctx)
    return tree_map(
        lambda x, o, s, full: _move(x, tuple(full.shape), o,
                                    NamedSharding(new_ctx.mesh, s)),
        tree, olds, specs, shapes)


def replicate_tree(tree: Any, mesh, *, old: Any = None) -> Any:
    """Every leaf whole on every rank of ``mesh`` (the always-valid
    fallback layout)."""
    return reshard_tree(tree, [], make_ctx(mesh), old=old)
