"""Partition-rule matching, counterpart of
``repro/distributed/partition.py``: regex on a param's path ->
:class:`PartitionSpec`.

Each model family publishes ``(path_regex, logical_axes)`` rules;
:func:`match_partition_rules` walks a param tree and resolves every
leaf's spec against the context's logical -> mesh mapping.  Resolution
is divisibility-aware, as JAX's: a mesh axis that does not divide a dim
is *released*, so a later dim of the same tensor can claim it (grok-1's
8 experts on a 16-way model axis: the expert dim lets go, d_ff takes the
axis).  Unmatched params are replicated.  Shards are therefore always
even.

The port holds a sharded tree as the rank's blocks plus the spec tree:
:func:`shard_tree` cuts a full tree into the rank's blocks and
:func:`gather_tree` puts the full tensors back together (a collective).
Both skip mesh axes of size 1, which split nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.common.tree import map_with_path, match_first, tree_map
from repro_torch.distributed import collectives
from repro_torch.distributed.ctx import (
    NamedSharding, PartitionSpec, ShardingCtx, mesh_axes)

__all__ = ["DEFAULT_RULES", "make_ctx", "resolve_param_spec",
           "match_partition_rules", "named_shardings",
           "data_parallel_specs", "local_block", "gather_leaf",
           "shard_tree", "gather_tree", "replication"]

# Default logical -> mesh rules for the production mesh.  ZeRO/FSDP-style
# parameter sharding rides the data axes, tensor parallel on "model",
# experts on "model" too (EP and TP share the axis; per-tensor dedup keeps
# a mesh axis from being used twice in one spec).
DEFAULT_RULES = {
    "dp": ("pod", "data"),      # batch / token dim of activations
    "fsdp": ("data",),          # ZeRO-sharded param dim
    "fsdp_pod": ("pod", "data"),  # ZeRO over every data-parallel rank
    "sp": None,                  # sequence parallel (enabled per-shape)
    "sp_kv": ("model",),        # decode-cache context (seq) sharding
    "tp": ("model",),           # tensor parallel
    "ep": ("model",),           # expert parallel
    "heads": ("model",),        # attention heads (activations)
    "vocab": ("model",),
}


def make_ctx(mesh, overrides: Optional[dict] = None) -> ShardingCtx:
    """A context for ``mesh`` with ``DEFAULT_RULES`` (updated by
    ``overrides``), every rule cut to the axes the mesh has."""
    rules = dict(DEFAULT_RULES)
    if overrides:
        rules.update(overrides)
    names = set(mesh_axes(mesh))
    for k, v in list(rules.items()):
        if v is None:
            continue
        if isinstance(v, str):
            v = (v,)
        kept = tuple(a for a in v if a in names)
        rules[k] = kept if kept else None
    return ShardingCtx(mesh=mesh, rules=rules)


def resolve_param_spec(ctx: ShardingCtx, logical: Sequence[Optional[str]],
                       shape: Sequence[int]) -> PartitionSpec:
    """Logical axes -> mesh spec for one tensor, divisibility-aware.

    ``logical`` is RIGHT-ALIGNED against ``shape``: rules describe the
    trailing (semantic) dims, and leading layer-stacking dims stay
    unsharded.  A mesh axis that does not divide its dim is released for
    later dims of the same tensor; where the rule's axes together do not
    divide, the largest single one that does is taken."""
    mesh_shape = mesh_axes(ctx.mesh)
    used: set = set()
    out: list = []
    logical = tuple(logical)
    if len(logical) < len(shape):  # right-align
        logical = (None,) * (len(shape) - len(logical)) + logical
    for dim, name in zip(shape, logical):
        if name is None or ctx.rules.get(name) is None:
            out.append(None)
            continue
        axes = ctx.rules[name]
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        cand = tuple(a for a in axes if a not in used)
        picked: tuple = ()
        if cand:
            total = 1
            for a in cand:
                total *= mesh_shape[a]
            if dim % total == 0:
                picked = cand
            else:
                divisors = [a for a in cand if dim % mesh_shape[a] == 0]
                if divisors:
                    picked = (max(divisors, key=lambda a: mesh_shape[a]),)
        used.update(picked)
        if not picked:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return PartitionSpec(*out)


def match_partition_rules(rules, params, ctx: ShardingCtx):
    """A spec tree for ``params`` from ``(regex, axes)`` rules (a leaf
    needs only a ``shape``: meta tensors do)."""
    return map_with_path(
        lambda path, x: resolve_param_spec(
            ctx, match_first(rules, path, default=()), tuple(x.shape)),
        params)


def named_shardings(spec_tree, mesh):
    return tree_map(lambda s: NamedSharding(mesh, s), spec_tree)


def data_parallel_specs(mesh, params, *, batch_axis: str = "batch"):
    """The vision serving mesh's pure data-parallel layout: every param
    replicated (an empty rule set through the same machinery), the
    activations split along ``batch_axis`` -> (param specs, act spec)."""
    ctx = make_ctx(mesh, {k: None for k in DEFAULT_RULES})
    return match_partition_rules([], params, ctx), PartitionSpec(batch_axis)


def _split_axes(spec: PartitionSpec, dim: int, mesh) -> tuple:
    """The axes of size > 1 that split ``dim``."""
    sizes = mesh_axes(mesh)
    return tuple(a for a in spec.axes(dim) if sizes[a] > 1)


def local_block(full, spec: PartitionSpec, mesh):
    """The rank's block of ``full`` under ``spec`` (a view)."""
    x = full
    for d in range(len(spec)):
        axes = _split_axes(spec, d, mesh)
        if axes:
            n = collectives.axis_size(axes, mesh)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split over {axes} ({n} ranks)")
            size = x.shape[d] // n
            x = x.narrow(d, collectives.axis_index(axes, mesh) * size, size)
    return x


def gather_leaf(local, spec: PartitionSpec, mesh):
    """The full tensor from every rank's block under ``spec``."""
    x = local
    for d in range(len(spec)):
        axes = _split_axes(spec, d, mesh)
        if axes:
            x = collectives.all_gather(x, axes, axis=d, mesh=mesh)
    return x


def replication(spec: PartitionSpec, mesh) -> int:
    """How many ranks of ``mesh`` hold each block under ``spec``."""
    n = 1
    for size in mesh_axes(mesh).values():
        n *= size
    for d in range(len(spec)):
        n //= collectives.axis_size(spec.axes(d), mesh)
    return n


def shard_tree(tree, specs, mesh):
    """A full tree -> the rank's blocks (a copy where the block is not
    the whole tensor, so the full tensor can be freed)."""
    def cut(x, s):
        b = local_block(x, s, mesh)
        return b if b.numel() == x.numel() else b.clone()

    return tree_map(cut, tree, specs)


@torch.no_grad()
def gather_tree(tree, specs, mesh):
    """The rank's blocks -> full tensors (a collective over ``mesh``)."""
    return tree_map(lambda x, s: gather_leaf(x, s, mesh), tree, specs)
