"""The ``jax.lax`` collectives that JAX's ``shard_map`` code uses, on
``torch.distributed``, over the process group of one mesh axis (or of
several: a tuple of axis names acts over their product, the first axis
outermost, as in JAX).

Every function takes ``axis_name`` as ``jax.lax`` does and reads the
mesh of the installed :class:`~repro_torch.distributed.ctx.ShardingCtx`
unless ``mesh=`` is given.  An axis's index of a rank is its rank in
that axis's process group.  Each collective communicates even over an
axis of size 1 (as JAX's returns its input there), and a failed
collective raises.

Autograd: a rank's gradient is that of the SUM over ranks of their
objectives (each rank's loss its share of the global one).  So
``psum``'s backward is a ``psum``; ``all_gather``'s is a ``psum`` of the
gathered gradient cut to the rank's block (``psum_scatter``);
``all_to_all``'s is the all-to-all back; ``ppermute``'s the inverse
permutation; ``pmax`` passes the summed gradient to the ranks that hold
the maximum.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.common.device import scalar
from repro_torch.distributed.ctx import current_ctx, mesh_axes

__all__ = ["axis_size", "axis_index", "psum", "pmean", "pmax",
           "all_gather", "all_to_all", "ppermute"]


def _mesh(mesh):
    if mesh is not None:
        return mesh
    ctx = current_ctx()
    if ctx is None:
        raise RuntimeError("a collective needs a mesh: pass mesh= or "
                           "install a ShardingCtx with use_sharding")
    return ctx.mesh


def _axes(axis_name) -> tuple:
    return (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)


def axis_size(axis_name, mesh=None) -> int:
    """``jax.lax.psum(1, axis_name)``: the number of ranks on the axes."""
    sizes = mesh_axes(_mesh(mesh))
    n = 1
    for a in _axes(axis_name):
        n *= sizes[a]
    return n


def axis_index(axis_name, mesh=None) -> int:
    """``jax.lax.axis_index``: this rank's index along the axes (row-major
    over a tuple)."""
    mesh = _mesh(mesh)
    sizes = mesh_axes(mesh)
    i = 0
    for a in _axes(axis_name):
        i = i * sizes[a] + dist.get_rank(mesh.get_group(a))
    return i


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return _Psum.apply(g, ctx.group), None


class _Pmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return _Psum.apply(g, ctx.group) * (x == y), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, axis):
        ctx.group, ctx.axis, ctx.size = group, axis, x.shape[axis]
        x = x.contiguous()
        n = dist.get_world_size(group)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, g):
        g = _Psum.apply(g, ctx.group)
        r = dist.get_rank(ctx.group)
        return g.narrow(ctx.axis, r * ctx.size, ctx.size), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.split, ctx.concat = group, split_axis, concat_axis
        n = dist.get_world_size(group)
        if x.shape[split_axis] % n:
            raise ValueError(f"all_to_all: dim {split_axis} of "
                             f"{tuple(x.shape)} does not split {n} ways")
        inp = torch.stack(x.chunk(n, dim=split_axis)).contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp, group=group)
        return torch.cat(out.unbind(0), dim=concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_AllToAll.apply(g, ctx.group, ctx.concat, ctx.split),
                None, None, None)


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        r, n = dist.get_rank(group), dist.get_world_size(group)
        dst = dict(perm).get(r)
        src = {d: s for s, d in perm}.get(r)
        flat = x.contiguous().view(-1)
        m = flat.numel()
        out = flat.new_empty(m if src is not None else 0)
        dist.all_to_all_single(
            out, flat if dst is not None else flat[:0],
            output_split_sizes=[m if j == src else 0 for j in range(n)],
            input_split_sizes=[m if j == dst else 0 for j in range(n)],
            group=group)
        return out.view(x.shape) if src is not None else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        inv = tuple((d, s) for s, d in ctx.perm)
        return _Ppermute.apply(g, ctx.group, inv), None, None


def psum(x, axis_name, mesh=None):
    """``jax.lax.psum``: the elementwise sum over the axes' ranks."""
    mesh = _mesh(mesh)
    for a in _axes(axis_name):
        x = _Psum.apply(x, mesh.get_group(a))
    return x


def pmean(x, axis_name, mesh=None):
    """``jax.lax.pmean``: ``psum`` divided by the axes' size (a true
    division)."""
    return psum(x, axis_name, mesh) / scalar(axis_size(axis_name, mesh),
                                             x.device)


def pmax(x, axis_name, mesh=None):
    """``jax.lax.pmax``: the elementwise maximum over the axes' ranks."""
    mesh = _mesh(mesh)
    for a in _axes(axis_name):
        x = _Pmax.apply(x, mesh.get_group(a))
    return x


def all_gather(x, axis_name, *, axis: int = 0, mesh=None):
    """``jax.lax.all_gather(x, axis_name, axis=axis, tiled=True)``: the
    ranks' blocks concatenated along ``axis`` in axis-index order."""
    mesh = _mesh(mesh)
    for a in reversed(_axes(axis_name)):     # innermost axis first
        x = _AllGather.apply(x, mesh.get_group(a), axis)
    return x


def all_to_all(x, axis_name: str, split_axis: int, concat_axis: int, *,
               mesh=None):
    """``jax.lax.all_to_all(x, axis_name, split_axis, concat_axis,
    tiled=True)``: ``x`` cut into axis-size chunks along ``split_axis``,
    chunk j sent to index j; the chunks received concatenated along
    ``concat_axis`` in source order."""
    return _AllToAll.apply(x, _mesh(mesh).get_group(axis_name), split_axis,
                           concat_axis)


def ppermute(x, axis_name: str, perm, *, mesh=None):
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) index
    pairs; a rank that no pair sends to gets zeros."""
    perm = tuple((int(s), int(d)) for s, d in perm)
    return _Ppermute.apply(x, _mesh(mesh).get_group(axis_name), perm)
