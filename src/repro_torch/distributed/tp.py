"""Tensor parallelism over ``model`` for the dense layers: GSPMD's split
of attention heads, ``d_ff``, the Mamba heads and the vocab, in explicit
SPMD.

Under a :class:`~repro_torch.distributed.ctx.ShardingCtx` the sharded
steps (``launch/steps.py``) hand the layers each dense param gathered
over the data axes only: a leaf that ``LM_RULES`` splits over ``model``
stays the rank's block.  The layers compute on those blocks and move
their activations between layouts where JAX's annotations say so.  A
:class:`Block` is the rank's range of one dim, whose global size a layer
knows from its config: it is resolved from the leaf's logical axes and
its GLOBAL shape (:func:`param_block`, divisibility-aware as the specs
are), never read off a local shape.  Without a context, or on a mesh
whose ``model`` axis has one rank, every block is the whole dim and
every helper is the single-device op.

  * :func:`take`: a tensor holding one range of a dim -> another range;
    a narrow where it holds the range, else an ``all_gather`` of the
    even split it is (an activation: params are never gathered over
    ``model``).
  * ``layers/linear.py::row_linear``: the rank's rows of a ``("tp",
    "fsdp")`` weight times its block of the input, ``psum``'d over the
    split in the product's dtype (GSPMD's all-reduce of a dot), the
    bias added once.
    A W8 ``scale`` of such a leaf is split by output column while
    ``qw`` is split by rows, so the scale is gathered whole (it is an
    (out,) vector).  A ``("fsdp", "tp")`` weight needs no helper:
    ``linear`` on the rank's columns (and their bias and scale) gives
    the rank's columns.
  * :func:`to_spec`: a tensor -> the rank's block under a cache spec's
    ``model`` axes (the data axes are the rows, already the rank's).

The backward needs no op of its own: each rank's gradient is that of the
sum of the ranks' objectives (``distributed/collectives.py``), so the
row-parallel ``psum``'s backward (a ``psum``) sums the ranks' partial
gradients of a replicated activation where it enters the next
column-parallel product, as Megatron's identity-forward op does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.ctx import current_ctx, mesh_axes
from repro_torch.distributed.partition import resolve_param_spec

__all__ = ["DATA_AXES", "Block", "whole", "model_axes", "split_block",
           "param_block", "spec_block", "held_block", "take", "to_spec"]

# the axes the sharded steps gather a dense param over (its fsdp dim)
DATA_AXES = ("pod", "data")


@dataclasses.dataclass(frozen=True)
class Block:
    """The rank's range [start, stop) of a dim of global ``size``;
    ``axes``: the mesh axes whose even split this range is (``()``: the
    whole dim, or a range that is no rank's block of an even split)."""
    size: int
    start: int
    stop: int
    axes: tuple = ()

    @property
    def whole(self) -> bool:
        return self.start == 0 and self.stop == self.size


def whole(size: int) -> Block:
    return Block(size, 0, size)


def _split(spec, dim: int) -> tuple:
    """The axes of ``spec``'s ``dim`` that split it across ranks: size
    > 1 and not a data axis (those the steps gather, or the rows)."""
    sizes = mesh_axes(current_ctx().mesh)
    return tuple(a for a in spec.axes(dim)
                 if sizes[a] > 1 and a not in DATA_AXES)


def model_axes() -> tuple:
    """The axes ``tp`` resolves to under the installed context that
    split (size > 1); ``()`` without a context."""
    ctx = current_ctx()
    if ctx is None or ctx.rules.get("tp") is None:
        return ()
    axes = ctx.rules["tp"]
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = mesh_axes(ctx.mesh)
    return tuple(a for a in axes if sizes[a] > 1 and a not in DATA_AXES)


def split_block(axes: tuple, size: int) -> Block:
    """The rank's block of ``size`` split evenly over ``axes``."""
    if not axes:
        return whole(size)
    n = coll.axis_size(axes)
    if size % n:
        raise ValueError(f"{size} does not split over {axes} ({n} ranks)")
    i = coll.axis_index(axes)
    return Block(size, i * size // n, (i + 1) * size // n, tuple(axes))


def spec_block(spec, dim: int, size: int) -> Block:
    """The rank's block of ``dim`` (global ``size``) under ``spec``;
    the whole dim without a spec or a context."""
    if current_ctx() is None or spec is None:
        return whole(size)
    return split_block(_split(spec, dim), size)


def held_block(spec, dim: int, held: int) -> Block:
    """The rank's block of ``dim`` under ``spec`` where the rank holds
    ``held`` entries of it and no config gives the global size (a
    cache's sequence): the split is ``spec``'s, the global size ``held``
    times the ranks that split it."""
    if current_ctx() is None or spec is None:
        return whole(held)
    axes = _split(spec, dim)
    return split_block(axes, held * (coll.axis_size(axes) if axes else 1))


def param_block(logical: Sequence[Optional[str]], shape: Sequence[int],
                dim: int = -1) -> Block:
    """The rank's block of ``dim`` of a leaf with logical axes
    ``logical`` (right-aligned, as ``LM_RULES``) and GLOBAL ``shape``,
    resolved as its spec is."""
    ctx = current_ctx()
    shape = tuple(shape)
    if ctx is None:
        return whole(shape[dim])
    spec = resolve_param_spec(ctx, logical, shape)
    return spec_block(spec, dim % len(shape), shape[dim])


def take(t, dim: int, have: Block, want: Block):
    """``t`` holds ``have``'s range of ``dim`` -> ``want``'s range:
    ``t`` itself where ``want`` is ``have`` (the same even split, or the
    whole dim), a view where ``t`` is the whole dim, else the whole dim
    gathered from the even split ``have`` is, then narrowed.  The choice
    is the same on every rank of the split: two even splits of one size
    over the same axes give every rank equal ranges or none, and a
    ``want`` that is no even split (``axes`` ``()``: the real heads of a
    padded block, the kv heads of unaligned q heads) is gathered for
    even where the rank's block happens to hold it."""
    if want == have and (have.axes or have.whole):
        return t
    if not have.whole:
        if not have.axes:
            raise ValueError(f"[{have.start}, {have.stop}) of {have.size} "
                             f"is no block of an even split")
        t = coll.all_gather(t, have.axes, axis=dim)
    return t if want.whole else t.narrow(dim, want.start,
                                         want.stop - want.start)


def to_spec(t, spec, have: Optional[dict] = None):
    """``t`` -> the rank's block under ``spec``'s model axes (its data
    axes' dims are the rank's rows already).  ``have``: {dim: Block} for
    dims where ``t`` already holds a range, whole elsewhere.  A cut
    block is a copy, so the whole can be freed."""
    if current_ctx() is None or spec is None:
        return t
    have = have or {}
    out = t
    for d in range(t.dim()):
        h = have.get(d, whole(t.shape[d]))
        out = take(out, d, h, split_block(_split(spec, d), h.size))
    if out.numel() < t.numel() and out.untyped_storage().data_ptr() == \
            t.untyped_storage().data_ptr():
        out = out.clone()
    return out
