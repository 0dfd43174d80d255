"""Logical-axis sharding context, counterpart of ``repro/distributed/ctx.py``.

Layers name the axes of their tensors *logically* ("dp", "sp", "tp",
"ep", ...).  A :class:`ShardingCtx` installed with :func:`use_sharding`
for the duration of a step maps those names onto the axes of a
``torch.distributed.device_mesh.DeviceMesh`` (``pod``, ``data``,
``model``).  Without a context every annotation is a no-op, so every
layer runs unchanged on one device.

JAX runs GSPMD from one controller, and ``shard`` there constrains a
global array's layout.  The port runs one process per rank on the rank's
own blocks (explicit SPMD), so ``shard`` checks the annotation's rank and
returns its local tensor unchanged: the layers split their work over
``model`` themselves (``distributed/tp.py``: GSPMD's split of the heads,
``d_ff`` and the vocab, where JAX's annotations put it).

The port keeps its own :class:`PartitionSpec`, whose ``str()`` reads as
JAX's (``PartitionSpec('data', 'model')``), and its own
:class:`NamedSharding` (a mesh and a spec; ``placements`` gives the
DTensor placements, ``shard`` / ``gather`` move one tensor between its
full value and the rank's block).  Resolution reads only the mesh's axis
names and sizes (:func:`mesh_axes`), so it is pure Python: it runs
without a process group, at any mesh shape.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional, Sequence

__all__ = ["PartitionSpec", "P", "NamedSharding", "ShardingCtx",
           "mesh_axes", "current_ctx", "use_sharding", "shard",
           "named_sharding"]

_STATE = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: None (not split), a mesh axis name, or a
    tuple of axis names (the dim split over their product, the first
    axis outermost), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    __str__ = __repr__

    def axes(self, dim: int) -> tuple:
        """The mesh axes that split ``dim`` (``()`` past the spec's end)."""
        e = self[dim] if dim < len(self) else None
        if e is None:
            return ()
        return (e,) if isinstance(e, str) else tuple(e)


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """{axis name: size}, in the mesh's order.  Takes a ``DeviceMesh``
    or anything with ``axis_names`` and ``devices.shape`` (a JAX mesh, or
    a stub of one: resolution needs no devices)."""
    if hasattr(mesh, "mesh_dim_names"):
        return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.devices.shape)))


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A ``DeviceMesh`` and a :class:`PartitionSpec`: how one tensor is
    laid out over the mesh's ranks."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dim: ``Shard(d)`` where the
        spec splits tensor dim ``d`` over that axis, else ``Replicate()``
        (a dim split over several axes gets ``Shard`` on each, the first
        axis outermost, as DTensor orders them)."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {a: d for d in range(len(self.spec))
                  for a in self.spec.axes(d)}
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in mesh_axes(self.mesh))

    def shard(self, full):
        """The rank's block of ``full`` (a view)."""
        from repro_torch.distributed.partition import local_block
        return local_block(full, self.spec, self.mesh)

    def gather(self, local):
        """The full tensor from every rank's block (a collective)."""
        from repro_torch.distributed.partition import gather_leaf
        return gather_leaf(local, self.spec, self.mesh)


@dataclasses.dataclass
class ShardingCtx:
    mesh: object
    # logical axis name -> mesh axis name (or tuple of mesh axes, or None)
    rules: dict = dataclasses.field(default_factory=dict)

    def resolve(self, logical: Sequence[Optional[str]]) -> PartitionSpec:
        """Logical names -> a spec; a mesh axis is used at most once
        (the first name that claims it keeps it)."""
        out = []
        used: set = set()
        for name in logical:
            axes = None if name is None else self.rules.get(name)
            if axes is None:
                out.append(None)
                continue
            if isinstance(axes, str):
                axes = (axes,)
            picked = tuple(a for a in axes if a not in used)
            used.update(picked)
            if not picked:
                out.append(None)
            elif len(picked) == 1:
                out.append(picked[0])
            else:
                out.append(picked)
        return PartitionSpec(*out)


def current_ctx() -> Optional[ShardingCtx]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingCtx]):
    """Install ``ctx`` for this thread (restored on exit)."""
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ctx
    try:
        yield
    finally:
        _STATE.ctx = prev


def shard(x, *logical: Optional[str]):
    """Annotate ``x`` with logical axis names.  Raises when the number of
    names is not ``x``'s rank (under a context, as JAX's); otherwise the
    identity: ``x`` is already the rank's local tensor."""
    if current_ctx() is not None and x.ndim != len(logical):
        raise ValueError(
            f"shard(): rank {x.ndim} array got {len(logical)} axis names")
    return x


def named_sharding(*logical: Optional[str]) -> Optional[NamedSharding]:
    """The current context's sharding for ``logical`` (its
    ``placements`` are DTensor's), or None without a context."""
    ctx = current_ctx()
    if ctx is None:
        return None
    return NamedSharding(ctx.mesh, ctx.resolve(logical))
