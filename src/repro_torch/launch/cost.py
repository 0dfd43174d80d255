"""A step's per-rank cost, counterpart of ``repro/launch/hlo_cost.py``.

JAX compiles the step and parses the optimized HLO.  The port has no
compiler to ask and no HLO to parse, so it re-derives the same three
roofline inputs from one eager run of the step on the meta device
(tensors with shapes and dtypes, no values, no work), under a fake
process group whose collectives return at once:

  * **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s formulas
    (its ``flop_registry``), matmuls and convolutions only, as
    ``hlo_cost`` counts (MODEL_FLOPS is matmul-only too); ``dot_flops``
    the matmuls alone.  Eager torch runs every loop
    iteration, so nothing is counted once for a whole loop (there is no
    ``n_while`` / ``unknown_loops``).  A hand-written kernel called on
    meta launches nothing; its wrapper reports its own work
    (``kernels/registry.py::note_meta_cost``: ``ssd_cost``,
    ``relu_attn_causal_cost``), added to both.
  * **bytes**: one ``TorchDispatchMode``: every aten op adds its tensor
    operands' and outputs' bytes; views, ``empty`` and metadata ops add
    0.  This is the eager port's own traffic: it fuses nothing, so
    elementwise ops count (``hlo_cost`` skips them: XLA fuses them).
  * **collectives**: the same mode sees the ``c10d`` ops and adds their
    on-wire bytes per rank with ``hlo_cost``'s ring multipliers:
    all-reduce 2x the operand, all-gather the result, reduce-scatter /
    all-to-all / permute / broadcast the operand (``ppermute`` runs as
    an all-to-all with split sizes, counted as ``collective-permute``).
  * **peak**: the peak of the live bytes of the storages made inside
    the step (the backward's, the kernels' workspaces included), each
    counted from its first output until Python frees it, as
    ``torch.distributed._tools.mem_tracker.MemTracker`` counts; the
    step's arguments are counted apart (``argument_bytes``, each
    storage once).

All of it is one ``TorchDispatchMode`` (``CostCounter``): a Python mode
costs every op of the step, and a cell runs up to millions of them.

Every number is per rank: the step runs on the rank's blocks.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels.registry import meta_cost_sink

__all__ = ["StepCost", "CostCounter", "measure_step", "argument_bytes",
           "tensor_bytes"]

_DOT_OPS = ("mm", "addmm", "bmm", "baddbmm")
# aten ops that move no data: allocation without a write, metadata
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "alias", "lift_fresh",
             "set_", "resize_", "sym_size", "sym_stride", "sym_numel",
             "sym_storage_offset", "is_same_size", "_local_scalar_dense"}


def tensor_bytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors in ``x`` (a tensor, or nested tuples / lists / dicts
    of them and of other values)."""
    if isinstance(x, torch.Tensor):
        return [x]
    out = []
    stack = [x]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            stack.extend(reversed(v))
        elif isinstance(v, dict):
            stack.extend(reversed(list(v.values())))
    return out


_OP_INFO: dict = {}


def _op_info(func) -> tuple:
    """(name, is c10d, counts no bytes, has a FLOP formula, is a dot) of
    an op, cached."""
    info = _OP_INFO.get(func)
    if info is None:
        name = func._schema.name.split("::")[-1]
        info = (name, func.namespace == "c10d",
                name in _NO_BYTES or func.is_view,
                func._overloadpacket in flop_registry, name in _DOT_OPS)
        _OP_INFO[func] = info
    return info


def argument_bytes(*trees) -> int:
    """The bytes of every tensor in ``trees``, each storage once (a view
    adds nothing)."""
    seen, total = set(), 0
    for t in (t for tree in trees for t in _tensors(tree)):
        st = t.untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


@dataclasses.dataclass
class StepCost:
    """One step's per-rank counts (see the module docstring)."""
    flops: float = 0.0
    dot_flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    coll_by_kind: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0          # the step's own tensors, at their peak
    argument_bytes: int = 0
    coll_by_axis: dict = dataclasses.field(default_factory=dict)
    kernels: dict = dataclasses.field(default_factory=dict)
    off_meta_ops: int = 0        # ops with an output off meta (not empty)
    off_meta: dict = dataclasses.field(default_factory=dict)


class CostCounter(TorchDispatchMode):
    """One dispatch mode that counts every op run inside it (see the
    module docstring): ``flops`` / ``dot_flops`` by ``FlopCounterMode``'s
    formulas (``flop_registry``), ``bytes``, the collective bytes (per
    kind, and per mesh axis given the ``mesh``), and the live and peak
    bytes of the storages made inside it (each storage counted from its
    first output until Python frees it, as ``MemTracker`` counts).  With
    ``record=True`` also one row per op (``rows``: (kind, op, call site,
    output shape, value)) for ``launch/profile_cell.py``; the call site
    is the innermost frame of the port's code."""

    def __init__(self, record: bool = False, mesh=None, known=()):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.bytes = 0.0
        self.collective_bytes = 0.0
        self.coll_by_kind: dict = {}
        self.coll_by_axis: dict = {}
        self.off_meta_ops = 0
        self.off_meta: dict = {}     # "op on device" -> count
        self.live = 0
        self.peak = 0
        self.record = record
        self.rows: list = []
        self.axis_of = ({mesh.get_group(a).group_name: a
                         for a in mesh.mesh_dim_names}
                        if mesh is not None else {})
        # storages alive before the step (its arguments): never counted
        self._seen = {id(t.untyped_storage()) for t in known}
        self._refs: dict = {}

    def add_row(self, kind, op, value, out_shape):
        if self.record:
            self.rows.append((kind, op, _call_site(), out_shape, value))

    def _track(self, outs):
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self._refs[key] = weakref.ref(st, lambda _, k=key, n=n:
                                          self._free(k, n))
            self.live += n
            self.peak = max(self.peak, self.live)

    def _free(self, key, n):
        self._seen.discard(key)
        self._refs.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        # (torch.utils.checkpoint makes 0-element CPU placeholders)
        off = [str(t.device) for t in outs
               if t.device.type != "meta" and t.numel()]
        if off:
            self.off_meta_ops += 1
            key = f"{func} on {off[0]}"
            self.off_meta[key] = self.off_meta.get(key, 0) + 1
        self._track(outs)
        name, c10d, no_bytes, has_flops, dot = _op_info(func)
        if c10d:
            kind, wire, shape = _collective(name, args)
            if kind is not None:
                self.collective_bytes += wire
                self.coll_by_kind[kind] = self.coll_by_kind.get(kind,
                                                                0.0) + wire
                axis = self.axis_of.get(_group_name(args), "other")
                self.coll_by_axis[axis] = self.coll_by_axis.get(axis,
                                                                0.0) + wire
                self.add_row("coll", kind, wire, shape)
            return out
        if has_flops:
            f = flop_registry[func._overloadpacket](*args, **kwargs,
                                                    out_val=out)
            self.flops += f
            if dot:
                self.dot_flops += f
            self.add_row("flops", f"aten.{name}", f, _shape(out))
        if no_bytes:
            return out
        n = sum(t.numel() * t.element_size()
                for t in _tensors(args) + _tensors(kwargs) + outs)
        self.bytes += n
        self.add_row("bytes", f"aten.{name}", n, _shape(out))
        return out


def _collective(name: str, args) -> tuple:
    """(kind, on-wire bytes per rank, operand shape) of a ``c10d`` op
    (kind None for a barrier), with ``hlo_cost``'s ring multipliers:
    all-reduce 2x the operand, all-gather the result, the others (the
    pipeline's broadcast; any other op under its own name) the operand.
    ``ppermute`` is an all-to-all with split sizes
    (``collective-permute``)."""
    def nbytes(x):
        return float(sum(tensor_bytes(t) for t in _tensors(x)))

    if name.startswith(("allgather", "_allgather")):  # outputs, inputs
        return "all-gather", nbytes(args[0]), _shape(args[1])
    if name.startswith("allreduce"):
        return "all-reduce", 2.0 * nbytes(args[0]), _shape(args[0])
    if name.startswith("alltoall"):                    # output, input
        kind = ("collective-permute" if name == "alltoall_base_"
                and (args[3] or args[4]) else "all-to-all")
        return kind, nbytes(args[1]), _shape(args[1])
    if name.startswith("barrier"):
        return None, 0.0, "()"
    kind = "broadcast" if name.startswith("broadcast") else name
    return kind, nbytes(args[0]), _shape(args[0])     # the operand


def _group_name(args):
    """The name of the process group among a c10d op's arguments."""
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).group_name
            except RuntimeError:
                continue
    return None


def _shape(x) -> str:
    ts = _tensors(x)
    return str(tuple(ts[0].shape)) if ts else "()"


def _call_site() -> str:
    """``file:line function`` of the innermost frame in the port's code
    outside this module."""
    f = sys._getframe(3)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and not fn.endswith("cost.py"):
            return (f"{fn.split('repro_torch/')[-1]}:{f.f_lineno} "
                    f"{f.f_code.co_name}")
        f = f.f_back
    return "?"


def measure_step(fn, *args, record: bool = False, mesh=None,
                 **kwargs) -> StepCost:
    """Run ``fn(*args, **kwargs)`` once (on meta tensors, under a fake
    process group: see the module docstring) and count it with one
    ``CostCounter``.  ``mesh``: the collective bytes are also summed per
    mesh axis (``coll_by_axis``).  With ``record=True`` the result has
    ``rows`` (``CostCounter.rows``, the kernels' own reports among
    them) for ``profile_cell``."""
    cost = StepCost(argument_bytes=argument_bytes(args, kwargs))
    counter = CostCounter(record=record, mesh=mesh,
                          known=_tensors((args, kwargs)))

    def sink(name, flops, nbytes):
        k = cost.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes
        counter.add_row("flops", name, flops, "(kernel)")
        counter.add_row("bytes", name, nbytes, "(kernel)")

    with meta_cost_sink(sink), counter:
        out = fn(*args, **kwargs)
        del out
    extra = sum(k["flops"] for k in cost.kernels.values())
    cost.flops = counter.flops + extra
    cost.dot_flops = counter.dot_flops + extra
    cost.bytes = counter.bytes + sum(k["bytes"]
                                     for k in cost.kernels.values())
    cost.collective_bytes = counter.collective_bytes
    cost.coll_by_kind = dict(counter.coll_by_kind)
    cost.coll_by_axis = dict(counter.coll_by_axis)
    cost.off_meta_ops = counter.off_meta_ops
    cost.off_meta = dict(counter.off_meta)
    cost.peak_bytes = counter.peak
    if record:
        cost.rows = counter.rows
    return cost

