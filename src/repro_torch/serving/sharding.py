"""Batch-axis sharding and per-device fault domains for the vision mesh.

Counterpart of ``repro/serving/sharding.py``.  With a device list
configured, the executor cache lowers the Program at the *local* batch
(``bucket // n_devices``) and runs it once per mesh member: params
replicated once per physical device, rows split contiguously (member
``i`` takes rows ``[i * local_batch, (i + 1) * local_batch)``), the
outputs gathered in row order.  FIX8's activation scales are per image,
so the split leaves its bits unchanged.

A mesh member is a *fault domain*, named by its position in the
configured list, not by the CUDA ordinal: ``devices=("cuda:0",) * 4``
is four domains on one card, and ``("cpu",) * 4`` four on the CPU (the
counterpart of XLA's fake host devices).  :class:`DeviceHealth` is the
registry: a ``DeviceLostError`` marks its domain dead and bumps the
mesh ``epoch``; the cache then evicts every executor whose shard held
it and rebuilds on the survivors, a narrower mesh (the widest that
divides the bucket).  When the last domain dies, ``shard_for`` raises
``MeshExhausted`` and the scheduler fails requests at once instead of
burning retries.

On the card a sharded executor keeps one CUDA graph per member
(``serving.executors``); ``sharded_forward`` is the eager loop over the
members that the CPU runs, each member's graph capturing its step.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch.common.device import resolve_device, tree_to
from repro_torch.common.errors import MeshExhausted
from repro_torch.core.program import execute

__all__ = ["MeshDevice", "ShardSpec", "DeviceHealth", "shard_width",
           "physical_device", "replicate", "sharded_forward"]


class MeshDevice(NamedTuple):
    """One fault domain: ``id`` is its position in the configured device
    list, ``device`` the ``torch.device`` it runs on."""
    id: int
    device: torch.device


def physical_device(device) -> torch.device:
    """``device`` resolved (a CUDA device without a card raises) and
    made explicit: a bare ``"cuda"`` names the current CUDA device, so
    ``"cuda"`` and ``"cuda:0"`` are one physical device."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@dataclass(frozen=True)
class ShardSpec:
    """The device slice one executor is built for.

    ``devices`` is the tuple of mesh members (``MeshDevice``) forming the
    1-D batch mesh; ``local_batch`` is the per-member batch the Program
    was lowered at (``bucket == local_batch * n_devices``)."""
    devices: tuple
    local_batch: int

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def device_ids(self) -> tuple[int, ...]:
        return tuple(d.id for d in self.devices)

    def rows(self, i: int) -> tuple[int, int]:
        """Member ``i``'s rows of the bucket, ``[lo, hi)``."""
        return i * self.local_batch, (i + 1) * self.local_batch


def shard_width(batch: int, n_alive: int) -> int:
    """Largest device count ``k <= n_alive`` with ``batch % k == 0``.

    The bucket ladder is powers of two but the mesh can shrink to any
    size (4 domains -> 3 after one loss), so take the widest divisor:
    batch 4 on 3 survivors runs 2-wide, batch 1 always runs 1-wide.
    """
    if batch <= 0 or n_alive <= 0:
        raise ValueError(f"shard_width({batch}, {n_alive})")
    for k in range(min(batch, n_alive), 0, -1):
        if batch % k == 0:
            return k
    return 1


@dataclass
class DeviceHealth:
    """Per-device fault-domain registry for one serving mesh.

    Tracks which domains are alive, attributes launch failures to their
    domain, and hands out :class:`ShardSpec` slices over the survivors.
    ``epoch`` increments on every death so executors built against an
    older mesh can be recognised as stale.
    """
    devices: tuple
    _dead: set = field(default_factory=set)
    epoch: int = 0
    # optional obs.trace.Tracer: mesh deaths become zero-duration marks
    # on the "mesh" track (ExecutorCache threads it through)
    tracer: object = field(default=None, repr=False, compare=False)

    @classmethod
    def of(cls, devices=None) -> "DeviceHealth":
        """A registry over ``devices`` (names or ``torch.device``s, one
        domain each, repeats allowed); ``None`` takes every CUDA device
        (the CPU always needs an explicit list)."""
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceHealth.of(None) takes every CUDA device and "
                    "there is none; pass a device list, e.g. ('cpu',) * 4")
            devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
        devices = tuple(devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        return cls(devices=tuple(MeshDevice(i, physical_device(d))
                                 for i, d in enumerate(devices)))

    def alive(self) -> tuple:
        return tuple(d for d in self.devices if d.id not in self._dead)

    def dead_ids(self) -> tuple[int, ...]:
        return tuple(sorted(self._dead))

    @property
    def n_alive(self) -> int:
        return len(self.alive())

    @property
    def exhausted(self) -> bool:
        return self.n_alive == 0

    def mark_dead(self, device_id: int) -> bool:
        """Record a domain loss; returns True if it was newly dead."""
        known = {d.id for d in self.devices}
        if device_id not in known or device_id in self._dead:
            return False
        self._dead.add(device_id)
        self.epoch += 1
        if self.tracer is not None:
            self.tracer.end(self.tracer.begin(
                "device.lost", track="mesh", device=device_id,
                alive=self.n_alive, epoch=self.epoch))
        return True

    def attribute(self, err, shard: ShardSpec | None) -> int | None:
        """Blame a launch failure on a domain id, if one can be named.

        ``DeviceLostError`` carries its domain; anything else blames the
        first domain of the failing shard (its launches go first)."""
        dev = getattr(err, "device", None)
        if dev is not None:
            return dev
        if shard is not None and shard.devices:
            return shard.devices[0].id
        return None

    def shard_for(self, batch: int) -> ShardSpec:
        """Widest shard of ``batch`` over the surviving domains.

        Raises :class:`MeshExhausted` when no domain is left."""
        alive = self.alive()
        if not alive:
            raise MeshExhausted(
                f"all {len(self.devices)} devices dead "
                f"(ids {self.dead_ids()})")
        k = shard_width(batch, len(alive))
        return ShardSpec(devices=alive[:k], local_batch=batch // k)


def replicate(params, devices, replicas: dict | None = None) -> dict:
    """The param tree on every physical device of ``devices`` (mesh
    members), keyed by device.  ``params`` itself serves the device it
    lives on, so the domains of one card share one tree and one set of
    weight packs; ``replicas`` (updated in place) reuses the trees
    already moved."""
    replicas = {} if replicas is None else replicas
    home = _tree_device(params)
    if home is not None:
        replicas.setdefault(home, params)
    for d in devices:
        if d.device not in replicas:
            replicas[d.device] = tree_to(params, d.device)
    return replicas


def sharded_forward(program, members, x, *, plan=None, params=None):
    """The whole-bucket forward of one executor-cache entry, eagerly (JAX's
    jitted ``shard_map``).  Each of ``members`` (``device``, its rows
    ``[lo, hi)`` of the bucket, its param tree ``params`` or None for
    the ``params`` given here; one member covers an unsharded bucket)
    runs ``execute`` of ``program`` / ``plan``, lowered at the local
    batch, on its rows and device; the outputs are gathered in row order
    on the device of ``x``."""
    if int(x.shape[0]) != members[-1].hi:
        raise ValueError(f"sharded forward takes the whole bucket of "
                         f"{members[-1].hi} rows, got {tuple(x.shape)}")
    outs = [execute(program, m.params if m.params is not None else params,
                    x[m.lo:m.hi].to(m.device), plan=plan).to(x.device)
            for m in members]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _tree_device(tree):
    """The device of a param tree's first tensor leaf (None if none)."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, list):
        for v in tree:
            dev = _tree_device(v)
            if dev is not None:
                return dev
        return None
    if isinstance(tree, torch.Tensor):
        return physical_device(tree.device) if tree.device.type == "cuda" \
            else tree.device
    return None
