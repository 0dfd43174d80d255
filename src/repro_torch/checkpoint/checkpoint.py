"""Atomic checkpoints with auto-resume, counterpart of
``repro/checkpoint/checkpoint.py``, in JAX's on-disk layout:

    <root>/step_00000100.tmp/...    while writing
    <root>/step_00000100/
        MANIFEST.json               {"step", "leaves": {path: {"file",
                                    "shape", "dtype"}}, "extra"}
        <leaf path, "/" -> "__">.npy  one file per leaf

A leaf's path is ``common/tree.py``'s (``"params/blocks/ln1/w"``).  A
bfloat16 leaf is written as JAX writes it: its raw 2-byte words under a
``<V2`` header, manifest dtype ``"bfloat16"``; ``restore`` reads it back
as bfloat16 by the manifest (JAX's own ``restore`` cannot: it refuses
the ``|V2`` array numpy loads).  Checkpoints move between JAX and the
port both ways, bf16 leaves into the port only.

Guarantees, as JAX's:
  * atomicity: the manifest is written into the ``.tmp`` directory,
    which is renamed last; ``latest_step`` ignores ``.tmp`` directories
    and ``CheckpointManager`` removes them;
  * auto-resume: ``latest_step`` / ``restore`` find the newest complete
    step;
  * async save: ``CheckpointManager.save_async`` copies the tree to host
    memory at once and writes it on a background thread while training
    goes on.

Sharded trees (``shardings=``, a tree of ``NamedSharding``: each leaf
the rank's block): ``save`` gathers the full values over the mesh, the
mesh's first rank writes the same files as a single-device save of those
values, and the other ranks wait for it; ``restore`` loads each leaf and
keeps the rank's block, so a checkpoint moves onto any mesh, as JAX's
``restore(shardings=)`` does.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import flatten_with_paths, map_with_path, tree_map
from repro_torch.distributed import collectives
from repro_torch.distributed.ctx import mesh_axes

__all__ = ["MANIFEST", "save", "latest_step", "restore", "barrier",
           "is_writer", "CheckpointManager"]

MANIFEST = "MANIFEST.json"


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def _leaf_file(path: str) -> str:
    return path.replace("/", "__") + ".npy"


def _host(leaf) -> torch.Tensor:
    """A leaf as a CPU tensor of its own (a copy of a CPU tensor, so
    later writes to the original do not reach the snapshot)."""
    t = torch.as_tensor(leaf).detach()
    return t.to("cpu", copy=True)


def _write_leaf(fname: str, t: torch.Tensor) -> str:
    """Write one CPU tensor as a .npy file; -> its manifest dtype."""
    if t.dtype == torch.bfloat16:
        words = t.contiguous().view(torch.int16).numpy()
        with open(fname, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": tuple(t.shape)})
            f.write(words.tobytes())
        return "bfloat16"
    arr = t.numpy()
    np.save(fname, arr)
    return str(arr.dtype)


def _read_leaf(fname: str, dtype: str) -> torch.Tensor:
    arr = np.load(fname)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr)


def is_writer(mesh) -> bool:
    """Whether this rank writes ``mesh``'s checkpoints (its first)."""
    return torch.distributed.get_rank() == int(mesh.mesh.reshape(-1)[0])


def barrier(mesh):
    """Every rank of ``mesh`` waits for the others (a psum over every
    axis, on any backend)."""
    x = torch.zeros((), device=mesh.device_type)
    collectives.psum(x, tuple(mesh_axes(mesh)), mesh).item()


@torch.no_grad()
def _gather(tree, shardings):
    """The rank's blocks -> (the full tree, on every rank; the mesh)."""
    mesh = flatten_with_paths(shardings)[0][1].mesh
    return tree_map(lambda x, s: s.gather(x), tree, shardings), mesh


def save(root: str, step: int, tree: Any, *, extra: Optional[dict] = None,
         shardings: Any = None):
    """Synchronous atomic checkpoint write; -> the step's directory.
    With ``shardings`` every rank of their mesh calls it with its blocks
    (see the module docstring)."""
    if shardings is not None:
        full, mesh = _gather(tree, shardings)
        final = (save(root, step, full, extra=extra) if is_writer(mesh)
                 else _step_dir(root, step))
        barrier(mesh)
        return final
    os.makedirs(root, exist_ok=True)
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "leaves": {}, "extra": extra or {}}
    for path, leaf in flatten_with_paths(tree):
        t = leaf if isinstance(leaf, torch.Tensor) and \
            leaf.device.type == "cpu" else _host(leaf)
        fname = _leaf_file(path)
        dtype = _write_leaf(os.path.join(tmp, fname), t.detach())
        manifest["leaves"][path] = {
            "file": fname, "shape": list(t.shape), "dtype": dtype}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def _complete_steps(root: str) -> list:
    return sorted(int(n[5:]) for n in os.listdir(root)
                  if n.startswith("step_") and not n.endswith(".tmp")
                  and os.path.exists(os.path.join(root, n, MANIFEST)))


def latest_step(root: str) -> Optional[int]:
    """The newest step with a complete (renamed, manifest-bearing)
    directory, or None."""
    if not os.path.isdir(root):
        return None
    steps = _complete_steps(root)
    return steps[-1] if steps else None


def restore(root: str, tree_template: Any, *, step: Optional[int] = None,
            device=None, shardings: Any = None):
    """Load a checkpoint into the structure of ``tree_template`` ->
    (tree, step, extra).  Each leaf keeps the checkpoint's dtype and
    goes to ``device``, by default its template leaf's device; with
    ``shardings`` (a matching tree of ``NamedSharding``) only the rank's
    block does.  Raises ``KeyError`` for a leaf the checkpoint lacks and
    ``ValueError`` for a shape that differs from the template's (the
    full shape: a ``meta`` template will do)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no complete checkpoint under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)

    def load(path, tmpl, sharding=None):
        info = manifest["leaves"].get(path)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {path!r}")
        t = _read_leaf(os.path.join(d, info["file"]), info["dtype"])
        shape = tuple(torch.as_tensor(tmpl).shape)
        if tuple(t.shape) != shape:
            raise ValueError(f"shape mismatch for {path}: ckpt "
                             f"{tuple(t.shape)} vs template {shape}")
        dev = device if device is not None else (
            tmpl.device if isinstance(tmpl, torch.Tensor) else "cpu")
        if sharding is not None:
            return sharding.shard(t).to(dev, copy=True)
        return t.to(dev)

    by_path = dict(flatten_with_paths(shardings)) if shardings else {}
    tree = map_with_path(lambda p, t: load(p, t, by_path.get(p)),
                         tree_template)
    return tree, step, manifest.get("extra", {})


class CheckpointManager:
    """Async writer, retention (``keep`` newest complete steps) and
    removal of ``.tmp`` directories left by a crash."""

    def __init__(self, root: str, *, keep: int = 3):
        self.root = root
        self.keep = keep
        self._q: queue.Queue = queue.Queue(maxsize=1)
        self._error: Optional[BaseException] = None
        self._mesh = None       # of the sharded saves: ``wait`` joins it
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                step, host_tree, extra = item
                try:
                    save(self.root, step, host_tree, extra=extra)
                    self._gc()
                except BaseException as e:  # raised by the next call
                    self._error = e
            finally:
                self._q.task_done()

    def _gc(self):
        steps = _complete_steps(self.root)
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)
        for n in os.listdir(self.root):   # orphaned tmp dirs from crashes
            if n.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.root, n),
                              ignore_errors=True)

    def _raise(self):
        if self._error:
            e, self._error = self._error, None
            raise e

    def save_async(self, step: int, tree: Any, *,
                   extra: Optional[dict] = None, shardings: Any = None):
        """Copy ``tree`` to host memory now; write it in the background
        (waits while an earlier save is still queued).  With
        ``shardings`` every rank of their mesh calls it with its blocks,
        as ``save``'s: the full values are gathered now, the mesh's
        first rank writes them, and ``wait`` waits for that rank."""
        self._raise()
        if shardings is not None:
            tree, self._mesh = _gather(tree, shardings)
            if not is_writer(self._mesh):
                return
        self._q.put((step, tree_map(_host, tree), extra))

    def wait(self):
        """Block until every queued checkpoint is on disk (on every rank
        of a sharded save's mesh)."""
        self._q.join()
        self._raise()
        if self._mesh is not None:
            barrier(self._mesh)

    def close(self):
        self._q.join()
        self._q.put(None)
        self._worker.join(timeout=30)
        self._raise()
