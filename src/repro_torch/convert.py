"""JAX param tree (as numpy arrays) -> the port's param tree.

The caller converts the JAX tree's leaves to numpy first
(``jax.tree.map(np.asarray, params)``), so this module imports no JAX.
Dicts and lists keep their keys and order, so ``Site.param_path``
resolves unchanged, and weights keep their HWIO layout; an LM tree's
stacked leaves ((L, ...), zamba2's (groups, every, ...)) keep their
shape, and bf16 leaves their bits.  The same holds for an AdamW state
tree (``{"step": 0-dim int32, "m", "v"[, "master"]}``, JAX's
``adamw_init`` / ``adamw_update``), so a JAX state and the port's start
a step from the same numbers.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree, device=None):
    """Nested dicts/lists/tuples of numpy arrays -> the same nesting of
    torch tensors on ``device`` (default: the CUDA card).  Tuples become
    lists, as the port's trees hold lists."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(np.array(node, copy=True)).to(dev)

    return conv(tree)


def _tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor of the same dtype.  A bfloat16
    array (``ml_dtypes``, what ``np.asarray`` gives for a bf16 JAX
    array), which torch does not take, keeps its bits through an int16
    view."""
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(a)
