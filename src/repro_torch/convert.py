"""JAX param tree (as numpy arrays) -> the port's param tree.

The caller converts the JAX tree's leaves to numpy first
(``jax.tree.map(np.asarray, params)``), so this module imports no JAX.
Dicts and lists keep their keys and order, so ``Site.param_path``
resolves unchanged, and weights keep their HWIO layout.
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
        return torch.as_tensor(np.array(node, copy=True), device=dev)

    return conv(tree)
