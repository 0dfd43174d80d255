"""Param-tree utilities, counterpart of ``repro/common/tree.py``.

Params, optimizer state and batches are plain nested dicts (and lists)
of tensors.  Flattening visits dict keys in sorted order and list items
in order, as ``jax.tree_util`` does, so a path string (``"a/b/0"``) and
the order of the leaves are JAX's: checkpoints name their files by it
and ``global_norm`` sums in it.  Anything that is not a dict or a list
is a leaf (a tensor, a number, a tuple).
"""
from __future__ import annotations

import re
from typing import Any, Callable, Iterable

import torch

__all__ = ["tree_map", "tree_leaves", "flatten_with_paths",
           "map_with_path", "param_count", "global_norm", "match_first"]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same positions of
    ``rest``), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _walk(tree, path: str):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{path}/{k}" if path else str(k))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{path}/{i}" if path else str(i))
    else:
        yield path, tree


def flatten_with_paths(tree) -> list[tuple[str, Any]]:
    """``tree`` -> [(path string, leaf)], in JAX's order."""
    return list(_walk(tree, ""))


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in _walk(tree, "")]


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``tree_map`` where ``fn`` also receives the leaf's path string."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def param_count(tree) -> int:
    return sum(leaf.numel() for leaf in tree_leaves(tree))


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf of ``tree``, accumulated in fp32, the
    leaves summed in JAX's order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree))
    return torch.sqrt(sq)


def match_first(patterns: Iterable[tuple[str, Any]], path: str, default=None):
    """The value of the first regex in ``patterns`` that matches
    ``path``."""
    for pat, val in patterns:
        if re.search(pat, path):
            return val
    return default
