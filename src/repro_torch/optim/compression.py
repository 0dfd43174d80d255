"""Int8 gradient compression with error feedback, counterpart of the
one-device part of ``repro/optim/compression.py``: a symmetric per-leaf
absmax quantize to int8 (``torch.round`` rounds half to even, as
``jnp.round`` does), its dequantize, and the residual carried to the
next step.  ``compressed_psum`` needs a process group and comes with
``distributed/`` (ROADMAP A8g)."""
from __future__ import annotations

import torch

from repro_torch.common.device import scalar
from repro_torch.common.tree import tree_map

__all__ = ["Q_MAX", "quantize_leaf", "dequantize_leaf",
           "compress_grads_with_feedback", "decompress_grads",
           "init_error_feedback"]

Q_MAX = 127.0


def quantize_leaf(g):
    """-> (int8 q, 0-dim fp32 scale): ``scale = max(max|g|, 1e-30) /
    127``, ``q = clip(round(g / scale), -128, 127)``.  Both divisions
    are true divisions on every device (``scalar``)."""
    gf = g.float()
    top = torch.clamp(torch.amax(torch.abs(gf)), min=1e-30)
    scale = top / scalar(Q_MAX, gf.device)
    q = torch.clamp(torch.round(gf / scale), -Q_MAX - 1, Q_MAX)
    return q.to(torch.int8), scale


def dequantize_leaf(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compress_grads_with_feedback(grads, ef_state):
    """(grads + residual) -> (a tree of (q, scale) pairs, the new fp32
    residual tree)."""
    def one(g, ef):
        corrected = g.float() + ef
        q, scale = quantize_leaf(corrected)
        return (q, scale), corrected - dequantize_leaf(q, scale)

    pairs = tree_map(one, grads, ef_state)
    return (tree_map(lambda p: p[0], pairs),
            tree_map(lambda p: p[1], pairs))


def decompress_grads(qtree, grads_template):
    """The (q, scale) tree back to the template's dtypes."""
    return tree_map(lambda qs, g: dequantize_leaf(qs[0], qs[1], g.dtype),
                    qtree, grads_template)


def init_error_feedback(grads_template):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_template)
