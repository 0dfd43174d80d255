"""Int8 gradient compression, counterpart of
``repro/optim/compression.py``.

The multi-pod mesh's ``pod`` axis crosses data-center links with a
fraction of the in-pod bandwidth, and the only traffic that crosses it
in the DP-over-pods layout is the gradient reduction.  Compressing it 4x
(fp32 -> int8 + one scale) attacks that collective's bytes directly.

Two pieces, as JAX's:
  * ``compressed_psum`` -- quantize against the global max scale (one
    ``pmax``), an exact int32 ``psum`` (no saturation for <= 2^23
    summands), dequantize and divide by the axis size;
  * error feedback -- a symmetric per-leaf absmax quantize to int8
    (``torch.round`` rounds half to even, as ``jnp.round`` does), its
    dequantize, and the residual carried to the next step (``ef_*``).
"""
from __future__ import annotations

import torch

from repro_torch.common.device import scalar
from repro_torch.common.tree import tree_map
from repro_torch.distributed import collectives

__all__ = ["Q_MAX", "quantize_leaf", "dequantize_leaf", "compressed_psum",
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


@torch.no_grad()
def compressed_psum(g, axis_name, mesh=None):
    """The mean of ``g`` over ``axis_name``'s ranks, reduced in int32:
    ``scale = max(pmax(max|g|) / 127, 1e-30)``, ``q = round(g / scale)``
    (int32), -> ``psum(q) * scale / n`` in ``g``'s dtype.  Every rank
    quantizes with the same global scale, so the integer sum is exact.
    Every division is a true division (``scalar``)."""
    gf = g.float()
    n = collectives.axis_size(axis_name, mesh)
    top = collectives.pmax(torch.amax(torch.abs(gf)), axis_name, mesh)
    scale = torch.clamp(top / scalar(Q_MAX, gf.device), min=1e-30)
    q = torch.round(gf / scale).to(torch.int32)
    total = collectives.psum(q, axis_name, mesh)
    return (total.float() * scale / scalar(n, gf.device)).to(g.dtype)


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
