"""The fp pieces of ``repro/core/quantization.py`` the fp32 path needs.

BN folding feeds the fused kernels' weights.  The FIX8 scheme itself
(``QTensor``, ``quantize_efficientvit``, int8 convs) is a later slice of
the port: a quantized param tree raises ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch.layers.norms import bn_fold_scale_bias

__all__ = ["fold_bn_into_conv", "act_fp", "reject_quantized"]

FIX8_SLICE = ("FIX8 (int8) params are not ported yet; the FIX8 slice of "
              "the port adds them")


def fold_bn_into_conv(conv_p, bn_p, eps: float = 1e-5):
    """(conv, BN) -> folded (w', b') with BN absorbed per output channel."""
    gamma, beta = bn_fold_scale_bias(bn_p, eps)
    w = conv_p["w"].float() * gamma[None, None, None, :]
    b = conv_p.get("b")
    b = beta if b is None else beta + b.float() * gamma
    return w, b


def act_fp(y):
    """The fp view of an activation.  The fp32 path only carries fp
    tensors; an int8 boundary (``QTensor`` in the JAX package) belongs
    to the FIX8 slice."""
    if not isinstance(y, torch.Tensor):
        raise NotImplementedError(FIX8_SLICE)
    return y


def reject_quantized(p) -> None:
    """Raise on a ``quantize_efficientvit`` (``qconv``) param block."""
    if isinstance(p, dict) and "qconv" in p:
        raise NotImplementedError(FIX8_SLICE)
