"""Inference-form BatchNorm (channel-last), counterpart of
``repro/layers/norms.py``.  Reductions and the affine run in fp32."""
from __future__ import annotations

import torch

__all__ = ["init_batchnorm", "batchnorm", "bn_fold_scale_bias"]


def init_batchnorm(dim: int, dtype=torch.float32, device=None):
    """Running stats live in params; the identity until perturbed."""
    return {
        "scale": torch.ones((dim,), dtype=dtype, device=device),
        "bias": torch.zeros((dim,), dtype=dtype, device=device),
        "mean": torch.zeros((dim,), dtype=dtype, device=device),
        "var": torch.ones((dim,), dtype=dtype, device=device),
    }


def batchnorm(params, x, eps: float = 1e-5):
    """Channel-last BN (NHWC); broadcasting handles NC too."""
    xf = x.float()
    inv = torch.rsqrt(params["var"].float() + eps)
    y = (xf - params["mean"].float()) * inv
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def bn_fold_scale_bias(bn_params, eps: float = 1e-5):
    """(gamma', beta') with BN(x) == x * gamma' + beta'."""
    inv = torch.rsqrt(bn_params["var"].float() + eps)
    gamma = bn_params["scale"].float() * inv
    beta = bn_params["bias"].float() - bn_params["mean"].float() * gamma
    return gamma, beta
