"""Normalization layers, counterpart of ``repro/layers/norms.py``:
inference-form BatchNorm (channel-last) for EfficientViT, RMSNorm and
LayerNorm for the LM archs.  Reductions and the affine run in fp32."""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll

__all__ = ["init_batchnorm", "batchnorm", "bn_fold_scale_bias",
           "init_rmsnorm", "rmsnorm", "init_layernorm", "layernorm"]


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


# -- LM norms: RMSNorm and LayerNorm ---------------------------------------

def init_rmsnorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps: float = 1e-6, axes: tuple = ()):
    """x * rsqrt(mean(x^2) + eps) * scale, in fp32, cast back.
    ``axes``: ``x``'s last dim (and ``scale``) is the rank's block of an
    even split over these mesh axes (Mamba's gated norm over ``d_inner``
    under tensor parallelism): the sum of squares is ``psum``'d over
    them and divided by the global width."""
    xf = x.float()
    if axes:
        sq = coll.psum(torch.sum(xf * xf, dim=-1, keepdim=True), axes)
        var = sq / (xf.shape[-1] * coll.axis_size(axes))
    else:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def init_layernorm(dim: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x, eps: float = 1e-5):
    """(x - mean) * rsqrt(var + eps) * scale + bias, in fp32, cast
    back."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
