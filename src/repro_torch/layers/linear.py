"""Dense layers (functional) with fan-in scaled init, counterpart of
``repro/layers/linear.py``.  Weights are (in, out); the products stay
``torch.matmul``, as the JAX package leaves them to XLA."""
from __future__ import annotations

import torch

__all__ = ["init_linear", "linear", "init_embedding", "embed", "unembed"]


def init_linear(generator: torch.Generator, in_dim: int, out_dim: int, *,
                bias: bool = False, dtype=torch.float32, device=None,
                scale: float = 1.0):
    """{"w": (in, out)} drawn N(0, (scale / sqrt(in))^2) in fp32 on the
    generator's device, then cast and placed on ``device`` (+ a zero
    ``"b"``)."""
    std = scale * in_dim ** -0.5
    w = torch.randn((in_dim, out_dim), generator=generator,
                    device=generator.device) * std
    p = {"w": w.to(device=device, dtype=dtype)}
    if bias:
        p["b"] = torch.zeros((out_dim,), dtype=dtype, device=device)
    return p


def linear(params, x, compute_dtype=None):
    """x (..., d) @ w (d, f) (+ b) in ``compute_dtype`` (x's by
    default).  A weight-only int8 leaf (``"qw"``, ``"scale"``) is
    dequantized first."""
    cd = compute_dtype or x.dtype
    if "qw" in params:   # weight-only int8 (FIX8 serving path)
        w = params["qw"].to(cd) * params["scale"].to(cd)
    else:
        w = params["w"].to(cd)
    y = torch.matmul(x.to(cd), w)
    if "b" in params:
        y = y + params["b"].to(cd)
    return y


def init_embedding(generator: torch.Generator, vocab: int, dim: int,
                   dtype=torch.float32, device=None):
    tbl = torch.randn((vocab, dim), generator=generator,
                      device=generator.device) * dim ** -0.5
    return {"table": tbl.to(device=device, dtype=dtype)}


def embed(params, token_ids, compute_dtype=None):
    """Rows of the table (cast to ``compute_dtype``); an int8 table
    (``"qt"``, ``"scale"``) dequantizes the gathered rows only."""
    if "qt" in params:
        cd = compute_dtype or torch.float32
        rows = params["qt"][token_ids].to(cd)
        return rows * params["scale"][token_ids].to(cd)
    out = params["table"][token_ids]
    return out.to(compute_dtype) if compute_dtype else out


def unembed(params, x, compute_dtype=None):
    """Tied-weights readout: (..., d) @ table^T -> (..., vocab)."""
    cd = compute_dtype or x.dtype
    return torch.matmul(x.to(cd), params["table"].to(cd).T)
