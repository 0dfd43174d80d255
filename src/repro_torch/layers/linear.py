"""Dense layers (functional) with fan-in scaled init, counterpart of
``repro/layers/linear.py``.  Weights are (in, out); the products stay
``torch.matmul``, as the JAX package leaves them to XLA.

Under a ``ShardingCtx`` whose ``model`` axis splits them
(``distributed/tp.py``): ``linear`` on a ``("fsdp", "tp")`` leaf's
columns gives the rank's columns; ``row_linear`` is the row-parallel
product of a ``("tp", "fsdp")`` leaf; ``embed`` looks the ids up in the
rank's rows of a ``("vocab", "fsdp")`` table (``vocab=`` its global
rows) and ``unembed`` gives the rank's vocab block of the logits."""
from __future__ import annotations

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.tp import param_block, take, whole

__all__ = ["init_linear", "linear", "row_linear", "init_embedding",
           "embed", "unembed"]


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


def row_linear(params, x, rows, out_dim: int):
    """``x`` (..., the rank's ``rows``: a ``tp.Block`` of the input dim)
    @ the rank's rows of a ``("tp", "fsdp")`` weight, ``psum``'d over
    the split in the product's dtype (GSPMD's all-reduce of a dot), the
    bias added once; ``linear`` where the rows are whole.  A W8 leaf's
    ``scale`` is split by OUTPUT column (``w\\w*/scale -> ("tp",)``)
    while ``qw`` is split by rows, so it is gathered whole (an (out,)
    vector; ``out_dim`` its global width)."""
    if not rows.axes:
        return linear(params, x)
    cd = x.dtype
    if "qw" in params:
        scale = take(params["scale"], -1, param_block(("tp",), (out_dim,)),
                     whole(out_dim))
        w = params["qw"].to(cd) * scale.to(cd)
    else:
        w = params["w"].to(cd)
    y = coll.psum(torch.matmul(x, w), rows.axes)
    if "b" in params:
        y = y + params["b"].to(cd)
    return y


def init_embedding(generator: torch.Generator, vocab: int, dim: int,
                   dtype=torch.float32, device=None):
    tbl = torch.randn((vocab, dim), generator=generator,
                      device=generator.device) * dim ** -0.5
    return {"table": tbl.to(device=device, dtype=dtype)}


def embed(params, token_ids, compute_dtype=None, vocab=None):
    """Rows of the table (cast to ``compute_dtype``); an int8 table
    (``"qt"``, ``"scale"``) dequantizes the gathered rows only.
    ``vocab``: the table's global rows; where the installed context
    splits them over ``model`` the table is the rank's rows: an id
    outside them gives zeros, and the rows are ``psum``'d over the
    split (exact: one rank holds each row)."""
    key = "qt" if "qt" in params else "table"
    vb = None
    if vocab is not None:
        vb = param_block(("vocab", "fsdp"),
                         (vocab, params[key].shape[-1]), dim=0)
    ids, hit = token_ids, None
    if vb is not None and vb.axes:
        local = token_ids - vb.start
        hit = (local >= 0) & (local < vb.stop - vb.start)
        ids = torch.where(hit, local, torch.zeros_like(local))
    if "qt" in params:
        cd = compute_dtype or torch.float32
        out = params["qt"][ids].to(cd) * params["scale"][ids].to(cd)
    else:
        out = params["table"][ids]
        out = out.to(compute_dtype) if compute_dtype else out
    if hit is None:
        return out
    out = torch.where(hit[..., None], out, torch.zeros_like(out))
    return coll.psum(out, vb.axes)


def unembed(params, x, compute_dtype=None):
    """Tied-weights readout: (..., d) @ table^T -> (..., vocab); the
    rank's vocab block where the table is the rank's rows."""
    cd = compute_dtype or x.dtype
    return torch.matmul(x.to(cd), params["table"].to(cd).T)
