"""Feed-forward blocks: SwiGLU/GeGLU gated MLPs and plain MLPs,
counterpart of ``repro/layers/mlp.py``.

Under a ``ShardingCtx`` whose ``model`` axis splits ``d_ff``
(``distributed/tp.py``; JAX's ``shard(h, "dp", "sp", "tp")``):
``w_in`` / ``w_gate`` are the rank's columns, so ``h`` is the rank's
block of ``d_ff``, and ``w_out`` is the rank's rows, a ``row_linear``.
The fused ``w_in_gate`` (D, 2F) is split by contiguous columns, so a
rank's block straddles ``[h | g]``: its product is gathered and the
rank's ``d_ff`` block of each half taken."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.distributed.tp import param_block, take, whole
from repro_torch.layers.linear import init_linear, linear, row_linear

__all__ = ["MlpConfig", "init_mlp", "mlp"]


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_model: int
    d_ff: int
    activation: str = "silu"   # silu | gelu | relu | hardswish
    gated: bool = True
    fused: bool = False        # one (D, 2F) matmul for in + gate
    dtype: torch.dtype = torch.float32


def _act(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's
        "relu": F.relu,
        "hardswish": F.hardswish,
    }[name]


def init_mlp(generator: torch.Generator, cfg: MlpConfig, device=None):
    kw = dict(dtype=cfg.dtype, device=device)
    if cfg.fused and cfg.gated:
        return {
            "w_in_gate": init_linear(generator, cfg.d_model, 2 * cfg.d_ff,
                                     **kw),
            "w_out": init_linear(generator, cfg.d_ff, cfg.d_model, **kw),
        }
    p = {
        "w_in": init_linear(generator, cfg.d_model, cfg.d_ff, **kw),
        "w_out": init_linear(generator, cfg.d_ff, cfg.d_model, **kw),
    }
    if cfg.gated:
        p["w_gate"] = init_linear(generator, cfg.d_model, cfg.d_ff, **kw)
    return p


def mlp(params, x, cfg: MlpConfig):
    act = _act(cfg.activation)
    D, F = cfg.d_model, cfg.d_ff
    rows = param_block(("tp", "fsdp"), (F, D), dim=0)     # w_out's rows
    if "w_in_gate" in params:
        hg = linear(params["w_in_gate"], x)
        cols = param_block(("fsdp", "tp"), (D, 2 * F))
        if not (cols.whole and rows.whole):
            hg = take(hg, -1, cols, whole(2 * F))
            hg = torch.cat([hg[..., rows.start:rows.stop],
                            hg[..., F + rows.start:F + rows.stop]], -1)
        h, g = torch.chunk(hg, 2, dim=-1)
        h = act(g) * h
    else:
        h = linear(params["w_in"], x)       # w_in's columns are w_out's rows
        if cfg.gated:
            h = act(linear(params["w_gate"], x)) * h
        else:
            h = act(h)
    return row_linear(params["w_out"], h, rows, D)
