"""Feed-forward blocks: SwiGLU/GeGLU gated MLPs and plain MLPs,
counterpart of ``repro/layers/mlp.py``."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.layers.linear import init_linear, linear

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
    if "w_in_gate" in params:
        h, g = torch.chunk(linear(params["w_in_gate"], x), 2, dim=-1)
        h = act(g) * h
    else:
        h = linear(params["w_in"], x)
        if cfg.gated:
            h = act(linear(params["w_gate"], x)) * h
        else:
            h = act(h)
    return linear(params["w_out"], h)
