"""AdamW, counterpart of ``repro/optim/adamw.py``.

The mixed-precision recipe of JAX's:
  * ``state_dtype``   the dtype of the m / v moments (None: each
                      param's own dtype; bfloat16 halves their bytes);
  * ``master_dtype``  an fp32 master copy, kept when some param is in
                      another dtype (None: bf16 params are updated
                      directly).

The update is arithmetic on fp32 values of every leaf, run under
``torch.no_grad()``; it returns new trees and writes none of its
inputs, as JAX's does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common.tree import global_norm, tree_leaves, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Optional[str] = None     # None -> param dtype
    master_dtype: Optional[str] = "float32"


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def adamw_init(params, cfg: AdamWConfig):
    """{"step": 0-dim int32, "m", "v": zeros like each param (in
    ``state_dtype``)[, "master": the params in ``master_dtype``]}, on the
    params' device."""
    def moments(x):
        dt = _dtype(cfg.state_dtype) if cfg.state_dtype else x.dtype
        return torch.zeros(x.shape, dtype=dt, device=x.device)

    leaves = tree_leaves(params)
    state = {"step": torch.zeros((), dtype=torch.int32,
                                 device=leaves[0].device),
             "m": tree_map(moments, params),
             "v": tree_map(moments, params)}
    if cfg.master_dtype:
        md = _dtype(cfg.master_dtype)
        if any(x.dtype != md for x in leaves):
            state["master"] = tree_map(lambda x: x.to(md, copy=True),
                                       params)
    return state


@torch.no_grad()
def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0,
                 gnorm=None):
    """-> (new params, new state).  ``lr_scale`` (a number or a 0-dim
    fp32 tensor, the schedule's) multiplies ``cfg.lr``.  The global
    gradient norm (``global_norm(grads)`` unless ``gnorm`` gives it: a
    sharded step's, reduced over the ranks) is clipped to
    ``grad_clip``; moments are bias-corrected."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.float()
    # b ** step in fp32, as JAX's; ``torch.full`` fills on the device (a
    # host copy would wait for the queued work)
    c1 = 1.0 - torch.pow(torch.full((), b1, device=stepf.device), stepf)
    c2 = 1.0 - torch.pow(torch.full((), b2, device=stepf.device), stepf)
    lr = cfg.lr * lr_scale
    master = state.get("master", params)

    def upd(g, m, v, p):
        gf = g.float() * clip
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * torch.square(gf)
        update = (m_new / c1) / (torch.sqrt(v_new / c2) + cfg.eps)
        pf = p.float()
        p_new = pf - lr * (update + cfg.weight_decay * pf)
        return m_new.to(m.dtype), v_new.to(v.dtype), p_new

    out = tree_map(upd, grads, state["m"], state["v"], master)

    def part(i):
        return tree_map(lambda o: o[i], out)

    new_master = part(2)
    new_params = tree_map(lambda x, p: x.to(p.dtype), new_master, params)
    new_state = {"step": step, "m": part(0), "v": part(1)}
    if "master" in state:
        md = _dtype(cfg.master_dtype)
        new_state["master"] = tree_map(lambda x: x.to(md), new_master)
    return new_params, new_state
