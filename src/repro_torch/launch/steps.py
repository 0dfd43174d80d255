"""The step functions of the trainer and the server, counterpart of
``repro/launch/steps.py``.

``make_train_step``: loss -> gradients (``torch.autograd``) -> the AdamW
update, as one function; ``make_serve_step`` / ``make_prefill_step``:
the model's decode and prefill.  Each is a plain function of trees of
tensors (params and state in, new params and state out), as JAX's.
"""
from __future__ import annotations

import torch

from repro_torch.common.device import scalar
from repro_torch.common.tree import tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["default_opt_cfg", "value_and_grad", "make_train_step",
           "make_serve_step", "make_prefill_step", "init_train_state"]


def default_opt_cfg(cfg: ArchConfig) -> AdamWConfig:
    """JAX's recipe: bf16 moments and no master copy for the big archs
    (64+ experts, or d_model x layers past 4096 x 64), else moments in
    the params' dtype and an fp32 master."""
    big = cfg.n_experts >= 64 or cfg.d_model * cfg.n_layers > 4096 * 64
    return AdamWConfig(state_dtype="bfloat16" if big else None,
                       master_dtype=None if big else "float32")


def value_and_grad(loss_fn):
    """``loss_fn(params, batch)`` -> ``fn(params, batch)`` -> (loss,
    grads), the gradient of every leaf of ``params`` as a tree of its
    own, each leaf in its param's dtype.  The params are not written:
    the loss runs on detached views of them."""
    def fn(params, batch):
        views = []

        def view(p):
            views.append(p.detach().requires_grad_())
            return views[-1]

        tree = tree_map(view, params)
        with torch.enable_grad():
            loss = loss_fn(tree, batch)
        grads = iter(torch.autograd.grad(loss, views))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    return fn


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    grad_accum: int = 1):
    """-> ``train_step(params, opt_state, batch, lr_scale=1.0)`` ->
    (new params, new state, fp32 loss).  ``grad_accum > 1`` splits the
    batch's leading axis into that many microbatches and sums their
    gradients in fp32 (JAX's scan; the peak activation bytes traded for
    passes), then averages them back to each param's dtype."""
    vg = value_and_grad(model.loss)

    if grad_accum <= 1:
        def train_step(params, opt_state, batch, lr_scale=1.0):
            loss, grads = vg(params, batch)
            new_params, new_opt = adamw_update(grads, opt_state, params,
                                               opt_cfg, lr_scale)
            return new_params, new_opt, loss.float()

        return train_step

    def train_step(params, opt_state, batch, lr_scale=1.0):
        micro = tree_map(lambda x: x.reshape(
            (grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:])),
            batch)
        loss_sum, gsum = 0.0, None
        for i in range(grad_accum):
            loss, grads = vg(params, tree_map(lambda x: x[i], micro))
            grads = tree_map(lambda g: g.float(), grads)
            gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                       grads)
            loss_sum = loss_sum + loss.float()
        n = scalar(grad_accum, loss_sum.device)
        grads = tree_map(lambda g, p: (g / n).to(p.dtype), gsum, params)
        new_params, new_opt = adamw_update(grads, opt_state, params, opt_cfg,
                                           lr_scale)
        return new_params, new_opt, loss_sum / n

    return train_step


def make_serve_step(model: Model):
    def serve_step(params, caches, tokens, pos):
        return model.decode(params, caches, tokens, pos)

    return serve_step


def make_prefill_step(model: Model):
    def prefill_step(params, batch):
        return model.prefill(params, batch)

    return prefill_step


def init_train_state(model: Model, opt_cfg: AdamWConfig, key, device=None):
    """Random params from ``key`` (a seed or a ``torch.Generator``) on
    ``device`` (default: the CUDA card) and their fresh AdamW state."""
    params = model.init(key, device)
    return params, adamw_init(params, opt_cfg)
