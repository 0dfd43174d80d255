"""Autograd for a kernel that has no backward kernel.

The causal scans (``relu_attn_causal``, ``ssd_chunked``) replace JAX
Pallas kernels that have no backward either: JAX differentiates the jnp
scans its layers run (``repro/layers/attention.py``'s causal relu_linear
scan, ``repro/layers/mamba2.py``'s SSD).  A launch through ``ctypes``
returns a tensor with no ``grad_fn``, so without this wrapper a loss on
the card would give the inputs upstream of a scan no gradient through
it, and no error.

``with_recompute_grad(kernel, plain, *inputs, **kw)`` runs ``kernel``
forward, saves its inputs, and in the backward runs ``plain`` (the
kernel's plain PyTorch version, the same function) on detached copies
under ``torch.enable_grad()`` and returns ``torch.autograd.grad`` of it,
each gradient in its input's dtype.  It wraps the call on every device,
so the CPU, where ``kernel`` itself runs ``plain``, exercises the same
backward.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["with_recompute_grad"]


class _RecomputeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, kw, *inputs):
        ctx.plain, ctx.kw = plain, kw
        ctx.save_for_backward(*inputs)
        return kernel(*inputs, **kw)

    @staticmethod
    def backward(ctx, gout):
        need = ctx.needs_input_grad[3:]
        xs = [t.detach().requires_grad_(n)
              for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.plain(*xs, **ctx.kw)
        wrt = [x for x, n in zip(xs, need) if n]
        grads = iter(torch.autograd.grad(out, wrt, gout))
        return (None, None, None) + tuple(next(grads) if n else None
                                          for n in need)


def with_recompute_grad(kernel: Callable, plain: Callable, *inputs, **kw):
    """``kernel(*inputs, **kw)``, differentiable through ``plain``."""
    return _RecomputeGrad.apply(kernel, plain, kw, *inputs)
