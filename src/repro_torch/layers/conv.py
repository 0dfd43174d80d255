"""2-D convolution primitives (NHWC activations, HWIO weights).

Counterpart of ``repro/layers/conv.py``.  Weights keep JAX's HWIO layout
``(k, k, C_in/groups, C_out)`` so a JAX param tree converts leaf for
leaf; ``conv2d`` turns them into PyTorch's OIHW at call time.

Padding follows XLA's ``SAME`` exactly: the total pad is split with the
smaller half first, so a 3x3 stride-2 conv on an even extent pads
(0, 1), not (1, 1).  ``F.conv2d(padding="same")`` cannot express that
(and rejects stride 2), so the pad is explicit.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["init_conv2d", "conv2d", "init_dwconv2d", "dwconv2d",
           "init_pwconv", "pwconv", "same_pads"]


def init_conv2d(generator, k: int, c_in: int, c_out: int, *,
                groups: int = 1, bias: bool = True,
                dtype=torch.float32, device=None):
    fan_in = k * k * c_in // groups
    w = torch.randn((k, k, c_in // groups, c_out), generator=generator,
                    dtype=torch.float32, device=device)
    p = {"w": (w * fan_in ** -0.5).to(dtype)}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=dtype, device=device)
    return p


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA SAME padding (lo, hi) along one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(params, x, *, stride: int = 1, groups: int = 1):
    """x: (B, H, W, C_in) -> (B, H', W', C_out), SAME padding."""
    w = params["w"].to(x.dtype)                   # HWIO
    k = w.shape[0]
    ph, pw = same_pads(x.shape[1], k, stride), same_pads(x.shape[2], k,
                                                         stride)
    xc = x.permute(0, 3, 1, 2)                    # NCHW view
    if any(ph + pw):
        xc = F.pad(xc, (pw[0], pw[1], ph[0], ph[1]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=stride, groups=groups)
    y = y.permute(0, 2, 3, 1)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y.contiguous()


def init_dwconv2d(generator, k: int, c: int, *, bias: bool = True,
                  dtype=torch.float32, device=None):
    return init_conv2d(generator, k, c, c, groups=c, bias=bias, dtype=dtype,
                       device=device)


def dwconv2d(params, x, *, stride: int = 1):
    return conv2d(params, x, stride=stride, groups=x.shape[-1])


def init_pwconv(generator, c_in: int, c_out: int, *, bias: bool = True,
                dtype=torch.float32, device=None):
    return init_conv2d(generator, 1, c_in, c_out, bias=bias, dtype=dtype,
                       device=device)


def pwconv(params, x):
    """1x1 conv == per-pixel matmul."""
    y = x @ params["w"].to(x.dtype)[0, 0]
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y
