"""The SSD scan over the framework's Mamba-2 layout, counterpart of
``repro/kernels/ssd/ops.py``.

``ssd_op`` takes the (b, s, h, p) / (b, s, g, n) layout of the Mamba-2
layer, folds (batch, head) into the kernel's rows, expands the B/C
groups to heads and applies the D skip.
"""
from __future__ import annotations

from repro_torch.kernels.recompute import with_recompute_grad
from repro_torch.kernels.ssd.kernel import ssd_chunked
from repro_torch.kernels.ssd.ref import ssd_scan_ref

__all__ = ["ssd_op"]


def ssd_op(x, dt, A, B, C, *, chunk: int = 256, D_skip=None,
           reference: bool = False):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,); B, C: (b, s, g, n) -> y
    (b, s, h, p) fp32.  ``reference=True`` runs the kernel's plain
    version on the same folded inputs instead, on any device (the LM's
    reference forward).  Differentiable: the kernel's backward recomputes
    through its plain version (``kernels/recompute.py``) and gives x, dt,
    dA, B and C their gradients; dA = dt A is formed outside it, so A
    (``A_log``) and dt (``dt_bias``) get theirs through autograd."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    xf = x.float().transpose(1, 2).reshape(b * h, s, p).contiguous()
    dtf = dt.float().transpose(1, 2).reshape(b * h, s).contiguous()
    dA = dtf * A.float().repeat(b)[:, None]                     # (b*h, s)
    Bf = (B.float().repeat_interleave(rep, dim=2).transpose(1, 2)
          .reshape(b * h, s, n).contiguous())
    Cf = (C.float().repeat_interleave(rep, dim=2).transpose(1, 2)
          .reshape(b * h, s, n).contiguous())
    if reference:
        y = ssd_scan_ref(xf, dtf, dA, Bf, Cf, chunk=chunk)
    else:
        y = with_recompute_grad(ssd_chunked, ssd_scan_ref, xf, dtf, dA, Bf,
                                Cf, chunk=chunk)
    y = y.reshape(b, h, s, p).transpose(1, 2)
    if D_skip is not None:
        y = y + D_skip.float()[None, None, :, None] * x.float()
    return y
