"""``group_agg_int8``: the hand-written CUDA kernel (``csrc/group_agg.cu``).

Replaces ``repro/kernels/group_conv/kernel.py::group_agg_int8``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.group_agg_int8_ref``.  The kernel takes the grouped (d, C)
weights; the plain version multiplies by their dense block-diagonal
form, as the JAX kernel does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.group_conv.ref import block_diag, group_agg_int8_ref
from repro_torch.kernels.quant import xs_per_batch_vec

__all__ = ["group_agg_int8"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def group_agg_int8(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b):
    """One fused MSA aggregation branch.  x_q: (B, H, W, C) int8 QKV with
    per-tensor or per-image (B,) ``x_scale``; dw_q: (S, S, C) int8 (S
    odd); pw_q: (d, C) int8 grouped 1x1 weights (C // d groups); per-
    channel fp32 scales and biases -> (B, H, W, C) fp32.  Two CUDA
    launches: the DW stage's per-image absmax, then the grouped GEMM
    recomputing the DW stage."""
    B, H, W, C = x_q.shape
    s = dw_q.shape[0]
    d = pw_q.shape[0]
    if s % 2 == 0:
        raise ValueError(f"aggregation scale must be odd, got {s}")
    if x_q.device.type == "cpu":
        return group_agg_int8_ref(x_q, x_scale, dw_q, dw_s, dw_b,
                                  block_diag(pw_q), pw_s, pw_b)
    if x_q.device.type != "cuda":
        raise ValueError(f"group_agg_int8 runs on cuda or cpu, not "
                         f"{x_q.device}")
    if C % d or 64 % d:
        raise ValueError(f"group size {d} must divide {C} and 64")
    xs = xs_per_batch_vec(x_scale, B).contiguous()
    i8, f32 = torch.int8, torch.float32
    for t, name, shape, dt in (
            (x_q, "x_q", (B, H, W, C), i8), (xs, "x_scale", (B,), f32),
            (dw_q, "dw_q", (s, s, C), i8), (dw_s, "dw_s", (C,), f32),
            (dw_b, "dw_b", (C,), f32), (pw_q, "pw_q", (d, C), i8),
            (pw_s, "pw_s", (C,), f32), (pw_b, "pw_b", (C,), f32)):
        check_input(t, name, shape, x_q.device, dt)
    amax = torch.zeros((B,), dtype=torch.int32, device=x_q.device)
    out = torch.empty((B, H, W, C), dtype=f32, device=x_q.device)
    lib = library("group_agg")
    fn = lib.group_agg_int8_i8
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), xs.data_ptr(), dw_q.data_ptr(),
                dw_s.data_ptr(), dw_b.data_ptr(), pw_q.data_ptr(),
                pw_s.data_ptr(), pw_b.data_ptr(), amax.data_ptr(),
                out.data_ptr(), B, H, W, C, s, d, stream_of(x_q))
    check(lib, status, "group_agg_int8")
    group_agg_int8.launches += 1
    return out


group_agg_int8.launches = 0
