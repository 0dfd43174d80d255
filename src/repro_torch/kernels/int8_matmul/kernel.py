"""``int8_matmul`` and ``int8_matmul_emit``: the hand-written CUDA
kernels (``csrc/int8_matmul.cu``).

Replace ``repro/kernels/int8_matmul/kernel.py::int8_matmul`` and
``::int8_matmul_emit``.  A CUDA tensor launches the kernel (or raises); a
CPU tensor takes the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.int8_matmul.ref import (
    int8_matmul_emit_ref, int8_matmul_ref)
from repro_torch.kernels.quant import xs_per_batch_vec

__all__ = ["int8_matmul", "int8_matmul_emit", "INT8_GEMM_SMEM_BYTES"]

# Static shared memory of one CTA of every int8 GEMM pass (``int8.cuh``):
# two 64 x 36 int8 operand tiles and the absmax reduction's 32 floats.
INT8_GEMM_SMEM_BYTES = 2 * 64 * 36 + 4 * 32

_P = ctypes.c_void_p
_I = ctypes.c_int


def int8_matmul(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: a per-tensor scalar
    or per-row (M,) scales; w_scale: (N,) -> (M, N) fp32
    ``(acc * x_scale[row]) * w_scale[col]``."""
    M, K = x_q.shape
    N = w_q.shape[1]
    if w_q.shape[0] != K:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    if x_q.device.type == "cpu":
        return int8_matmul_ref(x_q, w_q, x_scale, w_scale)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul runs on cuda or cpu, not "
                         f"{x_q.device}")
    xs = xs_per_batch_vec(x_scale, M).contiguous()
    for t, name, shape, dt in ((x_q, "x_q", (M, K), torch.int8),
                               (w_q, "w_q", (K, N), torch.int8),
                               (xs, "x_scale", (M,), torch.float32),
                               (w_scale, "w_scale", (N,), torch.float32)):
        check_input(t, name, shape, x_q.device, dt)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    lib = library("int8_matmul")
    fn = lib.int8_matmul_i8
    fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(),
                w_scale.data_ptr(), out.data_ptr(), M, N, K, stream_of(x_q))
    check(lib, status, "int8_matmul")
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


def int8_matmul_emit(x_q, w_q, x_scale, w_scale, *, rows_per_group: int,
                     bias=None, keep_fp: bool = False):
    """W8A8 GEMM with the producer-side act-quant epilogue.  x_q: (M, K)
    int8, M a multiple of ``rows_per_group``; x_scale: a scalar or one
    scale per row group; w_q: (K, N) int8; w_scale, bias: (N,) ->
    (q (M, N) int8, scales (M // rows_per_group,) fp32), plus the fp32
    output ``(acc * xs) * ws + bias`` when ``keep_fp``.  A memset and two
    CUDA launches: the GEMM folding each row group's absmax, then the
    quantize pass."""
    M, K = x_q.shape
    N = w_q.shape[1]
    if w_q.shape[0] != K:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    if rows_per_group < 1 or M % rows_per_group:
        raise ValueError(f"{M} rows are not whole groups of "
                         f"{rows_per_group}")
    if x_q.device.type == "cpu":
        return int8_matmul_emit_ref(x_q, w_q, x_scale, w_scale,
                                    rows_per_group=rows_per_group,
                                    bias=bias, keep_fp=keep_fp)
    if x_q.device.type != "cuda":
        raise ValueError(f"int8_matmul_emit runs on cuda or cpu, not "
                         f"{x_q.device}")
    G = M // rows_per_group
    dev = x_q.device
    xs = xs_per_batch_vec(x_scale, G).contiguous()
    b = (torch.zeros((N,), dtype=torch.float32, device=dev) if bias is None
         else bias)
    for t, name, shape, dt in ((x_q, "x_q", (M, K), torch.int8),
                               (w_q, "w_q", (K, N), torch.int8),
                               (xs, "x_scale", (G,), torch.float32),
                               (w_scale, "w_scale", (N,), torch.float32),
                               (b, "bias", (N,), torch.float32)):
        check_input(t, name, shape, dev, dt)
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    amax = torch.empty((G,), dtype=torch.int32, device=dev)
    q = torch.empty((M, N), dtype=torch.int8, device=dev)
    scales = torch.empty((G,), dtype=torch.float32, device=dev)
    lib = library("int8_matmul")
    fn = lib.int8_matmul_emit_i8
    fn.argtypes = [_P] * 9 + [_I] * 4 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(),
                w_scale.data_ptr(), b.data_ptr(), out.data_ptr(),
                amax.data_ptr(), q.data_ptr(), scales.data_ptr(), M, N, K,
                rows_per_group, stream_of(x_q))
    check(lib, status, "int8_matmul_emit")
    int8_matmul_emit.launches += 1
    return (q, scales, out) if keep_fp else (q, scales)


int8_matmul_emit.launches = 0
