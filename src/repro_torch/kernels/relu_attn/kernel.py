"""``relu_attn_noncausal``: the hand-written CUDA kernel
(``csrc/relu_attn.cu``).

Replaces ``repro/kernels/relu_attn/kernel.py::relu_attn_noncausal``.
A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version ``ref.relu_attn_noncausal_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, library, stream_of
from repro_torch.kernels.registry import SMEM_LIMIT
from repro_torch.kernels.relu_attn.ref import EPS, relu_attn_noncausal_ref

__all__ = ["relu_attn_noncausal", "relu_attn_smem_bytes"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


def relu_attn_smem_bytes(d: int, block_n: int) -> int:
    """One CTA's shared memory (mirrors ``relu_attn_smem_bytes`` in the
    CUDA source): the d x d + d state and one ReLU(K) and V tile."""
    return 4 * (d * d + d + 2 * block_n * d)


def relu_attn_noncausal(q, k, v, *, block_n: int = 256, eps: float = EPS):
    """q, k, v: (G, N, heads, d) -> (G, N, heads, d) fp32, one launch.

    The inputs may be strided views (e.g. the q/k/v split of a stacked
    QKV tensor); their last axis must be contiguous and all three must
    share strides."""
    if q.device.type == "cpu":
        return relu_attn_noncausal_ref(q, k, v, eps)
    if q.device.type != "cuda":
        raise ValueError(f"relu_attn_noncausal runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (G, N, heads, d), got {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.stride() != q.stride() \
                or t.device != q.device:
            raise ValueError(f"{name} must match q in shape, strides and "
                             f"device")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if q.stride(-1) != 1:
        raise ValueError("the head_dim axis of q/k/v must be contiguous")
    G, N, heads, D = q.shape
    if relu_attn_smem_bytes(D, block_n) > SMEM_LIMIT:
        raise ValueError(f"relu_attn_noncausal: d={D}, block_n={block_n} "
                         f"does not fit in {SMEM_LIMIT} B of shared memory")
    out = torch.empty((G, N, heads, D), dtype=torch.float32, device=q.device)
    lib = library("relu_attn")
    fn = lib.relu_attn_noncausal_f32
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_L] * 3 + [_I, ctypes.c_float, _P]
    fn.restype = _I
    sg, sn, sh, _ = q.stride()
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), G,
                N, heads, D, sg, sn, sh, block_n, eps, stream_of(q))
    check(lib, status, "relu_attn_noncausal")
    relu_attn_noncausal.launches += 1
    return out


relu_attn_noncausal.launches = 0
