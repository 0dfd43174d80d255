"""``mbconv_fused``: the hand-written CUDA kernel (``csrc/mbconv.cu``).

Replaces ``repro/kernels/mbconv/kernel.py::mbconv_fused``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.mbconv_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.mbconv.ref import mbconv_ref
from repro_torch.kernels.registry import N_SM, SMEM_LIMIT

__all__ = ["mbconv_fused", "mbconv_smem_bytes", "choose_blocks"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def mbconv_smem_bytes(w: int, c: int, f: int, stride: int, rows: int,
                      block_m: int) -> int:
    """One CTA's shared memory (mirrors ``mbconv_smem_bytes`` in the
    CUDA source): the band's input rows + halo, one chunk of the padded
    mid map, the DW result of that chunk, the PW2 partial sums."""
    t = (rows - 1) * stride + 3
    wo = w // stride
    return 4 * (t * w * c + t * (w + 2) * block_m + rows * wo * block_m
                + rows * wo * f)


def choose_blocks(shape, m: int, f: int, stride: int) -> dict:
    """Band height and mid-channel chunk for an (B, H, W, C) input.

    Bands are sized so the grid has about one CTA per SM; the chunk is
    the largest of M, 512, 256, ... 8 with which one CTA needs at most
    half of the shared memory (two CTAs per SM), the band halving until
    one does.  When nothing fits in half, one-row bands with the
    smallest chunk are checked against the whole 227 KB by the caller.
    """
    B, H, W, C = shape
    ho = H // stride
    chunks = [m] + [c for c in (512, 256, 128, 64, 32, 16, 8) if c < m]
    rows = max(1, min(ho, B * ho // N_SM))
    while True:
        for bm in chunks:
            if mbconv_smem_bytes(W, C, f, stride, rows, bm) \
                    <= SMEM_LIMIT // 2:
                return {"block_rows": rows, "block_m": bm}
        if rows == 1:
            return {"block_rows": 1, "block_m": chunks[-1]}
        rows //= 2


def mbconv_fused(x, w1, b1, dw_w, dw_b, w2, b2, *, stride: int = 1,
                 block_rows: int | None = None, block_m: int | None = None):
    """x: (B, H, W, C); w1: (C, M); dw_w: (3, 3, M); w2: (M, F)
    -> (B, H // stride, W // stride, F) fp32."""
    B, H, W, C = x.shape
    M, F = w1.shape[1], w2.shape[1]
    if H % stride or W % stride:
        raise ValueError(f"spatial {H}x{W} not divisible by stride {stride}")
    if x.device.type == "cpu":
        return mbconv_ref(x, w1, b1, dw_w, dw_b, w2, b2, stride=stride)
    if x.device.type != "cuda":
        raise ValueError(f"mbconv_fused runs on cuda or cpu, not {x.device}")
    for t, name, shape in ((x, "x", (B, H, W, C)), (w1, "w1", (C, M)),
                           (b1, "b1", (M,)), (dw_w, "dw_w", (3, 3, M)),
                           (dw_b, "dw_b", (M,)), (w2, "w2", (M, F)),
                           (b2, "b2", (F,))):
        check_input(t, name, shape, x.device)
    blocks = choose_blocks(x.shape, M, F, stride)
    rows = block_rows or blocks["block_rows"]
    bm = block_m or blocks["block_m"]
    if mbconv_smem_bytes(W, C, F, stride, rows, bm) > SMEM_LIMIT:
        raise ValueError(f"mbconv_fused: band of {rows} rows x {bm} mid "
                         f"channels does not fit in {SMEM_LIMIT} B of "
                         f"shared memory")
    out = torch.empty((B, H // stride, W // stride, F), dtype=torch.float32,
                      device=x.device)
    lib = library("mbconv")
    fn = lib.mbconv_fused_f32
    fn.argtypes = [_P] * 8 + [_I] * 9 + [_P]
    fn.restype = _I
    status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), dw_w.data_ptr(),
                dw_b.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                B, H, W, C, M, F, stride, rows, bm, stream_of(x))
    check(lib, status, "mbconv_fused")
    mbconv_fused.launches += 1
    return out


mbconv_fused.launches = 0
