"""``mbconv_fused``, ``mbconv_fused_int8`` and ``mbconv_fused_int8_emit``:
the hand-written CUDA kernels (``csrc/mbconv.cu``, ``csrc/mbconv_int8.cu``).

Replace the functions of the same names in
``repro/kernels/mbconv/kernel.py``.  A CUDA tensor launches the kernel
(or raises); a CPU tensor takes the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.mbconv.ref import mbconv_int8_ref, mbconv_ref
from repro_torch.kernels.quant import xs_per_batch_vec
from repro_torch.kernels.registry import N_SM, SMEM_LIMIT

__all__ = ["mbconv_fused", "mbconv_smem_bytes", "choose_blocks",
           "mbconv_fused_int8", "mbconv_fused_int8_emit"]

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


def _mbconv_int8(fn_name, x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b,
                 w2_q, s2, b2, stride, emit):
    """Validate, allocate the scratch maps and launch one of the two C
    entry points of ``csrc/mbconv_int8.cu``."""
    B, H, W, C = x_q.shape
    M, F = w1_q.shape[1], w2_q.shape[1]
    dev = x_q.device
    xs = xs_per_batch_vec(x_scale, B).contiguous()
    i8, f32 = torch.int8, torch.float32
    for t, name, shape, dt in (
            (x_q, "x_q", (B, H, W, C), i8), (xs, "x_scale", (B,), f32),
            (w1_q, "w1_q", (C, M), i8), (s1, "s1", (M,), f32),
            (b1, "b1", (M,), f32), (dw_q, "dw_q", (3, 3, M), i8),
            (dw_s, "dw_s", (M,), f32), (dw_b, "dw_b", (M,), f32),
            (w2_q, "w2_q", (M, F), i8), (s2, "s2", (F,), f32),
            (b2, "b2", (F,), f32)):
        check_input(t, name, shape, dev, dt)
    Ho, Wo = H // stride, W // stride
    mid = torch.empty((B, H, W, M), dtype=f32, device=dev)
    dwo = torch.empty((B, Ho, Wo, M), dtype=f32, device=dev)
    out = torch.empty((B, Ho, Wo, F), dtype=f32, device=dev)
    amax = torch.zeros((3, B), dtype=torch.int32, device=dev)
    args = [x_q, xs, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2, mid, dwo,
            out, amax]
    if emit:
        q = torch.empty((B, Ho, Wo, F), dtype=i8, device=dev)
        scales = torch.empty((B,), dtype=f32, device=dev)
        args += [q, scales]
    lib = library("mbconv_int8")
    fn = getattr(lib, fn_name)
    fn.argtypes = [_P] * len(args) + [_I] * 7 + [_P]
    fn.restype = _I
    status = fn(*(t.data_ptr() for t in args), B, H, W, C, M, F, stride,
                stream_of(x_q))
    check(lib, status, fn_name)
    return (q, scales, out) if emit else out


def _check_stride(x_q, stride):
    H, W = x_q.shape[1:3]
    if H % stride or W % stride:
        raise ValueError(f"spatial {H}x{W} not divisible by stride {stride}")
    if x_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the int8 mbconv kernels run on cuda or cpu, not "
                         f"{x_q.device}")


def mbconv_fused_int8(x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q,
                      s2, b2, *, stride: int = 1):
    """x_q: (B, H, W, C) int8 with per-tensor or per-image (B,)
    ``x_scale``; w1_q: (C, M), dw_q: (3, 3, M), w2_q: (M, F) int8;
    per-channel fp32 weight scales, BN-folded fp32 biases
    -> (B, Ho, Wo, F) fp32.  Three CUDA launches, split at the two
    whole-image requantizations (``csrc/mbconv_int8.cu``)."""
    _check_stride(x_q, stride)
    args = (x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2)
    if x_q.device.type == "cpu":
        return mbconv_int8_ref(*args, stride=stride)
    out = _mbconv_int8("mbconv_fused_int8_i8", *args, stride, emit=False)
    mbconv_fused_int8.launches += 1
    return out


def mbconv_fused_int8_emit(x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b,
                           w2_q, s2, b2, *, stride: int = 1):
    """``mbconv_fused_int8`` + the per-image act-quant of its output:
    -> (q (B, Ho, Wo, F) int8, scales (B,) fp32, out (B, Ho, Wo, F) fp32).
    ``q``/``scales`` equal ``quantize_act(mbconv_fused_int8(...))``; the
    fp output serves a "keep-fp" epilogue.  Four CUDA launches."""
    from repro_torch.core.quantization import quantize_act

    _check_stride(x_q, stride)
    args = (x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2)
    if x_q.device.type == "cpu":
        out = mbconv_int8_ref(*args, stride=stride)
        qt = quantize_act(out)
        return qt.q, qt.scale, out
    res = _mbconv_int8("mbconv_fused_int8_emit_i8", *args, stride,
                       emit=True)
    mbconv_fused_int8_emit.launches += 1
    return res


mbconv_fused_int8.launches = 0
mbconv_fused_int8_emit.launches = 0
