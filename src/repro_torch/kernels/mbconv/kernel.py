"""``mbconv_fused``, ``mbconv_fused_int8`` and ``mbconv_fused_int8_emit``:
the hand-written CUDA kernels (``csrc/mbconv.cu``, ``csrc/mbconv_int8.cu``).

Replace the functions of the same names in
``repro/kernels/mbconv/kernel.py``.  A CUDA tensor launches the kernel
(or raises); a CPU tensor takes the plain version in ``ref``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.mbconv_fp import (
    BLOCK_M, KT, kmajor_stage_floats, pw2_bn, round4, rows_stage_floats,
    tile_bm)
from repro_torch.kernels.mbconv.ref import mbconv_int8_ref, mbconv_ref
from repro_torch.kernels.quant import xs_per_batch_vec
from repro_torch.kernels.registry import N_SM, SMEM_LIMIT

__all__ = ["mbconv_fused", "mbconv_smem_bytes", "mbconv_slice",
           "legal_splits", "choose_blocks",
           "mbconv_fused_int8", "mbconv_fused_int8_emit"]

_P = ctypes.c_void_p
_I = ctypes.c_int

SPLITS = (1, 2, 4, 8, 16)   # cluster sizes (16 needs the non-portable size)
# Two CTAs fit on one SM when each needs at most this much shared memory
# (228 KB per SM, 1 KB of it reserved per CTA); the kernel's 107
# registers a thread allow two.
SMEM_2_PER_SM = 233_472 // 2 - 1024
# Clusters of each size the H100 holds at once, with 1 and 2 CTAs per
# SM (cudaOccupancyMaxActiveClusters in chip_smoke.py's block sweep):
# the SMs of a cluster share one GPC, and the GPCs' sizes leave some
# SMs idle at 4, 8 and 16.
CLUSTERS = {1: {1: 132, 2: 66, 4: 30, 8: 15, 16: 7},
            2: {1: 264, 2: 132, 4: 62, 8: 30, 16: 14}}
# Fitted to the block sweep (chip_smoke.py, B1@224's mbconv shapes at
# batch 1 and 8): two CTAs on one SM finish 1.6x the work of one in the
# same time (one hides the other's latencies), and a cluster's
# reduction costs ~64 FFMA slots per output it sums.
TWO_PER_SM = 1.6
REDUCE_COST = 64


def mbconv_smem_bytes(w: int, f: int, stride: int, rows: int,
                      block_m: int) -> int:
    """One CTA's shared memory (mirrors ``mb_layout`` in
    ``csrc/mbconv.cu``): the band's PW2 partial sums, then the larger of
    PW1's staging and the DW result of one chunk, then the larger of the
    chunk's padded mid window and PW2's staging.  The input streams
    through K tiles, so C does not enter."""
    p, t = rows * (w // stride), (rows - 1) * stride + 3
    acc = round4(p * f)
    x = max(rows_stage_floats(block_m), block_m * round4(p))
    y = max(t * (w + 2) * block_m, kmajor_stage_floats(pw2_bn(p, f)))
    return 4 * (acc + x + y)


def mbconv_slice(m: int, split: int) -> int:
    """Mid channels per CTA of a cluster of ``split``: ceil(M / split),
    rounded up to a multiple of 4 (``mb_slice`` in the CUDA source)."""
    return round4(-(-m // split))


def legal_splits(m: int) -> tuple:
    """Cluster sizes whose every rank owns mid channels."""
    return tuple(sp for sp in SPLITS if -(-m // mbconv_slice(m, sp)) == sp)


def _cta_work(h, w, c, m, f, stride, rows, bm, split) -> int:
    """FFMA slots of one CTA: the macro tiles of both GEMMs rounded up
    (a ragged tile computes zeros), the DW taps, and the cluster
    reduction."""
    p = rows * (w // stride)
    nq = min((rows - 1) * stride + 3, h) * w
    chunks = -(-mbconv_slice(m, split) // bm)
    bm1, bn2 = tile_bm(bm), pw2_bn(p, f)
    bm2 = tile_bm(bn2)
    pw1 = -(-nq // bm1) * bm1 * bm * -(-c // KT) * KT
    dw = round4(p) * bm * 9
    pw2 = -(-p // bm2) * bm2 * -(-f // bn2) * bn2 * bm
    red = REDUCE_COST * p * f if split > 1 else 0
    return chunks * (pw1 + dw + pw2) + red


def _block_cost(shape, m: int, f: int, stride: int, rows: int, bm: int,
               split: int) -> float:
    """Modelled time of one launch, in FFMA slots of one CTA: waves of
    CTAs over the card (at most ``CLUSTERS`` clusters at once, one or two
    CTAs per SM as shared memory allows) x one CTA's work, two CTAs on
    one SM together ``TWO_PER_SM`` times as fast as one."""
    B, H, W, C = shape
    per_sm = 2 if mbconv_smem_bytes(W, f, stride, rows, bm) \
        <= SMEM_2_PER_SM else 1
    n = split * -(-(H // stride) // rows) * B
    slots = min(N_SM * per_sm, CLUSTERS[per_sm][split] * split)
    waves = -(-n // slots)
    busy = -(-min(n, slots) // N_SM)      # CTAs per SM in a full wave
    rate = TWO_PER_SM if busy == 2 else 1.0
    return (waves * busy / rate
            * _cta_work(H, W, C, m, f, stride, rows, bm, split))


def choose_blocks(shape, m: int, f: int, stride: int) -> dict:
    """Band height, mid-channel chunk and cluster size for an (B, H, W,
    C) input: the least ``_block_cost`` among the blocks that fit
    ``SMEM_LIMIT``, the fewer CTAs on a tie.  Bands are the whole map or
    powers of two; chunks ``BLOCK_M`` no wider than the slice (rounded
    up to 16).  The model picks within 5 % of the fastest blocks of
    ``chip_smoke.py``'s block sweep at every B1@224 shape, batch 1 and
    8."""
    return dict(_choose_blocks(tuple(shape), m, f, stride))


@functools.lru_cache(maxsize=None)
def _choose_blocks(shape, m: int, f: int, stride: int) -> tuple:
    """The search behind ``choose_blocks``, memoised: the planner and
    every ``mbconv_fused`` call without blocks ask again."""
    B, H, W, C = shape
    ho = H // stride
    best = None
    for rows in sorted({ho} | {r for r in (1, 2, 4, 8, 16, 32) if r < ho}):
        for split in legal_splits(m):
            sl = mbconv_slice(m, split)
            for bm in BLOCK_M:
                if bm > max(16, -(-sl // 16) * 16) or \
                        mbconv_smem_bytes(W, f, stride, rows, bm) > SMEM_LIMIT:
                    continue
                key = (_block_cost(shape, m, f, stride, rows, bm, split),
                       split * -(-ho // rows))
                if best is None or key < best[0]:
                    best = (key, (("block_rows", rows), ("block_m", bm),
                                  ("split", split)))
    return best[1]


def mbconv_fused(x, w1, b1, dw_w, dw_b, w2, b2, *, stride: int = 1,
                 block_rows: int | None = None, block_m: int | None = None,
                 split: int | None = None):
    """x: (B, H, W, C); w1: (C, M); dw_w: (3, 3, M); w2: (M, F)
    -> (B, H // stride, W // stride, F) fp32.  ``block_rows`` /
    ``block_m`` / ``split`` override ``choose_blocks`` (band height, mid
    chunk of ``BLOCK_M`` channels, CTAs per cluster of ``SPLITS``)."""
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
    if None in (block_rows, block_m, split):
        blocks = choose_blocks(x.shape, M, F, stride)
        block_rows = block_rows or blocks["block_rows"]
        block_m = block_m or blocks["block_m"]
        split = split or blocks["split"]
    if block_m not in BLOCK_M or split not in SPLITS:
        raise ValueError(f"mbconv_fused: block_m {block_m} not in "
                         f"{BLOCK_M} or split {split} not in {SPLITS}")
    if mbconv_smem_bytes(W, F, stride, block_rows, block_m) > SMEM_LIMIT:
        raise ValueError(f"mbconv_fused: band of {block_rows} rows x "
                         f"{block_m} mid channels does not fit in "
                         f"{SMEM_LIMIT} B of shared memory")
    out = torch.empty((B, H // stride, W // stride, F), dtype=torch.float32,
                      device=x.device)
    lib = library("mbconv")
    fn = lib.mbconv_fused_f32
    fn.argtypes = [_P] * 8 + [_I] * 10 + [_P]
    fn.restype = _I
    status = fn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), dw_w.data_ptr(),
                dw_b.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                B, H, W, C, M, F, stride, block_rows, block_m, split,
                stream_of(x))
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
