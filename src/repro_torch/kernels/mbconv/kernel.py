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
from repro_torch.kernels.registry import (
    CLUSTERS, N_SM, SMEM_2_PER_SM, SMEM_LIMIT)

__all__ = ["mbconv_fused", "mbconv_smem_bytes", "mbconv_slice",
           "legal_splits", "choose_blocks", "ranked_blocks", "int8_ranks",
           "mbconv_int8_cluster_smem", "mbconv_int8_pass_smem",
           "mbconv_int8_path", "mbconv_fused_int8", "mbconv_fused_int8_emit"]

_P = ctypes.c_void_p
_I = ctypes.c_int

SPLITS = (1, 2, 4, 8, 16)   # cluster sizes (16 needs the non-portable size)
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
    return dict(_ranked_blocks(tuple(shape), m, f, stride)[0])


def ranked_blocks(shape, m: int, f: int, stride: int, k: int) -> tuple:
    """The ``k`` blocks of least ``_block_cost`` that fit, best first
    (``choose_blocks``' pick first): the autotuner's candidates."""
    return tuple(dict(b) for b in _ranked_blocks(tuple(shape), m, f,
                                                   stride)[:k])


@functools.lru_cache(maxsize=None)
def _ranked_blocks(shape, m: int, f: int, stride: int) -> tuple:
    """Every fitting block by (cost, CTAs), in a stable order, memoised:
    the planner and every ``mbconv_fused`` call without blocks ask
    again."""
    B, H, W, C = shape
    ho = H // stride
    scored = []
    for rows in sorted({ho} | {r for r in (1, 2, 4, 8, 16, 32) if r < ho}):
        for split in legal_splits(m):
            sl = mbconv_slice(m, split)
            for bm in BLOCK_M:
                if bm > max(16, -(-sl // 16) * 16) or \
                        mbconv_smem_bytes(W, f, stride, rows, bm) > SMEM_LIMIT:
                    continue
                key = (_block_cost(shape, m, f, stride, rows, bm, split),
                       split * -(-ho // rows))
                scored.append((key, (("block_rows", rows), ("block_m", bm),
                                     ("split", split))))
    scored.sort(key=lambda kb: kb[0])
    return tuple(b for _, b in scored)


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


# ---------------------------------------------------------------------------
# FIX8: the path choice and the shared-memory mirrors of csrc/mbconv_int8.cuh
# ---------------------------------------------------------------------------

KB = 64          # K bytes per fragment block of the int8 MMA tile
GROWS = 64       # pixels per CTA of a GEMM pass
GEMM_SMEM = 96 * 1024   # a GEMM pass's budget for its panels
GEMM_KCHUNK = 512       # K bytes a chunk of a weight tile too deep to stage
DW_CC = 32       # channels per CTA of the DW pass
DW_SMEM = 24 * 1024


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def panel_pitch(k: int) -> int:
    """Row pitch of an int8 operand panel of k bytes of K: a multiple of
    64 that is 64 (mod 128), so fragment loads are conflict-free."""
    p = _up(k, KB)
    return p if p % 128 else p + KB


def int8_mslice(m: int, ranks: int) -> int:
    """Mid channels per rank of the cluster kernel (``cl_mslice``)."""
    return _up(-(-m // ranks), 16)


def int8_fslice(f: int, ranks: int) -> int:
    """Output columns per rank of the cluster kernel (``cl_fslice``)."""
    return _up(-(-f // ranks), 8)


def int8_ranks(m: int) -> tuple:
    """Cluster sizes whose every rank owns mid channels."""
    return tuple(r for r in SPLITS if int8_mslice(m, r) * (r - 1) < m)


def mbconv_int8_cluster_smem(h: int, w: int, c: int, m: int, f: int,
                             stride: int, ranks: int) -> int:
    """One rank's shared memory in the cluster kernel (mirrors
    ``cl_layout`` in ``csrc/mbconv_int8.cuh``): the input panel (later
    the quantized mid slice with its zero ring and the DW codes), the
    transposed PW1 slice, the fp32 mid slice (later the DW and output
    slices), the transposed PW2 slice, the DW taps, the PW2 int32 sums,
    the reduction words and the slices' dequant scales and biases."""
    ms, fs = int8_mslice(m, ranks), int8_fslice(f, ranks)
    p, po = h * w, (h // stride) * (w // stride)
    px, pm = panel_pitch(c), panel_pitch(m)
    xa = max(_up(p, 16) * px, ((h + 2) * (w + 2) + _up(po, 16)) * ms)
    return (_up(xa, 16) + ms * px + _up(4 * max(p * ms, po * fs), 16)
            + fs * pm + _up(9 * ms, 16) + 4 * _up(po, 16) * fs + 160
            + 4 * (4 * ms + 2 * fs))


def _gemm_pass_smem(k: int, n: int) -> int:
    """A GEMM pass: the A panel and every weight column where both fit
    ``GEMM_SMEM``, else one tile of 64; where that tile of the whole K
    does not fit one CTA beside the panel, the tile in K chunks of
    ``GEMM_KCHUNK`` (``gemm_pass_smem``)."""
    if (GROWS + 64) * panel_pitch(k) > SMEM_LIMIT:
        return GROWS * panel_pitch(k) + 64 * panel_pitch(GEMM_KCHUNK)
    cols = _up(n, 64)
    if (GROWS + cols) * panel_pitch(k) > GEMM_SMEM:
        cols = 64
    return (GROWS + cols) * panel_pitch(k)


def _dw_rows(h: int, w: int, stride: int) -> int:
    rows = 1
    while rows * 2 <= h // stride and \
            ((rows * 2 - 1) * stride + 3) * (w + 2) * DW_CC <= DW_SMEM:
        rows *= 2
    return rows


def mbconv_int8_pass_smem(h: int, w: int, c: int, m: int, f: int,
                          stride: int) -> int:
    """The largest CTA of the three passes (``mbconv_int8_pass_smem_c``):
    the two GEMM passes' panels, the DW pass's window of its band with its
    taps, scales and biases."""
    dw = ((_dw_rows(h, w, stride) - 1) * stride + 3) * (w + 2) * DW_CC \
        + 9 * DW_CC + 8 * DW_CC
    return max(_gemm_pass_smem(c, m), _gemm_pass_smem(m, f), dw)


def mbconv_int8_path(h: int, w: int, c: int, m: int, f: int, stride: int,
                     batch: int = 1) -> dict:
    """The FIX8 MBConv's path for ``batch`` images of one shape:
    ``{"path": "cluster", "ranks": r, "smem": bytes}`` where the CTA of
    the most ranks leaves room for two CTAs per SM and the batch's
    clusters all fit the card at once (``CLUSTERS``); else ``{"path":
    "passes", "ranks": 0, "smem": bytes}``.  Fewer ranks only give each a
    larger slice.  ``chip_smoke.py``'s ``[mbconv_int8 sweep]`` is the
    evidence: the cluster kernel wins at every swept shape whose CTA
    pairs on an SM and loses to the passes at the one that does not
    (S2.mb1, 126 KB: 7 clusters of 16 at once), at batch 1 and 8."""
    return dict(zip(("path", "ranks", "smem"),
                    _int8_path(h, w, c, m, f, stride, batch)))


@functools.lru_cache(maxsize=None)
def _int8_path(h, w, c, m, f, stride, batch) -> tuple:
    """``mbconv_int8_path`` memoised: every call asks again."""
    r = max(int8_ranks(m))
    smem = mbconv_int8_cluster_smem(h, w, c, m, f, stride, r)
    if smem <= SMEM_2_PER_SM and batch <= CLUSTERS[2][r]:
        return "cluster", r, smem
    return "passes", 0, mbconv_int8_pass_smem(h, w, c, m, f, stride)


def _mbconv_int8(x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2,
                 stride, emit, path=None, ranks=None):
    """Validate, choose the path (``mbconv_int8_path``, or ``path`` /
    ``ranks`` forced, for the tests) and launch ``mbconv_int8_i8``; the
    passes need their fp32 scratch maps and zeroed absmax words."""
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
    choice = mbconv_int8_path(H, W, C, M, F, stride, B)
    path = path or choice["path"]
    if path not in ("cluster", "passes"):
        raise ValueError(f"mbconv int8 path {path!r}")
    ranks = 0 if path == "passes" else (ranks or choice["ranks"]
                                        or max(int8_ranks(M)))
    Ho, Wo = H // stride, W // stride
    out = torch.empty((B, Ho, Wo, F), dtype=f32, device=dev)
    mid = dwo = amax = q = scales = None
    if path == "passes":
        mid = torch.empty((B, H, W, M), dtype=f32, device=dev)
        dwo = torch.empty((B, Ho, Wo, M), dtype=f32, device=dev)
        amax = torch.zeros((3, B), dtype=torch.int32, device=dev)
    if emit:
        q = torch.empty((B, Ho, Wo, F), dtype=i8, device=dev)
        scales = torch.empty((B,), dtype=f32, device=dev)
    args = [x_q, xs, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2, mid, dwo,
            out, amax, q, scales]
    lib = library("mbconv_int8")
    fn = lib.mbconv_int8_i8
    fn.argtypes = [_P] * len(args) + [_I] * 8 + [_P]
    fn.restype = _I
    status = fn(*(None if t is None else t.data_ptr() for t in args), B, H,
                W, C, M, F, stride, ranks, stream_of(x_q))
    check(lib, status, "mbconv_fused_int8_emit" if emit
          else "mbconv_fused_int8")
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
    -> (B, Ho, Wo, F) fp32.  One cluster launch where an image's maps
    fit a cluster (``mbconv_int8_path``), else three passes split at the
    two whole-image requantizations (``csrc/mbconv_int8.cu``)."""
    _check_stride(x_q, stride)
    args = (x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2)
    if x_q.device.type == "cpu":
        return mbconv_int8_ref(*args, stride=stride)
    out = _mbconv_int8(*args, stride, emit=False)
    mbconv_fused_int8.launches += 1
    return out


def mbconv_fused_int8_emit(x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b,
                           w2_q, s2, b2, *, stride: int = 1):
    """``mbconv_fused_int8`` + the per-image act-quant of its output:
    -> (q (B, Ho, Wo, F) int8, scales (B,) fp32, out (B, Ho, Wo, F) fp32).
    ``q``/``scales`` equal ``quantize_act(mbconv_fused_int8(...))``; the
    fp output serves a "keep-fp" epilogue.  One cluster launch, or four
    on the passes."""
    from repro_torch.core.quantization import quantize_act

    _check_stride(x_q, stride)
    args = (x_q, x_scale, w1_q, s1, b1, dw_q, dw_s, dw_b, w2_q, s2, b2)
    if x_q.device.type == "cpu":
        out = mbconv_int8_ref(*args, stride=stride)
        qt = quantize_act(out)
        return qt.q, qt.scale, out
    res = _mbconv_int8(*args, stride, emit=True)
    mbconv_fused_int8_emit.launches += 1
    return res


mbconv_fused_int8.launches = 0
mbconv_fused_int8_emit.launches = 0
