"""``dsconv_fused``, ``dsconv_fused_int8`` and ``dsconv_fused_int8_emit``:
the hand-written CUDA kernels (``csrc/dsconv.cu``, ``csrc/dsconv_int8.cu``).

Replace ``repro/kernels/dsconv/kernel.py::dsconv_fused``,
``::dsconv_fused_int8`` and ``::dsconv_fused_int8_emit``.  A CUDA tensor
launches the kernel (or raises); a CPU tensor takes the plain version in
``ref``.  ``choose_blocks`` sizes ``dsconv_fused``'s bands from the shape
only.  ``dsconv_int8_path`` chooses, by shape only, between the FIX8
cluster kernel (one launch, the 1x1 on int8 tensor cores; emitting, the
output's act-quant in the same launch) and the passes.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.dsconv.ref import (
    dsconv_int8_emit_ref, dsconv_int8_ref, dsconv_ref)
from repro_torch.kernels.int8_matmul.kernel import INT8_GEMM_SMEM_BYTES
from repro_torch.kernels.quant import xs_per_batch_vec
from repro_torch.kernels.registry import N_SM, SMEM_LIMIT, SMEM_PER_SM

__all__ = ["dsconv_fused", "dsconv_smem_bytes", "choose_blocks",
           "dsconv_fused_int8", "dsconv_fused_int8_emit",
           "dsconv_int8_cluster_smem", "dsconv_int8_ranks",
           "dsconv_int8_path"]

MAX_RANKS = 16   # the largest thread-block cluster (above 8 non-portable)
DSF_SM_CTAS = 2        # CTAs an SM takes at once in choose_blocks' plan

_P = ctypes.c_void_p
_I = ctypes.c_int


def dsconv_pitch(c: int) -> int:
    """Floats between staged pixels (``dsf_pitch`` in ``csrc/dsconv.cu``):
    c, or c + 4 where c % 32 == 16 (the float4 reads of two DW runs in a
    quarter-warp then fall in distinct banks)."""
    return c + 4 if c % 32 == 16 else c


def dsconv_smem_bytes(w: int, c: int, f: int, stride: int, rows: int) -> int:
    """One CTA's shared memory (mirrors ``dsf_layout`` in
    ``csrc/dsconv.cu``), with c and f rounded up to multiples of 4 (the
    pad channels staged as zeros): the band's input rows with the halo,
    (rows - 1) * stride + 3 of them, each w + 2 pixels (a zero pixel at
    both ends); two DW row buffers (one for a band of one row); the 1x1
    weights, the taps and both biases."""
    c, f = -(-c // 4) * 4, -(-f // 4) * 4
    cp = dsconv_pitch(c)
    nin = (rows - 1) * stride + 3
    return 4 * (nin * (w + 2) * cp + min(rows, 2) * (w // stride) * cp
                + c * f + 9 * c + c + f)


def choose_blocks(shape, f: int, stride: int) -> dict:
    """Output rows a CTA (``block_rows``) for an (B, H, W, C) input, from
    the shape only: the fewest (the least halo read twice, the fewest
    steps a CTA) whose grid puts at most ``DSF_SM_CTAS`` CTAs on an SM,
    all resident at once, so every CTA's input is in flight from the
    start.  A CTA's row step is latency-bound alone and the SM's issue
    rate bound past two CTAs: at stem.ds0 a step takes ~1.0 µs with one
    CTA an SM, ~1.4 with two, ~1.9 with three and ~2.5 with four
    (``chip_smoke.py``'s ``[dsconv sweep]``, which times the candidates).
    Where no band fits that (a large batch), the fewest rows an SM
    streams in turn, waves x rows."""
    B, H, W, C = shape
    ho = H // stride
    best = None
    for rows in range(1, ho + 1):
        smem = dsconv_smem_bytes(W, C, f, stride, rows)
        if smem > SMEM_LIMIT:
            break
        ctas = B * -(-ho // rows)
        # an SM holds SMEM_PER_SM over (smem + 1 KB reserved a CTA)
        per_sm = min(DSF_SM_CTAS, SMEM_PER_SM // (smem + 1024))
        waves = -(-ctas // (N_SM * per_sm))
        if waves == 1:
            return {"block_rows": rows}
        if best is None or waves * rows < best[0]:
            best = (waves * rows, rows)
    return {"block_rows": best[1] if best else 1}


def dsconv_fused(x, dw_w, dw_b, pw_w, pw_b, *, stride: int = 1,
                 act: bool = True, block_rows: int | None = None):
    """x: (B, H, W, C); dw_w: (3, 3, C); pw_w: (C, F) -> (B, Ho, Wo, F),
    any C and F; ``block_rows`` (the output rows a CTA) defaults to
    ``choose_blocks``'s."""
    B, H, W, C = x.shape
    F = pw_w.shape[1]
    if H % stride or W % stride:
        raise ValueError(f"spatial {H}x{W} not divisible by stride {stride}")
    if x.device.type == "cpu":
        return dsconv_ref(x, dw_w, dw_b, pw_w, pw_b, stride=stride, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"dsconv_fused runs on cuda or cpu, not {x.device}")
    for t, name, shape in ((x, "x", (B, H, W, C)), (dw_w, "dw_w", (3, 3, C)),
                           (dw_b, "dw_b", (C,)), (pw_w, "pw_w", (C, F)),
                           (pw_b, "pw_b", (F,))):
        check_input(t, name, shape, x.device)
    rows = block_rows or choose_blocks(x.shape, F, stride)["block_rows"]
    if dsconv_smem_bytes(W, C, F, stride, rows) > SMEM_LIMIT:
        raise ValueError(f"dsconv_fused: band of {rows} rows does not fit "
                         f"in {SMEM_LIMIT} B of shared memory")
    out = torch.empty((B, H // stride, W // stride, F), dtype=torch.float32,
                      device=x.device)
    lib = library("dsconv")
    fn = lib.dsconv_fused_f32
    fn.argtypes = [_P] * 6 + [_I] * 8 + [_P]
    fn.restype = _I
    status = fn(x.data_ptr(), dw_w.data_ptr(), dw_b.data_ptr(),
                pw_w.data_ptr(), pw_b.data_ptr(), out.data_ptr(), B, H, W, C,
                F, stride, int(act), rows, stream_of(x))
    check(lib, status, "dsconv_fused")
    dsconv_fused.launches += 1
    return out


dsconv_fused.launches = 0


def _int8_inputs(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b):
    """Validate the inputs of the int8 variants for the CUDA path ->
    the per-image (B,) x_scale."""
    B, H, W, C = x_q.shape
    F = pw_q.shape[1]
    xs = xs_per_batch_vec(x_scale, B).contiguous()
    i8, f32 = torch.int8, torch.float32
    for t, name, shape, dt in (
            (x_q, "x_q", (B, H, W, C), i8), (xs, "x_scale", (B,), f32),
            (dw_q, "dw_q", (3, 3, C), i8), (dw_s, "dw_s", (C,), f32),
            (dw_b, "dw_b", (C,), f32), (pw_q, "pw_q", (C, F), i8),
            (pw_s, "pw_s", (F,), f32), (pw_b, "pw_b", (F,), f32)):
        check_input(t, name, shape, x_q.device, dt)
    return xs


def _check_int8_call(name, x_q, stride):
    H, W = x_q.shape[1:3]
    if H % stride or W % stride:
        raise ValueError(f"spatial {H}x{W} not divisible by stride {stride}")
    if x_q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {x_q.device}")


def dsconv_int8_cluster_smem(h: int, w: int, c: int, f: int, stride: int,
                             ranks: int, emit: bool = False) -> int:
    """One rank's shared memory in ``dsconv_fused_int8``'s cluster kernel
    (mirrors ``ds_layout`` in ``csrc/dsconv_int8.cu``), for bands of
    ceil(ho / ranks) output rows: the band's input rows and halo with a
    zero pixel at both ends of each, later the requantized codes (pixels
    padded to 16, rows of c bytes, or c + 16 where c / 16 is even), the
    fp32 DW band, the 1x1 weights as they arrive and transposed, the DW
    taps, the four per-channel scale and bias arrays and 64 reduction
    words.  ``emit``: ``dsconv_fused_int8_emit``'s form, whose fp32 band
    region later holds the band's outputs (max(c, f) floats a pixel) and
    which takes 64 more reduction words (the output's absmax)."""
    up16 = lambda n: -(-n // 16) * 16
    ho, wo = h // stride, w // stride
    rows = -(-ho // ranks)
    qp = c if c // 16 % 2 else c + 16
    xin = ((rows - 1) * stride + 3) * (w + 2) * c
    return (up16(max(xin, up16(rows * wo) * qp))
            + 4 * rows * wo * (max(c, f) if emit else c)
            + up16(c * f) + f * qp + up16(9 * c) + 8 * (c + f)
            + (512 if emit else 256))


def dsconv_int8_ranks(h: int, w: int, c: int, f: int, stride: int,
                      emit: bool = False) -> tuple:
    """Cluster sizes the cluster kernel (``emit``: its emitting form)
    takes for this map: c a multiple of 16, f of 8, at most one rank per
    output row, each rank's CTA within ``SMEM_LIMIT``."""
    if c % 16 or f % 8:
        return ()
    return tuple(r for r in range(1, min(MAX_RANKS, h // stride) + 1)
                 if dsconv_int8_cluster_smem(h, w, c, f, stride, r, emit)
                 <= SMEM_LIMIT)


def dsconv_int8_path(h: int, w: int, c: int, f: int, stride: int,
                     emit: bool = False) -> dict:
    """``dsconv_fused_int8``'s path (``emit``: ``dsconv_fused_int8_emit``'s)
    for an (h, w, c) map of any batch: ``{"path": "cluster", "ranks": r,
    "smem": bytes}`` at the most ranks the map takes (the least shared
    memory a rank, the most SMs an image); else ``{"path": "passes",
    "ranks": 0, "smem": bytes}``.  By shape only, never a retry after a
    refused launch.  ``chip_smoke.py``'s ``[dsconv_int8 sweep]`` times
    every legal rank count and the passes."""
    return dict(zip(("path", "ranks", "smem"),
                    _int8_path(h, w, c, f, stride, emit)))


@functools.lru_cache(maxsize=None)
def _int8_path(h, w, c, f, stride, emit) -> tuple:
    ranks = dsconv_int8_ranks(h, w, c, f, stride, emit)
    if ranks:
        r = max(ranks)
        return ("cluster", r,
                dsconv_int8_cluster_smem(h, w, c, f, stride, r, emit))
    return "passes", 0, INT8_GEMM_SMEM_BYTES


def _ranks_of(choice, path, ranks):
    """(path, ranks) of a call: ``choice`` (the path rule's), or a path
    and rank count forced (the tests and the sweep)."""
    path = path or choice["path"]
    if path == "cluster":
        return path, ranks or choice["ranks"] or MAX_RANKS
    if path == "passes":
        return path, 0
    raise ValueError(f"dsconv_int8 path {path!r}")


def _dsconv_int8(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b, stride,
                 act, path=None, ranks=None):
    """Validate, choose the path (``dsconv_int8_path``, or ``path`` /
    ``ranks`` forced, for the tests and the sweep) and launch
    ``dsconv_fused_int8_i8``; the passes need a zeroed absmax word per
    image."""
    xs = _int8_inputs(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b)
    B, H, W, C = x_q.shape
    F = pw_q.shape[1]
    path, ranks = _ranks_of(dsconv_int8_path(H, W, C, F, stride), path,
                            ranks)
    amax = (torch.zeros((B,), dtype=torch.int32, device=x_q.device)
            if path == "passes" else None)
    out = torch.empty((B, H // stride, W // stride, F), dtype=torch.float32,
                      device=x_q.device)
    lib = library("dsconv_int8")
    fn = lib.dsconv_fused_int8_i8
    fn.argtypes = [_P] * 10 + [_I] * 8 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), xs.data_ptr(), dw_q.data_ptr(),
                dw_s.data_ptr(), dw_b.data_ptr(), pw_q.data_ptr(),
                pw_s.data_ptr(), pw_b.data_ptr(),
                None if amax is None else amax.data_ptr(), out.data_ptr(),
                B, H, W, C, F, stride, int(act), ranks, stream_of(x_q))
    check(lib, status, "dsconv_fused_int8")
    return out


def dsconv_fused_int8(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b, *,
                      stride: int = 1, act: bool = True):
    """x_q: (B, H, W, C) int8 with per-tensor or per-image (B,)
    ``x_scale``; dw_q: (3, 3, C) int8; pw_q: (C, F) int8; per-channel
    fp32 weight scales and BN-folded biases -> (B, Ho, Wo, F) fp32.
    One cluster launch where ``dsconv_int8_path`` allows (stem.ds0 of B1
    at 192-384 px), else two launches and a zero fill
    (``csrc/dsconv_int8.cu``)."""
    args = (x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b)
    _check_int8_call("dsconv_fused_int8", x_q, stride)
    if x_q.device.type == "cpu":
        return dsconv_int8_ref(*args, stride=stride, act=act)
    out = _dsconv_int8(*args, stride, act)
    dsconv_fused_int8.launches += 1
    return out


def _dsconv_int8_emit(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b,
                      stride, act, keep_fp, path=None, ranks=None):
    """Validate, choose the path (``dsconv_int8_path(..., emit=True)``, or
    ``path`` / ``ranks`` forced, for the tests) and launch
    ``dsconv_fused_int8_emit_i8``.  The cluster kernel writes the fp32 map
    only under ``keep_fp``; the passes need it (as scratch) and two absmax
    words per image, which they zero themselves."""
    xs = _int8_inputs(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b)
    B, H, W, C = x_q.shape
    F = pw_q.shape[1]
    dev = x_q.device
    path, ranks = _ranks_of(dsconv_int8_path(H, W, C, F, stride, emit=True),
                            path, ranks)
    shape = (B, H // stride, W // stride, F)
    amax = (torch.empty((2, B), dtype=torch.int32, device=dev)
            if path == "passes" else None)
    out = (torch.empty(shape, dtype=torch.float32, device=dev)
           if keep_fp or path == "passes" else None)
    q = torch.empty(shape, dtype=torch.int8, device=dev)
    scales = torch.empty((B,), dtype=torch.float32, device=dev)
    lib = library("dsconv_int8")
    fn = lib.dsconv_fused_int8_emit_i8
    fn.argtypes = [_P] * 12 + [_I] * 8 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), xs.data_ptr(), dw_q.data_ptr(),
                dw_s.data_ptr(), dw_b.data_ptr(), pw_q.data_ptr(),
                pw_s.data_ptr(), pw_b.data_ptr(),
                None if amax is None else amax.data_ptr(),
                None if out is None else out.data_ptr(), q.data_ptr(),
                scales.data_ptr(), B, H, W, C, F, stride, int(act), ranks,
                stream_of(x_q))
    check(lib, status, "dsconv_fused_int8_emit")
    return (q, scales, out) if keep_fp else (q, scales)


def dsconv_fused_int8_emit(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b,
                           *, stride: int = 1, act: bool = True,
                           keep_fp: bool = False):
    """``dsconv_fused_int8`` + the per-image act-quant of its full-c_out
    output -> (q (B, Ho, Wo, F) int8, scales (B,) fp32), plus the fp32
    output (``dsconv_fused_int8``'s, bit for bit) when ``keep_fp``.  One
    cluster launch where ``dsconv_int8_path(..., emit=True)`` allows
    (``stem.ds0`` of B1 at 192-384 px), else a memset and three launches
    (``csrc/dsconv_int8.cu``)."""
    args = (x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b)
    _check_int8_call("dsconv_fused_int8_emit", x_q, stride)
    if x_q.device.type == "cpu":
        return dsconv_int8_emit_ref(*args, stride=stride, act=act,
                                    keep_fp=keep_fp)
    outs = _dsconv_int8_emit(*args, stride, act, keep_fp)
    dsconv_fused_int8_emit.launches += 1
    return outs


dsconv_fused_int8.launches = 0
dsconv_fused_int8_emit.launches = 0
