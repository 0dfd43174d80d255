"""``int8_matmul`` and ``int8_matmul_emit``: the hand-written CUDA
kernels (``csrc/int8_matmul.cu``).

Replace ``repro/kernels/int8_matmul/kernel.py::int8_matmul`` and
``::int8_matmul_emit``.  A CUDA tensor launches the kernel (or raises); a
CPU tensor takes the plain version in ``ref``.  ``int8_matmul`` runs on
int8 tensor cores over the tile that ``int8_gemm_plan`` picks;
``int8_matmul_emit`` runs the same tile, one thread-block cluster per
row group, over the tiles that ``int8_emit_plan`` picks.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.int8_matmul.ref import (
    int8_matmul_emit_ref, int8_matmul_ref)
from repro_torch.kernels.quant import xs_per_batch_vec
from repro_torch.kernels.registry import (
    CLUSTERS, N_SM, SMEM_2_PER_SM, SMEM_LIMIT)

__all__ = ["int8_matmul", "int8_matmul_emit", "INT8_GEMM_SMEM_BYTES",
           "int8_gemm_smem", "gemm_cells", "gemm_ctas", "int8_gemm_plan",
           "int8_emit_smem", "emit_cells", "int8_emit_plan"]

# Static shared memory of one CTA of every __dp4a GEMM pass (``int8.cuh``:
# the DSConv passes, the two-launch group_agg_int8): two 64 x 36 int8
# operand tiles and the absmax reduction's 32 floats.
INT8_GEMM_SMEM_BYTES = 2 * 64 * 36 + 4 * 32

KB = 64                       # K bytes per fragment block of the MMA tile
KC = 512                      # K bytes of one staged chunk (``KC``)
TILE_M = (16, 32, 64, 128)    # rows of an output tile
TILE_N = (32, 64, 128)        # columns of an output tile
# One CTA's time, fitted to chip_smoke.py's [int8_matmul sweep] (the four
# MSA projections of B1@224, batch 1 and 8; arbitrary units): a fixed
# latency, a cost per byte of the weight panel (staged, then transposed in
# shared memory; the x panel's cost did not register) and per output
# element of the tile; a grid of more CTAs than SMs runs up to GEMM_CROWD
# slower (two CTAs share an SM).  The pick is the sweep's fastest cell at
# every swept shape.
GEMM_T0 = 1000.0
GEMM_PER_B_BYTE = 0.1
GEMM_PER_OUT = 0.1
GEMM_CROWD = 0.4

_P = ctypes.c_void_p
_I = ctypes.c_int


def _kblocks(k: int) -> int:
    return -(-k // KB)


def _pitch(k: int) -> int:
    """Row pitch of an int8 operand panel of k bytes of K (``panel_pitch``
    in ``int8_mma.cuh``): a multiple of 64 that is 64 (mod 128)."""
    p = _kblocks(k) * KB
    return p if p % 128 else p + KB


def int8_gemm_smem(k: int, bm: int, bn: int) -> int:
    """One CTA's shared memory (mirrors ``mm_layout`` in
    ``csrc/int8_matmul.cu``), for a chunk of kc = min(k, ``KC``) bytes of
    K in one stage (k <= ``KC``) or two (the ring): per stage the A panel
    [bm] and the weights' raw rows [kc][bn]; the transposed B panel [bn];
    the int32 sums [bm][bn + 8] and the tile's fp32 scales."""
    kc = min(_kblocks(k) * KB, KC)
    stages = 2 if k > KC else 1
    return stages * (bm * _pitch(kc) + kc * bn) + bn * _pitch(kc) \
        + 4 * bm * (bn + 8) + 4 * (bm + bn)


def gemm_ctas(m: int, n: int, bm: int, bn: int) -> int:
    return -(-m // bm) * -(-n // bn)


def gemm_cells(m: int, n: int, k: int) -> tuple:
    """Every legal (bm, bn): the CTA fits ``SMEM_LIMIT`` (16 x 32 always
    does), and no tile is more than twice the matrix's extent (16 rows
    and 32 columns are always legal)."""
    return tuple(
        (bm, bn) for bm in TILE_M for bn in TILE_N
        if (bm == TILE_M[0] or bm < 2 * m) and (bn == TILE_N[0] or bn < 2 * n)
        and int8_gemm_smem(k, bm, bn) <= SMEM_LIMIT)


def _gemm_cost(m: int, n: int, k: int, bm: int, bn: int) -> float:
    """Modelled time of one launch: waves of CTAs over the card (one or
    two a SM as shared memory allows) x one CTA's time, crowded when the
    grid has more CTAs than SMs."""
    ctas = gemm_ctas(m, n, bm, bn)
    per_sm = 2 if int8_gemm_smem(k, bm, bn) <= SMEM_2_PER_SM else 1
    waves = -(-ctas // (N_SM * per_sm))
    cta = (GEMM_T0 + GEMM_PER_B_BYTE * bn * _kblocks(k) * KB
           + GEMM_PER_OUT * bm * bn)
    crowd = 1.0 + GEMM_CROWD * min(1.0, max(0, ctas - N_SM) / N_SM)
    return waves * cta * crowd


def int8_gemm_plan(m: int, n: int, k: int) -> dict:
    """Tile of the W8A8 GEMM for (m, k) @ (k, n): ``{"bm", "bn",
    "smem"}``.  The least ``_gemm_cost`` among ``gemm_cells`` (the fewer
    CTAs on a tie); where the output alone has ``N_SM // 2`` tiles of 16
    x 32, only among grids of at least that many CTAs.  Filling all
    ``N_SM`` SMs does not pay at the served shapes: a CTA's latency, not
    the card's throughput, sets the time.  Deterministic, no device
    sweep; ``chip_smoke.py``'s ``[int8_matmul sweep]`` times every cell
    at the served shapes and prints the pick's time over the fastest."""
    return dict(_plan(m, n, k))


@functools.lru_cache(maxsize=None)
def _plan(m: int, n: int, k: int) -> tuple:
    cells = gemm_cells(m, n, k)
    if -(-m // TILE_M[0]) * -(-n // TILE_N[0]) >= N_SM // 2:
        cells = tuple(c for c in cells if gemm_ctas(m, n, *c) >= N_SM // 2)
    bm, bn = min(cells, key=lambda c: (_gemm_cost(m, n, k, *c),
                                       gemm_ctas(m, n, *c)))
    return (("bm", bm), ("bn", bn), ("smem", int8_gemm_smem(k, bm, bn)))


def _int8_matmul(x_q, w_q, xs, w_scale, plan=None):
    """Validate and launch ``int8_matmul_i8`` with ``plan`` (``bm``,
    ``bn``; by default ``int8_gemm_plan``, forced by the tests
    and the sweep)."""
    M, K = x_q.shape
    N = w_q.shape[1]
    for t, name, shape, dt in ((x_q, "x_q", (M, K), torch.int8),
                               (w_q, "w_q", (K, N), torch.int8),
                               (xs, "x_scale", (M,), torch.float32),
                               (w_scale, "w_scale", (N,), torch.float32)):
        check_input(t, name, shape, x_q.device, dt)
    plan = plan or int8_gemm_plan(M, N, K)
    out = torch.empty((M, N), dtype=torch.float32, device=x_q.device)
    lib = library("int8_matmul")
    fn = lib.int8_matmul_i8
    fn.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(),
                w_scale.data_ptr(), out.data_ptr(), M, N, K, plan["bm"],
                plan["bn"], stream_of(x_q))
    check(lib, status, "int8_matmul")
    return out


def int8_matmul(x_q, w_q, x_scale, w_scale):
    """x_q: (M, K) int8; w_q: (K, N) int8; x_scale: a per-tensor scalar
    or per-row (M,) scales; w_scale: (N,) -> (M, N) fp32
    ``(acc * x_scale[row]) * w_scale[col]``.  One CUDA launch."""
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
    if min(M, N, K) < 1:
        raise ValueError(f"int8_matmul of an empty shape {(M, K, N)}")
    out = _int8_matmul(x_q, w_q, xs_per_batch_vec(x_scale, M).contiguous(),
                       w_scale)
    int8_matmul.launches += 1
    return out


int8_matmul.launches = 0


# int8_matmul_emit's cluster path: a row group's tiles are the ranks of
# one cluster.  One rank's time in µs, fitted to chip_smoke.py's
# [int8_emit sweep] (the four MSA projections of B1@224 at batch 1, every
# cell): a fixed latency (launch, staging, barriers), a cost per byte of
# the tile's x rows and, larger, of its weight panel (staged, then
# transposed in shared memory), and per output element the tile holds
# (the epilogue, absmax and division-rounded quantize).  A grid of more
# clusters than the card holds one CTA an SM at once runs EMIT_CROWD
# slower (two CTAs share an SM; batch 8's sweep).  The pick is within
# 2.5 % of the sweep's fastest cluster cell at all eight shapes.
EMIT_MAX_RANKS = 16
EMIT_T0 = 4.93
EMIT_PER_X_BYTE = 4.94e-5
EMIT_PER_W_BYTE = 7.81e-5
EMIT_PER_OUT = 5.20e-4
EMIT_CROWD = 0.2


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def int8_emit_smem(k: int, bm: int, bn: int) -> int:
    """One CTA of ``int8_emit_gemm`` (mirrors ``em_layout`` in
    ``csrc/int8_matmul.cu``): ``int8_gemm_smem``'s regions, then the
    tile's bias [bn] and 64 reduction words."""
    return int8_gemm_smem(k, bm, bn) + 4 * bn + 4 * 64


def emit_tiles(rows: int, n: int, bm: int, bn: int) -> int:
    """Tiles of one row group: ceil(rows / bm) x ceil(n / bn)."""
    return -(-rows // bm) * -(-n // bn)


def emit_cells(rows: int, n: int, k: int) -> tuple:
    """Every (bm, bn) of the cluster path for groups of ``rows`` rows of
    an (., k) @ (k, n) GEMM: bm the rows of 1-16 equal row tiles and bn
    the columns of 1-16 equal column tiles, each rounded up to 16; at
    most ``EMIT_MAX_RANKS`` tiles a group, each CTA within
    ``SMEM_LIMIT``."""
    bms = sorted({_up16(-(-rows // r)) for r in range(1, EMIT_MAX_RANKS + 1)})
    bns = sorted({_up16(-(-n // r)) for r in range(1, EMIT_MAX_RANKS + 1)})
    return tuple((bm, bn) for bm in bms for bn in bns
                 if emit_tiles(rows, n, bm, bn) <= EMIT_MAX_RANKS
                 and int8_emit_smem(k, bm, bn) <= SMEM_LIMIT)


def _clusters_at_once(ranks: int, per_sm: int) -> int:
    """Clusters of ``ranks`` CTAs the card holds at once with ``per_sm``
    CTAs an SM (``CLUSTERS``, at the next power of two)."""
    return CLUSTERS[per_sm][1 << (ranks - 1).bit_length()]


def _emit_cost(groups: int, rows: int, n: int, k: int, bm: int,
               bn: int) -> float:
    """Modelled µs of a cluster launch: waves of clusters x one rank's
    time, crowded past one CTA an SM."""
    ranks = emit_tiles(rows, n, bm, bn)
    per_sm = 2 if int8_emit_smem(k, bm, bn) <= SMEM_2_PER_SM else 1
    waves = -(-groups // _clusters_at_once(ranks, per_sm))
    crowd = 1.0 + EMIT_CROWD * (groups > _clusters_at_once(ranks, 1))
    kb, m = _kblocks(k) * KB, min(bm, rows)
    return waves * crowd * (EMIT_T0 + EMIT_PER_X_BYTE * kb * m
                            + EMIT_PER_W_BYTE * kb * bn
                            + EMIT_PER_OUT * m * bn)


def int8_emit_plan(m: int, n: int, k: int, rows: int) -> dict:
    """Path and tile of ``int8_matmul_emit`` for (m, k) @ (k, n) in groups
    of ``rows`` rows: ``{"path", "bm", "bn", "tiles", "ranks", "smem"}``.
    ``"cluster"`` where a group's tiles fit one cluster (``emit_cells``):
    the least ``_emit_cost``, the more ranks on a tie; ``ranks`` is the
    group's tiles.  Else ``"grid"`` (``ranks`` 0): ``int8_gemm_plan``'s
    tile (16 x 32 where that CTA would not fit) over each group.
    Deterministic, by shape only; ``chip_smoke.py``'s ``[int8_emit
    sweep]`` times every cell at the library's shapes."""
    return dict(_emit_plan(m, n, k, rows))


@functools.lru_cache(maxsize=None)
def _emit_plan(m: int, n: int, k: int, rows: int) -> tuple:
    groups = m // rows
    cells = emit_cells(rows, n, k)
    if cells:
        bm, bn = min(cells, key=lambda c: (
            _emit_cost(groups, rows, n, k, *c),
            -emit_tiles(rows, n, *c)))
        path = "cluster"
    else:
        plan = int8_gemm_plan(m, n, k)
        bm, bn = plan["bm"], plan["bn"]
        if int8_emit_smem(k, bm, bn) > SMEM_LIMIT:
            bm, bn = TILE_M[0], TILE_N[0]
        path = "grid"
    tiles = emit_tiles(rows, n, bm, bn)
    return (("path", path), ("bm", bm), ("bn", bn), ("tiles", tiles),
            ("ranks", tiles if path == "cluster" else 0),
            ("smem", int8_emit_smem(k, bm, bn)))


def _int8_matmul_emit(x_q, w_q, xs, w_scale, bias, rows: int,
                      keep_fp: bool, plan=None):
    """Validate and launch ``int8_matmul_emit_i8`` with ``plan`` (``path``,
    ``bm``, ``bn``; by default ``int8_emit_plan``, forced by the tests and
    the sweep).  ``xs``: (G,), contiguous or a broadcast scalar (stride
    0); ``bias``: (N,) or None."""
    M, K = x_q.shape
    N = w_q.shape[1]
    G = M // rows
    dev = x_q.device
    for t, name, shape, dt in ((x_q, "x_q", (M, K), torch.int8),
                               (w_q, "w_q", (K, N), torch.int8),
                               (w_scale, "w_scale", (N,), torch.float32)) \
            + (() if bias is None else
               ((bias, "bias", (N,), torch.float32),)):
        check_input(t, name, shape, dev, dt)
    if xs.device != dev or xs.dtype != torch.float32 or \
            tuple(xs.shape) != (G,) or xs.stride(0) not in (0, 1):
        raise ValueError(f"x_scale must be ({G},) fp32 on {dev}, "
                         f"contiguous or one broadcast scale")
    plan = plan or int8_emit_plan(M, N, K, rows)
    cluster = plan["path"] == "cluster"
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty((M, N), **f32) if keep_fp or not cluster else None
    tiles = emit_tiles(rows, N, plan["bm"], plan["bn"])
    tmax = None if cluster else torch.empty((G, tiles), **f32)
    q = torch.empty((M, N), dtype=torch.int8, device=dev)
    scales = torch.empty((G,), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = library("int8_matmul")
    fn = lib.int8_matmul_emit_i8
    fn.argtypes = [_P] * 3 + [_I] + [_P] * 6 + [_I] * 7 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), w_q.data_ptr(), xs.data_ptr(),
                xs.stride(0) if G > 1 else 0, w_scale.data_ptr(), ptr(bias),
                ptr(out), ptr(tmax), q.data_ptr(), scales.data_ptr(), M, N,
                K, rows, plan["bm"], plan["bn"], int(cluster),
                stream_of(x_q))
    check(lib, status, "int8_matmul_emit")
    return (q, scales, out) if keep_fp else (q, scales)


def int8_matmul_emit(x_q, w_q, x_scale, w_scale, *, rows_per_group: int,
                     bias=None, keep_fp: bool = False):
    """W8A8 GEMM with the producer-side act-quant epilogue.  x_q: (M, K)
    int8, M a multiple of ``rows_per_group``; x_scale: a scalar or one
    scale per row group; w_q: (K, N) int8; w_scale, bias: (N,) ->
    (q (M, N) int8, scales (M // rows_per_group,) fp32), plus the fp32
    output ``(acc * xs) * ws + bias`` when ``keep_fp``.  One CUDA launch
    where a group's tiles fit a cluster (``int8_emit_plan``), else two."""
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
    if min(M, N, K) < 1:
        raise ValueError(f"int8_matmul_emit of an empty shape {(M, K, N)}")
    xs = xs_per_batch_vec(x_scale, M // rows_per_group)
    if xs.stride(0) not in (0, 1):
        xs = xs.contiguous()
    out = _int8_matmul_emit(x_q, w_q, xs, w_scale, bias, rows_per_group,
                            keep_fp)
    int8_matmul_emit.launches += 1
    return out


int8_matmul_emit.launches = 0
