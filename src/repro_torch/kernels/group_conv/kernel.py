"""``group_agg_int8``: the hand-written CUDA kernel (``csrc/group_agg.cu``).

Replaces ``repro/kernels/group_conv/kernel.py::group_agg_int8``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.group_agg_int8_ref``.  The kernel takes the grouped (d, C)
weights; the plain version multiplies by their dense block-diagonal
form, as the JAX kernel does.  ``group_agg_path`` chooses between the
cluster kernel (one launch, the grouped 1x1 on int8 tensor cores) and
the two-launch kernel, by shape only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.group_conv.ref import block_diag, group_agg_int8_ref
from repro_torch.kernels.int8_matmul.kernel import INT8_GEMM_SMEM_BYTES
from repro_torch.kernels.quant import xs_per_batch_vec
from repro_torch.kernels.registry import SMEM_LIMIT

__all__ = ["group_agg_int8", "group_agg_ranks", "group_agg_cluster_smem",
           "group_agg_path"]

RANKS = (1, 2, 3, 4, 6, 8, 12, 16)   # cluster sizes (above 8 non-portable)

_P = ctypes.c_void_p
_I = ctypes.c_int


def group_agg_ranks(c: int, d: int) -> tuple:
    """Cluster sizes whose ranks hold whole groups of ``d`` channels (the
    cluster kernel needs d a multiple of 16)."""
    if d % 16 or c % d:
        return ()
    return tuple(r for r in RANKS if (c // d) % r == 0)


def group_agg_cluster_smem(h: int, w: int, c: int, d: int, s: int,
                           ranks: int) -> int:
    """One rank's shared memory in the cluster kernel (mirrors
    ``ga_layout`` in ``csrc/group_agg.cu``): the channels' DW planes (a
    zero ring, rows of 4 * ((w - 1) // 4) + 16 bytes, an odd number of
    words a plane), later the requantized codes (rows padded to 16 at a
    pitch of cs or cs + 16), the fp32 DW slice, the 1x1 weights
    transposed and as they arrive, the DW taps as they arrive and as
    __dp4a words, four per-channel scale and bias arrays and 64
    reduction words."""
    cs = c // ranks
    qp = cs if cs // 16 % 2 else cs + 16
    up16 = lambda n: -(-n // 16) * 16
    plane = (h + s - 1) * (4 * ((w - 1) // 4) + 16)
    plane += 0 if plane // 4 % 2 else 4
    return (up16(max(up16(h * w) * qp, cs * plane)) + 4 * h * w * cs
            + 2 * cs * d + up16(s * s * cs) + 4 * s * ((s + 3) // 4) * cs
            + 16 * cs + 256)


def group_agg_path(h: int, w: int, c: int, d: int, s: int = 5) -> dict:
    """The aggregation branch's path for an (h, w, c) map of any batch:
    ``{"path": "cluster", "ranks": r, "smem": bytes}`` at the most ranks
    that hold whole groups (the least shared memory a rank, the most SMs
    an image) where that rank's CTA fits ``SMEM_LIMIT``; else ``{"path":
    "two-launch", "ranks": 0, "smem": bytes}``.  By shape only, never a
    retry after a refused launch.  ``chip_smoke.py``'s ``[group_agg
    sweep]`` times every legal rank count and the two launches.  The
    cluster kernel takes S in 1, 3, 5, 7."""
    return dict(zip(("path", "ranks", "smem"),
                    _path(h, w, c, d, s)))


@functools.lru_cache(maxsize=None)
def _path(h, w, c, d, s) -> tuple:
    ranks = group_agg_ranks(c, d)
    if ranks and s in (1, 3, 5, 7):
        r = max(ranks)
        smem = group_agg_cluster_smem(h, w, c, d, s, r)
        if smem <= SMEM_LIMIT:
            return "cluster", r, smem
    return "two-launch", 0, INT8_GEMM_SMEM_BYTES


def _group_agg(x_q, xs, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b, path=None,
               ranks=None):
    """Validate, choose the path (``group_agg_path``, or ``path`` /
    ``ranks`` forced, for the tests and the sweep) and launch
    ``group_agg_int8_i8``; the two launches need a zeroed absmax word per
    image."""
    B, H, W, C = x_q.shape
    s, d = dw_q.shape[0], pw_q.shape[0]
    i8, f32 = torch.int8, torch.float32
    for t, name, shape, dt in (
            (x_q, "x_q", (B, H, W, C), i8), (xs, "x_scale", (B,), f32),
            (dw_q, "dw_q", (s, s, C), i8), (dw_s, "dw_s", (C,), f32),
            (dw_b, "dw_b", (C,), f32), (pw_q, "pw_q", (d, C), i8),
            (pw_s, "pw_s", (C,), f32), (pw_b, "pw_b", (C,), f32)):
        check_input(t, name, shape, x_q.device, dt)
    choice = group_agg_path(H, W, C, d, s)
    path = path or choice["path"]
    if path == "cluster":
        ranks = ranks or choice["ranks"] or max(group_agg_ranks(C, d))
        amax = None
    elif path == "two-launch":
        if C % d or 64 % d:
            raise ValueError(f"group size {d} must divide {C} and 64")
        ranks = 0
        amax = torch.zeros((B,), dtype=torch.int32, device=x_q.device)
    else:
        raise ValueError(f"group_agg path {path!r}")
    out = torch.empty((B, H, W, C), dtype=f32, device=x_q.device)
    lib = library("group_agg")
    fn = lib.group_agg_int8_i8
    fn.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    fn.restype = _I
    status = fn(x_q.data_ptr(), xs.data_ptr(), dw_q.data_ptr(),
                dw_s.data_ptr(), dw_b.data_ptr(), pw_q.data_ptr(),
                pw_s.data_ptr(), pw_b.data_ptr(),
                None if amax is None else amax.data_ptr(), out.data_ptr(),
                B, H, W, C, s, d, ranks, stream_of(x_q))
    check(lib, status, "group_agg_int8")
    return out


def group_agg_int8(x_q, x_scale, dw_q, dw_s, dw_b, pw_q, pw_s, pw_b):
    """One fused MSA aggregation branch.  x_q: (B, H, W, C) int8 QKV with
    per-tensor or per-image (B,) ``x_scale``; dw_q: (S, S, C) int8 (S
    odd); pw_q: (d, C) int8 grouped 1x1 weights (C // d groups); per-
    channel fp32 scales and biases -> (B, H, W, C) fp32.  One cluster
    launch where ``group_agg_path`` allows (every B1 shape at 192-384
    px), else two launches and a zero fill."""
    B, H, W, C = x_q.shape
    s = dw_q.shape[0]
    if s % 2 == 0:
        raise ValueError(f"aggregation scale must be odd, got {s}")
    if x_q.device.type == "cpu":
        return group_agg_int8_ref(x_q, x_scale, dw_q, dw_s, dw_b,
                                  block_diag(pw_q), pw_s, pw_b)
    if x_q.device.type != "cuda":
        raise ValueError(f"group_agg_int8 runs on cuda or cpu, not "
                         f"{x_q.device}")
    out = _group_agg(x_q, xs_per_batch_vec(x_scale, B).contiguous(), dw_q,
                     dw_s, dw_b, pw_q, pw_s, pw_b)
    group_agg_int8.launches += 1
    return out


group_agg_int8.launches = 0
