"""``ssd_chunked``: the hand-written CUDA kernel (``csrc/ssd.cu``).

Replaces ``repro/kernels/ssd/kernel.py::ssd_chunked_pallas``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.ssd_chunked_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.registry import SCAN_TILE, column_split
from repro_torch.kernels.ssd.ref import ssd_chunked_ref

__all__ = ["ssd_chunked", "ssd_smem_bytes"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def ssd_smem_bytes(n: int, pe: int, chunk: int) -> int:
    """One CTA's shared memory (mirrors ``ssd_smem_bytes`` in the CUDA
    source): the n x pe state slice, the chunk's cumsum, dt and decays,
    a Cm and a Bm tile at an odd pitch, an x tile and the score tile."""
    t = SCAN_TILE
    return 4 * (n * pe + 3 * chunk + 2 * t * (n + 1) + t * pe + t * (t + 1))


def ssd_chunked(x, dt, dA, Bm, Cm, *, chunk: int = 256):
    """x: (BH, S, P); dt, dA: (BH, S); Bm, Cm: (BH, S, N), fp32 -> y (BH,
    S, P) fp32, in chunks of ``min(chunk, S)`` tokens; a ragged S runs as
    if zero-padded with dt = dA = 0 (the TPU kernel instead takes the
    whole sequence as one chunk).  One launch: a CTA per (row, slice of
    head-dim columns) runs the row's chunks in order."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, dt, dA, Bm, Cm, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked runs on cuda or cpu, not {x.device}")
    BH, S, P = x.shape
    N = Bm.shape[-1]
    for t, name, shape in ((x, "x", (BH, S, P)), (dt, "dt", (BH, S)),
                           (dA, "dA", (BH, S)), (Bm, "Bm", (BH, S, N)),
                           (Cm, "Cm", (BH, S, N))):
        check_input(t, name, shape, x.device)
    C = min(chunk, S)
    pe = column_split(BH, P, C * C * N / 2, C * C / 2 + 2 * C * N,
                      lambda w: ssd_smem_bytes(N, w, C))
    y = torch.empty((BH, S, P), dtype=torch.float32, device=x.device)
    lib = library("ssd")
    fn = lib.ssd_chunked_f32
    fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    fn.restype = _I
    status = fn(x.data_ptr(), dt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), BH, S, P, N, C, pe, stream_of(x))
    check(lib, status, "ssd_chunked")
    ssd_chunked.launches += 1
    return y


ssd_chunked.launches = 0
