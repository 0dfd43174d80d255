"""``ssd_chunked``: the hand-written CUDA kernel (``csrc/ssd.cu``).

Replaces ``repro/kernels/ssd/kernel.py::ssd_chunked_pallas``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor takes the plain
version ``ref.ssd_scan_ref``; a meta tensor launches nothing: the
output and the workspace are allocated on meta and the kernel's work
(``ssd_cost``) goes to ``registry.note_meta_cost`` (the dry-run's
counters).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.registry import (
    SCAN_MAX_WIDTH, SCAN_SCORE_PITCH, SCAN_TILE, SMEM_LIMIT, causal_ops,
    note_meta_cost, scan_pitch)
from repro_torch.kernels.ssd.ref import ssd_scan_ref

__all__ = ["ssd_chunked", "ssd_smem_bytes", "ssd_plan", "ssd_cost"]

_P = ctypes.c_void_p
_I = ctypes.c_int


def ssd_smem_bytes(n: int, p: int, chunk: int) -> dict:
    """One CTA's shared memory in each launch of the scan (mirrors
    ``ssd_states_smem`` / ``ssd_out_smem`` in the CUDA source), with G =
    ceil(p / 64) column groups: ``states``, the chunk's cumsum and
    weights, a Bm tile of the state's 64 rows and an x tile; ``out``, the
    chunk's cumsum and dt, the Cm and Bm tiles at ``scan_pitch(n)``, an x
    (or state) tile and the score tile."""
    t, g, c4 = SCAN_TILE, -(-p // 64), -(-chunk // 4) * 4
    return {"states": 4 * (2 * c4 + t * t + t * 64 * g),
            "out": 4 * (2 * c4 + 2 * t * scan_pitch(n) + t * 64 * g
                        + t * SCAN_SCORE_PITCH)}


def ssd_plan(bh: int, s: int, p: int, n: int, chunk: int = 256) -> dict:
    """How ``ssd_chunked`` runs (BH, S) rows in chunks of ``min(chunk,
    S)``: ``chunks`` per row, CUDA ``launches`` per call (states, prefix,
    outputs; the outputs alone for one chunk), the ``workspace`` bytes (an
    n x p state and a decay per chunk) and ``smem`` (``ssd_smem_bytes``)."""
    C = min(chunk, s)
    nc = -(-s // C)
    return {"chunk": C, "chunks": nc, "launches": 3 if nc > 1 else 1,
            "workspace": 4 * bh * nc * (n * p + 1) if nc > 1 else 0,
            "smem": ssd_smem_bytes(n, p, C)}


def ssd_cost(bh: int, s: int, p: int, n: int, chunk: int = 256) -> dict:
    """The work of one ``ssd_chunked`` call: ``flops``, the products of
    every row's triangle (C.B^T and its product with x), state reads and
    state updates (``registry.causal_ops``); ``bytes``, the fp32 inputs
    read once and the output written once."""
    return {"flops": bh * sum(causal_ops(s, min(chunk, s), n + p, n * p)),
            "bytes": 4 * bh * s * (p + 2 + 2 * n) + 4 * bh * s * p}


def ssd_chunked(x, dt, dA, Bm, Cm, *, chunk: int = 256):
    """x: (BH, S, P); dt, dA: (BH, S); Bm, Cm: (BH, S, N), fp32 -> y (BH,
    S, P) fp32, in chunks of ``min(chunk, S)`` tokens; a ragged S runs as
    if zero-padded with dt = dA = 0 (the TPU kernel instead takes the
    whole sequence as one chunk).  N, P <= 256.  One call, three CUDA
    launches (``csrc/ssd.cu``): each chunk's state and decay, the decayed
    exclusive prefix over chunks, then the outputs of every (chunk, query
    tile), with the workspace (``ssd_plan``) from PyTorch's allocator.
    On the CPU: the same stages in plain PyTorch (``ssd_scan_ref``)."""
    if x.device.type == "cpu":
        return ssd_scan_ref(x, dt, dA, Bm, Cm, chunk=chunk)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"ssd_chunked runs on cuda, cpu or meta, not "
                         f"{x.device}")
    BH, S, P = x.shape
    N = Bm.shape[-1]
    if x.device.type == "meta":     # the card's allocations, no launch
        y = torch.empty((BH, S, P), dtype=torch.float32, device="meta")
        ws = torch.empty(ssd_plan(BH, S, P, N, chunk)["workspace"] // 4,
                         dtype=torch.float32, device="meta")
        cost = ssd_cost(BH, S, P, N, chunk)
        note_meta_cost("ssd_chunked", cost["flops"], cost["bytes"])
        del ws
        return y
    for t, name, shape in ((x, "x", (BH, S, P)), (dt, "dt", (BH, S)),
                           (dA, "dA", (BH, S)), (Bm, "Bm", (BH, S, N)),
                           (Cm, "Cm", (BH, S, N))):
        check_input(t, name, shape, x.device)
    plan = ssd_plan(BH, S, P, N, chunk)
    if not (0 < P <= SCAN_MAX_WIDTH and 0 < N <= SCAN_MAX_WIDTH
            and BH <= 65535) or max(plan["smem"].values()) > SMEM_LIMIT:
        raise ValueError(f"ssd_chunked takes P, N in 1..{SCAN_MAX_WIDTH}, "
                         f"BH <= 65535 and a chunk whose tiles fit in "
                         f"{SMEM_LIMIT} B; got P = {P}, N = {N}, BH = {BH}, "
                         f"chunk = {plan['chunk']}")
    y = torch.empty((BH, S, P), dtype=torch.float32, device=x.device)
    ws = torch.empty(plan["workspace"] // 4, dtype=torch.float32,
                     device=x.device)
    lib = library("ssd")
    fn = lib.ssd_chunked_f32
    fn.argtypes = [_P] * 7 + [_I] * 5 + [_P]
    fn.restype = _I
    status = fn(x.data_ptr(), dt.data_ptr(), dA.data_ptr(), Bm.data_ptr(),
                Cm.data_ptr(), y.data_ptr(), ws.data_ptr(), BH, S, P, N,
                plan["chunk"], stream_of(x))
    check(lib, status, "ssd_chunked")
    ssd_chunked.launches += 1
    return y


ssd_chunked.launches = 0
