"""``supersite_fused`` and ``supersite_fused_int8``: a chain of consecutive
conv sites in one call, the hand-written CUDA kernels
``csrc/supersite.cu`` and ``csrc/supersite_int8.cu``.

Replace the functions of the same names in
``repro/kernels/supersite/kernel.py``.  A CUDA tensor launches the kernel
(or raises); a CPU tensor takes the plain version in ``ref``.

Band geometry (fp).  Member output row ``t`` at stride ``s`` reads input
rows ``s*t + off + {0,1,2}`` with ``off = s - 2``, the reference
forward's SAME anchor ``s - 1``.  Walking the chain backwards from an
output window of ``R`` rows gives each member an affine input window
``start(j) = c0 + c1*j`` of static length ``L = s*(n-1) + 3``; window
rows outside the feature map are zero inside the kernel.  These are JAX's
windows for every MBConv member and every stride-1 DSConv member; JAX
walks a stride-2 DSConv at ``off = -1`` (its anchor 0), which the
reference forward does not use, and no lowered program has one.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels.build import check, check_input, library, stream_of
from repro_torch.kernels.mbconv_fp import (
    BLOCK_M, kmajor_stage_floats, pw2_bn, round4, rows_stage_floats,
    tile_bn)
from repro_torch.kernels.quant import xs_per_batch_vec
from repro_torch.kernels.supersite.ref import (
    supersite_int8_ref, supersite_ref)

__all__ = ["MemberGeom", "SupersiteGeom", "band_geometry",
           "supersite_smem_floats", "supersite_fused", "supersite_fused_int8"]

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_MEMBERS = 8          # SS_MAX_MEMBERS in csrc/supersite.cu


class MemberGeom(NamedTuple):
    """Static geometry + pack offsets of one chain member."""
    kind: str                  # "mbconv" | "dsconv"
    stride: int
    residual: bool
    h_in: int                  # valid (unpadded) input rows
    w_in: int
    c_in: int
    mid: int                   # mbconv expansion width (0 for dsconv)
    f_out: int
    c0: int = 0                # input window start: c0 + c1 * band
    c1: int = 0
    length: int = 0            # input window rows
    n_out: int = 0             # output rows produced per band
    fp_offs: Tuple[int, ...] = ()
    q_offs: Tuple[int, ...] = ()


class SupersiteGeom(NamedTuple):
    """Launch geometry of one super-site."""
    members: Tuple[MemberGeom, ...]
    h_out: int
    w_out: int
    f_out: int
    block_rows: int = 0        # fp band height R (0: whole-map int8)
    n_bands: int = 0
    block_m: int = 0           # fp DW-stage channel chunk


def band_geometry(members: Tuple[MemberGeom, ...], block_rows: int,
                  h_out: int) -> Tuple[int, Tuple[MemberGeom, ...]]:
    """Walk the chain backwards, sizing each member's input window.

    Returns ``(n_bands, members)`` with every member's affine window
    ``(c0, c1, length)`` and per-band output rows ``n_out`` filled in.
    The window covering output rows ``[o0, o0+n)`` at stride ``s`` is
    ``[s*o0 + s - 2, s*o0 + s - 2 + s*(n-1) + 3)``.
    """
    n_bands = -(-h_out // block_rows)
    out = []
    win = (0, block_rows, block_rows)            # (c0, c1, rows)
    for m in reversed(members):
        s = m.stride
        n_out = win[2]
        win = (s * win[0] + s - 2, s * win[1], s * (win[2] - 1) + 3)
        out.append(m._replace(c0=win[0], c1=win[1], length=win[2],
                              n_out=n_out))
    return n_bands, tuple(reversed(out))


def _dw_channels(m: MemberGeom) -> int:
    return m.mid if m.kind == "mbconv" else m.c_in


def _member_block_m(block_m: int, m: MemberGeom) -> int:
    """A member's DW-stage chunk: ``block_m``, or the narrowest GEMM tile
    width (16, 32, 64, 128) that holds all its DW channels if that is
    less."""
    return min(block_m, tile_bn(_dw_channels(m)))


def supersite_smem_floats(members: Tuple[MemberGeom, ...],
                          block_m: int) -> int:
    """One CTA's shared memory in floats (mirrors ``supersite_smem`` in
    ``csrc/supersite.cu``): two band buffers, member k's output in buffer
    k % 2, then the larger of PW1's staging and one chunk's DW result,
    then the larger of one chunk's padded DW window and the projection's
    staging, each sized for its largest member and a multiple of 4.
    ``members`` carry windows."""
    buf = [0, 0]
    xr = yr = 0
    for k, m in enumerate(members):
        p = m.n_out * (m.w_in // m.stride)
        bm = _member_block_m(block_m, m)
        buf[k % 2] = max(buf[k % 2], round4(p * m.f_out))
        xr = max(xr, bm * round4(p))
        if m.kind == "mbconv":
            xr = max(xr, rows_stage_floats(bm))
        yr = max(yr, m.length * (m.w_in + 2) * bm,
                 kmajor_stage_floats(pw2_bn(p, m.f_out)))
    return buf[0] + buf[1] + xr + yr


def _int_array(rows):
    """A host int32 array of the rows, flattened (the C descriptor)."""
    flat = [int(v) for row in rows for v in row]
    return (ctypes.c_int * len(flat))(*flat)


def supersite_fused(x, w_flat, *, geom: SupersiteGeom):
    """Run an fp chain.  x: (B, H, W, C) member-0 input; ``w_flat``: the
    (1, Nf) pack (``pack.pack_weights``); ``geom``: windows filled in
    (``ops.make_fp_geom``).  Returns (B, H_out, W_out, F_out) fp32."""
    B = x.shape[0]
    m0 = geom.members[0]
    if tuple(x.shape[1:]) != (m0.h_in, m0.w_in, m0.c_in):
        raise ValueError(f"x {tuple(x.shape)} is not the chain's input "
                         f"({m0.h_in}, {m0.w_in}, {m0.c_in})")
    if x.device.type == "cpu":
        return supersite_ref(x, w_flat, geom=geom)
    if x.device.type != "cuda":
        raise ValueError(f"supersite_fused runs on cuda or cpu, not "
                         f"{x.device}")
    if not 2 <= len(geom.members) <= MAX_MEMBERS or \
            geom.block_m not in BLOCK_M:
        raise ValueError(f"supersite_fused takes 2..{MAX_MEMBERS} members "
                         f"and a band geometry with block_m in {BLOCK_M}")
    check_input(x, "x", x.shape, x.device)
    check_input(w_flat, "w_flat", w_flat.shape, x.device)
    desc = []
    for m in geom.members:
        offs = tuple(m.fp_offs) + (0,) * (6 - len(m.fp_offs))
        desc.append((0 if m.kind == "mbconv" else 1, m.stride,
                     int(m.residual), m.h_in, m.w_in, m.c_in, m.mid,
                     m.f_out, m.c0, m.c1, m.length, m.n_out,
                     _member_block_m(geom.block_m, m)) + offs)
    out = torch.empty((B, geom.h_out, geom.w_out, geom.f_out),
                      dtype=torch.float32, device=x.device)
    lib = library("supersite")
    fn = lib.supersite_fused_f32
    fn.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    fn.restype = _I
    arr = _int_array(desc)
    status = fn(x.data_ptr(), w_flat.data_ptr(), out.data_ptr(),
                ctypes.addressof(arr), len(desc), B, geom.h_out,
                geom.n_bands, stream_of(x))
    check(lib, status, "supersite_fused")
    supersite_fused.launches += 1
    return out


supersite_fused.launches = 0


def supersite_fused_int8(x_q, x_scale, wq_flat, wf_flat, *,
                         geom: SupersiteGeom, x_fp=None,
                         exit_emit: bool = False, keep_fp: bool = False):
    """Run a FIX8 chain.  x_q: (B, H, W, C) int8 with a per-tensor or
    per-image (B,) ``x_scale``; ``wq_flat``/``wf_flat``: the (1, Nq) int8
    and (1, Nf) fp32 pack halves; ``x_fp``: the entry's kept fp map
    (required iff member 0 is residual).  ``exit_emit`` returns
    ``(q, scales)``, plus the fp map when ``keep_fp``; otherwise the fp32
    output alone.  Every member boundary requantizes per image, so the
    chain equals running its sites one at a time."""
    B = x_q.shape[0]
    m0 = geom.members[0]
    if tuple(x_q.shape[1:]) != (m0.h_in, m0.w_in, m0.c_in):
        raise ValueError(f"x_q {tuple(x_q.shape)} is not the chain's input "
                         f"({m0.h_in}, {m0.w_in}, {m0.c_in})")
    if m0.residual and x_fp is None:
        raise ValueError("member 0 is residual: the chain needs x_fp")
    if x_q.device.type == "cpu":
        out = supersite_int8_ref(x_q, x_scale, wq_flat, wf_flat, geom=geom,
                                 x_fp=x_fp, exit_emit=exit_emit)
        return _exit(out, exit_emit, keep_fp)
    if x_q.device.type != "cuda":
        raise ValueError(f"supersite_fused_int8 runs on cuda or cpu, not "
                         f"{x_q.device}")
    dev, f32 = x_q.device, torch.float32
    xs = xs_per_batch_vec(x_scale, B).contiguous()
    check_input(x_q, "x_q", x_q.shape, dev, torch.int8)
    check_input(xs, "x_scale", (B,), dev)
    check_input(wq_flat, "wq_flat", wq_flat.shape, dev, torch.int8)
    check_input(wf_flat, "wf_flat", wf_flat.shape, dev)
    if m0.residual:
        check_input(x_fp, "x_fp", x_q.shape, dev)
    desc, mid_n, dwo_n, bnd_n = [], 1, 1, 1
    for k, m in enumerate(geom.members):
        ho, wo = m.h_in // m.stride, m.w_in // m.stride
        qo = tuple(m.q_offs) + (0,) * (3 - len(m.q_offs))
        fo = tuple(m.fp_offs) + (0,) * (6 - len(m.fp_offs))
        desc.append((0 if m.kind == "mbconv" else 1, m.stride,
                     int(m.residual), m.h_in, m.w_in, m.c_in, m.mid,
                     m.f_out) + qo + fo)
        if m.kind == "mbconv":
            mid_n = max(mid_n, m.h_in * m.w_in * m.mid)
            dwo_n = max(dwo_n, ho * wo * m.mid)
        if k < len(geom.members) - 1:
            bnd_n = max(bnd_n, ho * wo * m.f_out)
    # one allocation for every fp32 scratch map of the chain
    scratch = torch.empty((B * (mid_n + dwo_n + 2 * bnd_n),), dtype=f32,
                          device=dev)
    mid, dwo, bnd0, bnd1 = torch.split(
        scratch, [B * mid_n, B * dwo_n, B * bnd_n, B * bnd_n])
    out = torch.empty((B, geom.h_out, geom.w_out, geom.f_out), dtype=f32,
                      device=dev)
    amax = torch.empty((3 * len(desc) * B,), dtype=torch.int32, device=dev)
    q = scales = None
    if exit_emit:
        q = torch.empty(out.shape, dtype=torch.int8, device=dev)
        scales = torch.empty((B,), dtype=f32, device=dev)
    lib = library("supersite_int8")
    fn = lib.supersite_fused_int8_i8
    fn.argtypes = [_P] * 14 + [_I] * 2 + [_P]
    fn.restype = _I
    ptr = lambda t: None if t is None else t.data_ptr()
    arr = _int_array(desc)
    status = fn(x_q.data_ptr(), xs.data_ptr(),
                ptr(x_fp) if m0.residual else None, wq_flat.data_ptr(),
                wf_flat.data_ptr(), mid.data_ptr(), dwo.data_ptr(),
                bnd0.data_ptr(), bnd1.data_ptr(), out.data_ptr(),
                amax.data_ptr(), ptr(q), ptr(scales), ctypes.addressof(arr),
                len(desc), B, stream_of(x_q))
    check(lib, status, "supersite_fused_int8")
    supersite_fused_int8.launches += 1
    return _exit((q, scales, out) if exit_emit else out, exit_emit, keep_fp)


supersite_fused_int8.launches = 0


def _exit(out, exit_emit: bool, keep_fp: bool):
    """The chain's exit as the JAX function returns it."""
    if not exit_emit:
        return out
    q, scales, fp = out
    return (q, scales, fp) if keep_fp else (q, scales)
