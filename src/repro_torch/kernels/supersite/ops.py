"""Wrappers and registry impls for the super-site chain kernels.

``supersite_apply(params, x, supersite, blocks)`` runs an fp chain banded
over output rows; ``supersite_apply_int8`` runs the FIX8 chain whole-map
per image.  Both draw their weights from the residency cache
(``pack.get_pack``): packed once per (param tree, precision, chain) and
shared by every resolution bucket and executor.

The planner-facing half is host arithmetic over ``Site`` shapes, so
``core.fusion.plan_program``'s grouping pass can decide before any
params exist whether a chain fits one CTA's shared memory
(``SMEM_LIMIT``): fp by choosing a band height and a channel chunk
(``choose_blocks``), int8 by the largest CTA of its members' launches
(``int8_smem_bytes``), whatever the map (the chain runs whole-map through
device scratch; tiling the requants would change the numerics).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, act_fp, quantize_act
from repro_torch.kernels.autotune import (
    autotune, backend_tag, bench_randn, fault_point, on_card, shape_key,
    tile_work)
from repro_torch.kernels.int8_matmul.kernel import INT8_GEMM_SMEM_BYTES
from repro_torch.kernels.mbconv.kernel import mbconv_int8_pass_smem
from repro_torch.kernels.mbconv_fp import BLOCK_M
from repro_torch.kernels.registry import (
    N_SM, SMEM_LIMIT, KernelBase, register)
from repro_torch.kernels.supersite.kernel import (
    MemberGeom, SupersiteGeom, band_geometry, supersite_fused,
    supersite_fused_int8, supersite_smem_floats)
from repro_torch.kernels.supersite.pack import get_pack

__all__ = ["fp_windows", "make_fp_geom", "make_int8_geom", "int8_smem_bytes",
           "supersite_smem_bytes", "choose_blocks", "candidate_blocks",
           "tune_blocks", "random_fp_pack", "TUNE_TOP_K",
           "supersite_apply", "supersite_apply_int8", "SupersiteKernel",
           "SupersiteInt8Kernel"]

def _member_specs(supersite, fp_offsets=None, q_offsets=None):
    """Base ``MemberGeom`` per member (windows unfilled)."""
    k = len(supersite.sites)
    fp_offsets = fp_offsets or ((),) * k
    q_offsets = q_offsets or ((),) * k
    out = []
    for site, fo, qo in zip(supersite.sites, fp_offsets, q_offsets):
        _, h, w, c = site.in_shape
        out.append(MemberGeom(site.kind, site.stride, site.residual,
                              h, w, c, site.attrs.get("mid", 0),
                              site.out_shape[-1], fp_offs=fo, q_offs=qo))
    return tuple(out)


def fp_windows(supersite, block_rows: int):
    """(n_bands, members with their band windows) of the fp chain."""
    return band_geometry(_member_specs(supersite), block_rows,
                         supersite.out_shape[1])


def make_fp_geom(supersite, pack, block_rows: int,
                 block_m: int) -> SupersiteGeom:
    _, ho, wo, f = supersite.out_shape
    n_bands, members = band_geometry(
        _member_specs(supersite, pack.fp_offsets, pack.q_offsets),
        block_rows, ho)
    return SupersiteGeom(members, ho, wo, f, block_rows, n_bands, block_m)


def make_int8_geom(supersite, pack) -> SupersiteGeom:
    _, ho, wo, f = supersite.out_shape
    return SupersiteGeom(
        _member_specs(supersite, pack.fp_offsets, pack.q_offsets),
        ho, wo, f)


# ---------------------------------------------------------------------------
# the Hopper fit models (planner-facing, no params required)
# ---------------------------------------------------------------------------

def supersite_smem_bytes(supersite, block_rows: int, block_m: int) -> int:
    """One CTA of the fp chain kernel with bands of ``block_rows`` output
    rows and DW-stage chunks of ``block_m`` channels."""
    _, members = fp_windows(supersite, block_rows)
    return 4 * supersite_smem_floats(members, block_m)


def int8_smem_bytes(supersite) -> int:
    """The largest CTA of the FIX8 chain's launches: an MBConv member's
    passes (``mbconv_int8_pass_smem``; every member takes them, the
    cluster kernel lost to them where a member's image fits it), a DSConv
    member's GEMM tile."""
    return max(INT8_GEMM_SMEM_BYTES if m.kind != "mbconv" else
               mbconv_int8_pass_smem(m.h_in, m.w_in, m.c_in, m.mid, m.f_out,
                                     m.stride)
               for m in _member_specs(supersite))


def choose_blocks(supersite) -> dict | None:
    """Band height and DW-stage chunk of the fp chain, or None when no
    band fits (JAX's ``choose_block_rows`` against its VMEM budget).

    The band is the smallest height that needs no more CTAs than the card
    has SMs, and the DW-stage chunk the largest of ``BLOCK_M`` whose CTA
    fits ``SMEM_LIMIT`` at that height; the band halves until one does.
    Larger chunks beat a second CTA per SM, and a band that fills the
    card about once beats smaller bands' halo recompute (the ``[band
    sweep]`` of ``chip_smoke.py``).  Deterministic, no device sweep; the
    band follows the batch.
    """
    B, _, _, _ = supersite.in_shape
    _, ho, _, _ = supersite.out_shape
    rows = max(1, min(ho, -(-B * ho // N_SM)))
    while True:
        for bm in BLOCK_M:
            if supersite_smem_bytes(supersite, rows, bm) <= SMEM_LIMIT:
                return {"block_rows": rows, "block_m": bm}
        if rows == 1:
            return None
        rows //= 2


# Candidates the autotuner times per fp chain, ``choose_blocks``' first.
TUNE_TOP_K = 6


def candidate_blocks(supersite) -> tuple:
    """The (band height, DW-stage chunk) pairs the autotuner times for an
    fp chain: ``choose_blocks``' pick, then the same, twice and half its
    band with every chunk of ``BLOCK_M``, where one CTA fits; at most
    ``TUNE_TOP_K``.  Empty when no band fits (the chain is not
    grouped)."""
    pick = choose_blocks(supersite)
    if pick is None:
        return ()
    _, ho, _, _ = supersite.out_shape
    out = [pick]
    r = pick["block_rows"]
    for rows in (r, 2 * r, r // 2):
        for bm in BLOCK_M:
            c = {"block_rows": rows, "block_m": bm}
            if 1 <= rows <= ho and c not in out and len(out) < TUNE_TOP_K \
                    and supersite_smem_bytes(supersite, rows, bm) \
                    <= SMEM_LIMIT:
                out.append(c)
    return tuple(out)


def random_fp_pack(supersite, device):
    """A resident pack of the chain's layout holding random weights (from
    ``kernels.autotune``'s seed), for timing blocks without params."""
    from repro_torch.kernels.supersite.pack import WeightPack
    shapes, counts = [], []
    for site in supersite.sites:
        _, _, _, c = site.in_shape
        f = site.out_shape[-1]
        if site.kind == "mbconv":
            m = site.attrs["mid"]
            member = ((c, m), (m,), (3, 3, m), (m,), (m, f), (f,))
            scales = (c ** -0.5, 1.0, 1 / 3, 1.0, m ** -0.5, 1.0)
        else:
            member = ((3, 3, c), (c,), (c, f), (f,))
            scales = (1 / 3, 1.0, c ** -0.5, 1.0)
        shapes += list(zip(member, scales))
        counts.append(len(member))
    ts = bench_randn(device, *(s for s, _ in shapes),
                     scales=tuple(sc for _, sc in shapes))
    offs, n = [], 0
    for t in ts:
        offs.append(n)
        n += t.numel()
    flat = torch.cat([t.reshape(-1) for t in ts]).reshape(1, n)
    fp_offs, i = [], 0
    for c in counts:
        fp_offs.append(tuple(offs[i:i + c]))
        i += c
    return WeightPack(flat, None, tuple(fp_offs),
                      ((),) * len(counts), 4 * n)


def tune_blocks(supersite, *, allow_sweep: bool = True, device=None):
    """Blocks of an fp chain: the cached or swept choice among
    ``candidate_blocks``, timed on ``supersite_fused`` with random
    inputs and weights of the chain's shapes.  ``allow_sweep=False``
    gives ``choose_blocks``' pick without reading the cache; off the card,
    the cached choice or the pick.  None when no band fits."""
    cands = candidate_blocks(supersite)
    if not cands:
        return None
    B, H, W, C = supersite.in_shape
    dims = ";".join(f"{s.kind}:{s.in_shape[-1]}>{s.attrs.get('mid', 0)}>"
                    f"{s.out_shape[-1]}/{s.stride}{'r' if s.residual else ''}"
                    for s in supersite.sites)
    key = shape_key(batch=B, spatial=(H, W), chain=dims, dtype="f32",
                    backend=backend_tag(device))
    if not allow_sweep:
        fault_point("supersite", key)
        return dict(cands[0])
    bench = None
    if on_card(device):
        pack = random_fp_pack(supersite, device)
        (x,) = bench_randn(device, tuple(supersite.in_shape))

        def bench(cand):
            geom = make_fp_geom(supersite, pack, cand["block_rows"],
                                cand["block_m"])
            return supersite_fused(x, pack.fp, geom=geom)
    return autotune("supersite", key, cands, bench)


# ---------------------------------------------------------------------------
# apply wrappers
# ---------------------------------------------------------------------------

def supersite_apply(params, x, supersite, blocks=None, *, epilogue=None):
    """fp chain.  ``params`` is the ROOT param tree (members resolve their
    subtrees through ``Site.param_path``).  ``epilogue`` is accepted for
    interface parity and ignored: fp producers never emit int8."""
    x = act_fp(x)
    pack, _ = get_pack(params, supersite, "fp")
    blocks = dict(blocks or {}) or choose_blocks(supersite)
    if not blocks:
        raise ValueError(f"super-site {supersite.name} fits no band height; "
                         f"the planner should not have grouped it")
    geom = make_fp_geom(supersite, pack, blocks["block_rows"],
                        blocks["block_m"])
    return supersite_fused(x.float().contiguous(), pack.fp,
                           geom=geom).to(x.dtype)


def supersite_apply_int8(params, x, supersite, *, epilogue=None):
    """FIX8 chain.  ``x`` is a producer's ``QTensor`` or an fp activation
    (quantized here per image, as the per-site consumers do).  The exit
    follows the last member's epilogue: an int8 emission returns a
    ``QTensor`` (fp alongside when the residual policy keeps it);
    otherwise the fp32 output."""
    pack, _ = get_pack(params, supersite, "int8")
    geom = make_int8_geom(supersite, pack)
    first_residual = supersite.sites[0].residual
    if isinstance(x, QTensor):
        x_q, x_scale, x_fp = x.q, x.scale, x.fp
        out_dtype = x.fp.dtype if x.fp is not None else torch.float32
    else:
        qt = quantize_act(x, keep_fp=first_residual)
        x_q, x_scale, x_fp = qt.q, qt.scale, qt.fp
        out_dtype = x.dtype
    exit_emit = epilogue is not None and epilogue.emits_q
    keep_fp = exit_emit and epilogue.residual != "none"
    outs = supersite_fused_int8(
        x_q.contiguous(), x_scale, pack.q, pack.fp,
        geom=geom,
        x_fp=x_fp.float().contiguous() if first_residual else None,
        exit_emit=exit_emit, keep_fp=keep_fp)
    if exit_emit:
        fp = outs[2].to(out_dtype) if keep_fp else None
        return QTensor(outs[0], outs[1], fp)
    return outs.to(out_dtype)


# ---------------------------------------------------------------------------
# registry impls (consumed by core.fusion.plan_program / core.program)
# ---------------------------------------------------------------------------

@register
class SupersiteKernel(KernelBase):
    """(supersite, fp): the banded chain kernel.  ``site`` throughout is a
    ``core.program.SuperSite``."""
    kind, precision, dtype = "supersite", "fp", "f32"

    def smem_bytes(self, site, blocks):
        return supersite_smem_bytes(site, blocks["block_rows"],
                                    blocks["block_m"])

    def tune(self, site, *, autotune=True, device=None):
        """Band height and chunk, or None when no band fits."""
        return tune_blocks(site, allow_sweep=autotune, device=device)

    def candidates(self, site):
        return candidate_blocks(site)

    def block_work(self, site, blocks):
        return tile_work(site.out_shape[1], blocks["block_rows"])

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        blocks = getattr(decision, "blocks", None) or {}
        return supersite_apply(params, x, site, blocks, epilogue=epilogue)


@register
class SupersiteInt8Kernel(SupersiteKernel):
    """(supersite, int8): the FIX8 chain, whole-map per image, bit-exact
    against the ungrouped int8 sites."""
    precision, dtype = "int8", "i8"
    takes_q = True
    emits_q = True

    def smem_bytes(self, site, blocks):
        return int8_smem_bytes(site)

    def tune(self, site, *, autotune=True, device=None):
        return {}

    def candidates(self, site):
        return ()

    def block_work(self, site, blocks):
        return 1.0

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        return supersite_apply_int8(params, x, site, epilogue=epilogue)
