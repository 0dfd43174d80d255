"""Python mirror of ``csrc/mbconv_fp.cuh``, the tiled fp32 stages that
``csrc/mbconv.cu`` and ``csrc/supersite.cu`` share: the CTA and K-tile
constants, the GEMM tile widths and the shared-memory staging sizes,
under the header's names where it has them.  The two kernels'
shared-memory models (``kernels/mbconv/kernel.py``,
``kernels/supersite/kernel.py``) build on them.
"""
from __future__ import annotations

__all__ = ["NT", "KT", "STAGES", "BLOCK_M", "round4", "tile_bn", "tile_bm",
           "pw2_bn", "rows_stage_floats", "kmajor_stage_floats"]

NT, KT = 256, 16            # threads of a CTA, K-tile depth
STAGES = 3                  # K tiles in flight
BLOCK_M = (128, 64, 32, 16)  # the GEMM tile widths: mid-channel chunks


def round4(n: int) -> int:
    return (n + 3) & ~3


def tile_bn(n: int) -> int:
    """GEMM tile width for ``n`` columns: 16, 32, 64 or 128."""
    return 128 if n > 64 else 64 if n > 32 else 32 if n > 16 else 16


def tile_bm(bn: int) -> int:
    """Rows of a macro tile of width ``bn``."""
    return 4 * (NT // (bn // 4))


def pw2_bn(p: int, f: int) -> int:
    """PW2's tile width for ``p`` output pixels and ``f`` channels: the
    one of 16, 32, 64, 128 whose macro tiles cover p x f with the fewest
    padded outputs, the wider on a tie."""
    best = cost = None
    for bn in (16, 32, 64, 128):
        if bn > 16 and bn // 2 >= f:
            break
        bm = tile_bm(bn)
        c = -(-p // bm) * bm * (-(-f // bn) * bn)
        if cost is None or c <= cost:
            best, cost = bn, c
    return best


def rows_stage_floats(bn: int) -> int:
    """Shared floats of ``gemm_rows``' staging: STAGES x (A [BM][KT + 4],
    B [KT][BN])."""
    return STAGES * (tile_bm(bn) * (KT + 4) + KT * bn)


def kmajor_stage_floats(bn: int) -> int:
    """Shared floats of ``gemm_kmajor``'s staging: STAGES x B [KT][BN]."""
    return STAGES * KT * bn
