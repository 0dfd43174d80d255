"""Single-load weight residency: pack a super-site's weights ONCE.

Counterpart of ``repro/kernels/supersite/pack.py``.  All member weights of
a ``core.program.SuperSite`` are flattened into one block on the param
tree's device: a single fp32 vector for the fp chain; an int8 vector and
an fp32 scale/bias vector for the FIX8 chain.  The layout and the
per-kind order are JAX's, so the offsets agree.  The chain kernels read
the block from device memory (through L2) at those offsets.

The cache keys on the param tree's identity, precision and member names,
so every resolution bucket and executor of one served model shares one
pack (``pack_stats`` counts builds and hits).  An entry holds a reference
to its tree: an ``id`` is reused once its object is freed, and a new tree
must never be handed a pack built from an old one.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.program import params_at
from repro_torch.core.quantization import fold_bn_into_conv

__all__ = ["WeightPack", "pack_weights", "get_pack", "pack_stats",
           "reset_pack_stats", "clear_pack_cache"]


class WeightPack(NamedTuple):
    """One super-site's resident weights.

    ``fp``: (1, Nf) fp32, weights and biases of an fp chain, scales and
    biases of an int8 chain.  ``q``: (1, Nq) int8 weights (int8 chains
    only).  ``fp_offsets``/``q_offsets``: per-member tuples of flat
    offsets in the per-kind order the kernels unpack (mbconv fp: w1, b1,
    dw, dwb, w2, b2; dsconv fp: dw, dwb, pw, pwb; int8 q: mbconv w1, dw,
    w2 / dsconv dw, pw; int8 fp: mbconv s1, b1, dws, dwb, s2, b2 / dsconv
    dws, dwb, pws, pwb).  ``nbytes``: the bytes of loading it once.
    """
    fp: torch.Tensor
    q: Optional[torch.Tensor]
    fp_offsets: Tuple[Tuple[int, ...], ...]
    q_offsets: Tuple[Tuple[int, ...], ...]
    nbytes: int


def _member_fp_tensors(p, kind):
    """Folded fp tensors of one member, in kernel unpack order."""
    if kind == "mbconv":
        w1_4, b1 = fold_bn_into_conv(p["pw1"]["conv"], p["pw1"]["bn"])
        dw_4, dwb = fold_bn_into_conv(p["dw"]["conv"], p["dw"]["bn"])
        w2_4, b2 = fold_bn_into_conv(p["pw2"]["conv"], p["pw2"]["bn"])
        return (w1_4[0, 0], b1, dw_4[:, :, 0, :], dwb, w2_4[0, 0], b2)
    dw_4, dwb = fold_bn_into_conv(p["dw"]["conv"], p["dw"]["bn"])
    pw_4, pwb = fold_bn_into_conv(p["pw"]["conv"], p["pw"]["bn"])
    return (dw_4[:, :, 0, :], dwb, pw_4[0, 0], pwb)


def _member_int8_tensors(p, kind):
    """(int8 weight tensors, fp scale/bias tensors) of one member."""
    if kind == "mbconv":
        q1, qd, q2 = p["pw1"]["qconv"], p["dw"]["qconv"], p["pw2"]["qconv"]
        qs = (q1["q"][0, 0], qd["q"][:, :, 0, :], q2["q"][0, 0])
        fs = (q1["scale"], q1["bias"], qd["scale"], qd["bias"],
              q2["scale"], q2["bias"])
        return qs, fs
    qd, qp = p["dw"]["qconv"], p["pw"]["qconv"]
    qs = (qd["q"][:, :, 0, :], qp["q"][0, 0])
    fs = (qd["scale"], qd["bias"], qp["scale"], qp["bias"])
    return qs, fs


def _flatten(tensors, dtype):
    """Concatenate flattened tensors -> ((1, N) tensor, offsets)."""
    offs, n = [], 0
    for t in tensors:
        offs.append(n)
        n += t.numel()
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    return flat.reshape(1, n), tuple(offs)


def _split(offs, counts):
    out, i = [], 0
    for c in counts:
        out.append(tuple(offs[i:i + c]))
        i += c
    return tuple(out)


def pack_weights(params, supersite, precision: str) -> WeightPack:
    """Pack every member's weights into the resident block(s)."""
    fp_all, q_all, fp_counts, q_counts = [], [], [], []
    for site in supersite.sites:
        p = params_at(params, site.param_path)
        if precision == "int8":
            qs, fs = _member_int8_tensors(p, site.kind)
        else:
            qs, fs = (), _member_fp_tensors(p, site.kind)
        fp_all.extend(fs)
        q_all.extend(qs)
        fp_counts.append(len(fs))
        q_counts.append(len(qs))
    fp_flat, fp_offs = _flatten(fp_all, torch.float32)
    q_flat, q_offs = (_flatten(q_all, torch.int8) if q_all else (None, ()))
    nbytes = fp_flat.numel() * 4 + (q_flat.numel() if q_flat is not None
                                    else 0)
    return WeightPack(fp_flat, q_flat, _split(fp_offs, fp_counts),
                      _split(q_offs, q_counts), nbytes)


# ---------------------------------------------------------------------------
# the residency cache: one pack per (param tree, precision, member chain)
# ---------------------------------------------------------------------------

_PACKS: dict = {}       # key -> (param tree, pack)
_STATS = {"built": 0, "hits": 0}


def get_pack(params, supersite, precision: str):
    """Resident pack for this (param tree, precision, member chain), built
    once and shared by every caller holding the same tree.  Returns
    ``(pack, hit)``; ``hit`` says the weights were already resident."""
    key = (id(params), precision, supersite.members)
    entry = _PACKS.get(key)
    if entry is not None and entry[0] is params:
        _STATS["hits"] += 1
        return entry[1], True
    pack = pack_weights(params, supersite, precision)
    _PACKS[key] = (params, pack)
    _STATS["built"] += 1
    return pack, False


def pack_stats() -> dict:
    """Copy of the residency counters ({'built', 'hits'})."""
    return dict(_STATS)


def reset_pack_stats() -> None:
    _STATS["built"] = 0
    _STATS["hits"] = 0


def clear_pack_cache() -> None:
    """Drop every resident pack (tests, model swap)."""
    _PACKS.clear()
