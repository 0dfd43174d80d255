"""Plain PyTorch versions of the super-site chain kernels (fp32
``supersite_fused`` and FIX8 ``supersite_fused_int8``).

Both run the chain member by member over the whole map with the port's
plain per-site versions (``kernels/mbconv/ref.py``, ``kernels/dsconv/
ref.py``) on weights taken from the pack, as JAX's ``_fp_member`` /
``_int8_member`` take them from the resident block.  The fp32 chain adds
each residual member's input to its output.  The FIX8 chain follows
``_supersite_int8_kernel``: a residual member's output joins the kept fp
input (``cur_fp + out``), and every boundary but an fp32 exit requantizes
per image.  The CPU path of ``kernel.supersite_fused*`` and their
yardstick on the card.
"""
from __future__ import annotations

import math

from repro_torch.kernels.dsconv.ref import dsconv_int8_ref, dsconv_ref
from repro_torch.kernels.mbconv.ref import mbconv_int8_ref, mbconv_ref

__all__ = ["member_weights", "supersite_ref", "supersite_int8_ref"]


def _take(flat, off: int, shape):
    """A view of ``shape`` at flat offset ``off`` of a (1, N) pack."""
    return flat[0, off:off + math.prod(shape)].reshape(shape)


def member_weights(m, fp_flat, q_flat=None):
    """One member's tensors from the pack, in the kernels' order:
    fp32 mbconv (w1, b1, dw, dwb, w2, b2) / dsconv (dw, dwb, pw, pwb);
    int8 mbconv (w1_q, s1, b1, dw_q, dws, dwb, w2_q, s2, b2) / dsconv
    (dw_q, dws, dwb, pw_q, pws, pwb), the argument order of the per-site
    int8 plain versions after the input."""
    C, F = m.c_in, m.f_out
    fo, qo = m.fp_offs, m.q_offs
    if q_flat is None:
        if m.kind == "mbconv":
            M = m.mid
            shapes = ((C, M), (M,), (3, 3, M), (M,), (M, F), (F,))
        else:
            shapes = ((3, 3, C), (C,), (C, F), (F,))
        return tuple(_take(fp_flat, o, s) for o, s in zip(fo, shapes))
    if m.kind == "mbconv":
        M = m.mid
        q1, qd, q2 = (_take(q_flat, o, s) for o, s in
                      zip(qo, ((C, M), (3, 3, M), (M, F))))
        s1, b1, dws, dwb, s2, b2 = (_take(fp_flat, o, (n,)) for o, n in
                                    zip(fo, (M, M, M, M, F, F)))
        return (q1, s1, b1, qd, dws, dwb, q2, s2, b2)
    qd, qp = (_take(q_flat, o, s) for o, s in zip(qo, ((3, 3, C), (C, F))))
    dws, dwb, pws, pwb = (_take(fp_flat, o, (n,)) for o, n in
                          zip(fo, (C, C, F, F)))
    return (qd, dws, dwb, qp, pws, pwb)


def supersite_ref(x, w_flat, *, geom):
    """x: (B, H, W, C) -> (B, H_out, W_out, F_out) fp32."""
    y = x.float()
    for m in geom.members:
        w = member_weights(m, w_flat)
        if m.kind == "mbconv":
            out = mbconv_ref(y, *w, stride=m.stride)
        else:
            out = dsconv_ref(y, *w, stride=m.stride)
        y = y + out if m.residual else out
    return y


def supersite_int8_ref(x_q, x_scale, wq_flat, wf_flat, *, geom, x_fp=None,
                       exit_emit: bool = False):
    """-> ``(q, scales, fp)`` when ``exit_emit``, else the fp32 output."""
    from repro_torch.core.quantization import quantize_act

    cur_q, cur_s, cur_fp = x_q, x_scale, x_fp
    last = len(geom.members) - 1
    for k, m in enumerate(geom.members):
        w = member_weights(m, wf_flat, wq_flat)
        if m.kind == "mbconv":
            out = mbconv_int8_ref(cur_q, cur_s, *w, stride=m.stride)
        else:
            out = dsconv_int8_ref(cur_q, cur_s, *w, stride=m.stride)
        cur_fp = cur_fp + out if m.residual else out
        if k < last or exit_emit:
            qt = quantize_act(cur_fp)
            cur_q, cur_s = qt.q, qt.scale
    return (cur_q, cur_s, cur_fp) if exit_emit else cur_fp
