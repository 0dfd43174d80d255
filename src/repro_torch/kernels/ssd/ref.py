"""Plain PyTorch versions of the Mamba-2 SSD scan.

``ssd_recurrent_ref`` is the per-step recurrence (JAX's
``repro/kernels/ssd/ref.py::ssd_recurrent_ref``), an oracle for small
sequences.  ``ssd_scan_ref`` is the CPU path of ``kernel.ssd_chunked``
and its yardstick on the card, in the kernel's stages (each chunk's
state, the decayed exclusive prefix over chunks, the outputs);
``ssd_chunked_ref`` runs in the TPU kernel's chunk order
(``repro/kernels/ssd/kernel.py::_ssd_kernel``), an oracle.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ssd_recurrent_ref", "ssd_chunked_ref", "ssd_scan_ref"]


def ssd_recurrent_ref(x, dt, A, B, C, D_skip=None):
    """x: (b, s, h, p); dt: (b, s, h); A: (h,) negative; B, C: (b, s, g,
    n), h % g == 0 -> (y (b, s, h, p) fp32, final state (b, h, p, n)
    fp32)::

        state_t = exp(dt_t A) state_{t-1} + dt_t x_t B_t^T
        y_t     = C_t . state_t  (+ D x_t)
    """
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    xf, dtf = x.float(), dt.float()
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    state = torch.zeros((b, h, p, B.shape[3]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * A.float()[None, :])        # (b, h)
        state = (state * decay[..., None, None]
                 + torch.einsum("bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t],
                                Bh[:, t]))
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    if D_skip is not None:
        y = y + D_skip.float()[None, None, :, None] * xf
    return y, state


def ssd_chunked_ref(x, dt, dA, Bm, Cm, *, chunk: int = 256):
    """x: (BH, S, P); dt, dA: (BH, S); Bm, Cm: (BH, S, N) -> y (BH, S, P)
    fp32.  Chunks of ``min(chunk, S)`` tokens; a ragged S is zero-padded
    (dt = dA = 0 adds nothing to any output) and sliced.  Per chunk: L =
    exp(min(cumsum(dA)_l - cumsum(dA)_s, 0) tril) tril; y = ((C B^T) L)
    (x dt) + (C exp(cumsum dA)) state; state = (B exp(cum[-1] - cum)
    dt)^T x + exp(cum[-1]) state."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Cn = min(chunk, S)
    pad = -S % Cn
    xf = F.pad(x.float(), (0, 0, 0, pad))
    dtf = F.pad(dt.float(), (0, pad))
    dAf = F.pad(dA.float(), (0, pad))
    Bf = F.pad(Bm.float(), (0, 0, 0, pad))
    Cf = F.pad(Cm.float(), (0, 0, 0, pad))
    tril = torch.ones((Cn, Cn), dtype=torch.float32, device=x.device).tril()
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    y = torch.empty((BH, S + pad, P), dtype=torch.float32, device=x.device)
    for c0 in range(0, S + pad, Cn):
        sl = slice(c0, c0 + Cn)
        xc, dtc, Bc, Cc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl]
        cum = torch.cumsum(dAf[:, sl], dim=-1)                    # (BH, C)
        seg = cum[:, :, None] - cum[:, None, :]
        L = torch.exp(torch.clamp(seg, max=0.0) * tril) * tril
        scores = (Cc @ Bc.transpose(1, 2)) * L
        yc = scores @ (xc * dtc[:, :, None])
        yc = yc + (Cc * torch.exp(cum)[:, :, None]) @ state
        y[:, sl] = yc
        w = (torch.exp(cum[:, -1:] - cum) * dtc)[:, :, None]      # (BH, C, 1)
        new = (Bc * w).transpose(1, 2) @ xc                       # (BH, N, P)
        state = new + torch.exp(cum[:, -1])[:, None, None] * state
    return y[:, :S]


def ssd_scan_ref(x, dt, dA, Bm, Cm, *, chunk: int = 256):
    """x: (BH, S, P); dt, dA: (BH, S); Bm, Cm: (BH, S, N) -> y (BH, S, P)
    fp32, in chunks of ``min(chunk, S)`` (a ragged S zero-padded: dt = dA
    = 0 adds nothing), in the stages of the CUDA kernel's chunk-parallel
    scan, with cum the in-chunk cumsum of dA:

    1. each chunk's own state ``dS_c = (Bm_c w_c)^T x_c``, ``w_c =
       exp(cum_last - cum) dt``, and its total decay ``a_c =
       exp(cum_last)``;
    2. the decayed exclusive prefix over chunks: the state entering chunk
       c, ``S_0 = 0``, ``S_{c+1} = dS_c + a_c S_c``;
    3. per chunk ``L = exp(min(cum_l - cum_s, 0) tril) tril`` and ``y =
       ((Cm Bm^T) L) (x dt) + (Cm exp(cum)) S_c``."""
    BH, S, P = x.shape
    N = Bm.shape[-1]
    Cn = min(chunk, S)
    pad = -S % Cn
    nc = (S + pad) // Cn

    def chunks(t):
        t = F.pad(t.float(), (0, 0, 0, pad) if t.dim() == 3 else (0, pad))
        return t.reshape((BH, nc, Cn) + t.shape[2:])
    xf, dtf, dAf, Bf, Cf = map(chunks, (x, dt, dA, Bm, Cm))
    cum = torch.cumsum(dAf, dim=-1)                           # (BH, nc, C)
    w = torch.exp(cum[..., -1:] - cum) * dtf
    dS = (Bf * w[..., None]).transpose(-1, -2) @ xf           # (BH, nc, N, P)
    a = torch.exp(cum[..., -1])                               # (BH, nc)
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    S_in = torch.empty_like(dS)
    for c in range(nc):
        S_in[:, c] = state
        state = dS[:, c] + a[:, c, None, None] * state
    tril = torch.ones((Cn, Cn), dtype=torch.float32, device=x.device).tril()
    seg = cum[..., :, None] - cum[..., None, :]
    L = torch.exp(torch.clamp(seg, max=0.0) * tril) * tril
    y = ((Cf @ Bf.transpose(-1, -2)) * L) @ (xf * dtf[..., None])
    y = y + (Cf * torch.exp(cum)[..., None]) @ S_in
    return y.reshape(BH, nc * Cn, P)[:, :S]
