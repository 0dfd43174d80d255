"""Plain PyTorch versions of the fused ReLU linear attention kernels.

``relu_attn_noncausal_ref`` is the CPU path of
``kernel.relu_attn_noncausal`` and its yardstick on the card; layout
(G, N, heads, d): the JAX kernel's (BH, N, D) rows are the (g, head)
pairs, folded by strides instead of a copy.  ``relu_attn_causal_scan``
is the CPU path and yardstick of ``kernel.relu_attn_causal``, in the
kernel's stages (each chunk's state, the exclusive prefix over chunks,
the outputs); ``relu_attn_causal_chunked`` runs in the TPU kernel's
chunk order and ``relu_attn_causal_ref`` is the O(N^2) masked oracle
(JAX's ``relu_attn_causal_ref``), for small N only: both are oracles.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6


def relu_attn_noncausal_ref(q, k, v, eps: float = EPS, *, out=None):
    """q, k, v: (G, N, h, d) -> (G, N, h, d) fp32.

    out = ReLU(Q) (ReLU(K)^T V) / max(ReLU(Q) . rowsum(ReLU(K)), eps)

    ``out`` (the kernel's destination: (G, N, h, d), or (branches,
    images, N, h, d) with row g = branch * images + image) receives the
    result and is returned."""
    pq = torch.relu(q.float())
    pk = torch.relu(k.float())
    kv = torch.einsum("gnhd,gnhe->ghde", pk, v.float())
    ksum = pk.sum(dim=1)
    num = torch.einsum("gnhd,ghde->gnhe", pq, kv)
    den = torch.einsum("gnhd,ghd->gnh", pq, ksum)[..., None]
    res = num / torch.clamp(den, min=eps)
    if out is None:
        return res
    return out.copy_(res.reshape(out.shape))


def relu_attn_causal_ref(q, k, v, eps: float = EPS):
    """q, k, v: (BH, N, D) -> (BH, N, D) fp32, causal, via the explicit
    O(N^2) masked scores."""
    pq = torch.relu(q.float())
    pk = torch.relu(k.float())
    n = q.shape[1]
    scores = torch.einsum("bnd,bmd->bnm", pq, pk)
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask[None], scores, torch.zeros_like(scores))
    num = torch.einsum("bnm,bme->bne", scores, v.float())
    den = scores.sum(dim=-1, keepdim=True)
    return num / torch.clamp(den, min=eps)


def relu_attn_causal_chunked(q, k, v, *, chunk: int = 256,
                             eps: float = EPS):
    """q, k, v: (BH, N, D) fp32 or bf16 -> (BH, N, D) fp32, causal, in
    the TPU kernel's order: N zero-padded to whole chunks of
    ``min(chunk, N)``; per chunk the tril-masked scores ``ReLU(Q)
    ReLU(K)^T``, ``num = S V``, ``den = rowsum(S)``, plus the prefix
    state ``ReLU(Q) state`` and ``ReLU(Q) . zsum``; ``num / max(den,
    eps)``; then ``state += ReLU(K)^T V``, ``zsum += sum ReLU(K)``."""
    BH, N, D = q.shape
    C = min(chunk, N)
    pad = -N % C
    pq = F.pad(torch.relu(q.float()), (0, 0, 0, pad))
    pk = F.pad(torch.relu(k.float()), (0, 0, 0, pad))
    vf = F.pad(v.float(), (0, 0, 0, pad))
    tril = torch.ones((C, C), dtype=torch.float32, device=q.device).tril()
    state = torch.zeros((BH, D, D), dtype=torch.float32, device=q.device)
    zsum = torch.zeros((BH, 1, D), dtype=torch.float32, device=q.device)
    out = torch.empty((BH, N + pad, D), dtype=torch.float32, device=q.device)
    for c0 in range(0, N + pad, C):
        qc, kc, vc = (t[:, c0:c0 + C] for t in (pq, pk, vf))
        s = (qc @ kc.transpose(1, 2)) * tril
        num = s @ vc
        den = s.sum(dim=-1, keepdim=True)
        num = num + qc @ state
        den = den + qc @ zsum.transpose(1, 2)
        out[:, c0:c0 + C] = num / torch.clamp(den, min=eps)
        state = state + kc.transpose(1, 2) @ vc
        zsum = zsum + kc.sum(dim=1, keepdim=True)
    return out[:, :N]


def relu_attn_causal_scan(q, k, v, *, chunk: int = 256, eps: float = EPS):
    """q, k, v: (BH, N, D) fp32 or bf16 -> (BH, N, D) fp32, causal, in
    chunks of ``min(chunk, N)`` (N zero-padded to whole chunks), in the
    stages of the CUDA kernel's chunk-parallel scan:

    1. each chunk's own state ``dS_c = ReLU(K_c)^T V_c`` and normalizer
       ``dz_c = sum ReLU(K_c)``;
    2. the exclusive prefix over chunks: the state entering chunk c is
       ``S_c = sum_{c' < c} dS_c'`` (``z_c`` likewise; ``S_0 = 0``);
    3. per chunk ``s = tril(ReLU(Q_c) ReLU(K_c)^T)``, ``num = s V_c +
       ReLU(Q_c) S_c``, ``den = rowsum(s) + ReLU(Q_c) . z_c`` and ``num /
       max(den, eps)``."""
    BH, N, D = q.shape
    C = min(chunk, N)
    pad = -N % C
    nc = (N + pad) // C

    def chunks(t):
        return F.pad(t, (0, 0, 0, pad)).reshape(BH, nc, C, D)
    pq, pk = chunks(torch.relu(q.float())), chunks(torch.relu(k.float()))
    vf = chunks(v.float())
    dS = pk.transpose(-1, -2) @ vf                         # (BH, nc, D, D)
    dz = pk.sum(dim=2)                                     # (BH, nc, D)
    S, z = torch.zeros_like(dS), torch.zeros_like(dz)
    S[:, 1:] = torch.cumsum(dS[:, :-1], dim=1)
    z[:, 1:] = torch.cumsum(dz[:, :-1], dim=1)
    tril = torch.ones((C, C), dtype=torch.float32, device=q.device).tril()
    s = (pq @ pk.transpose(-1, -2)) * tril
    num = s @ vf + pq @ S
    den = s.sum(dim=-1, keepdim=True) + pq @ z[..., None]
    out = num / torch.clamp(den, min=eps)
    return out.reshape(BH, nc * C, D)[:, :N]
