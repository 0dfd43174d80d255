"""Flash attention with a recomputing backward, counterpart of
``repro/layers/flash.py`` (JAX's ``jax.custom_vjp``), as one
``torch.autograd.Function``.

Autograd through the chunked online softmax (``attention.py``'s
``softmax_attention``) keeps every chunk's probability matrix for the
backward pass, O(S^2) bytes a layer.  This backward never needs them: it
recomputes p per chunk from (q, k, lse) and sums dq / dk / dv chunk by
chunk, as the forward does.

  forward:  per q block, the online softmax over kv chunks (JAX's
            ``_flash_fwd_all``); saves only (q, k, v, out, lse) and the
            positions: O(S D) bytes.
  backward: delta = rowsum(dO * O); then (JAX's ``_flash_bwd_rule``)
              dq_i  = sum_j (p_ij * (dO_i V_j^T - delta_i)) K_j * scale
              dK_j  = sum_i (p_ij * (dO_i V_j^T - delta_i))^T Q_i * scale
              dV_j  = sum_i  p_ij^T dO_i
            with p_ij = exp(Q_i K_j^T * scale - lse_i) recomputed: dq by
            q block over the kv chunks, dk and dv by kv chunk over the q
            blocks.

A length that is no multiple of its chunk runs as one chunk, as JAX's.
Plain torch: JAX's version is jnp, not a Pallas kernel.  Layout: flat
heads (B, S, H, Dh), as ``layers/attention.py``.  Enabled per arch by
``ArchConfig.flash_vjp`` for the softmax and sliding backends.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["flash_attention", "NEG_INF"]

NEG_INF = -1e30


def _mask(q_pos, kv_pos, causal: bool, window: Optional[int]):
    """(qc, kc) bool: the keys each query sees, or None for all."""
    m = None
    if causal:
        m = kv_pos[None, :] <= q_pos[:, None]
    if window is not None:
        w = kv_pos[None, :] > (q_pos[:, None] - window)
        m = w if m is None else m & w
    return m


def _scores(qs, k_j, q_pos, kv_pos, causal, window):
    """qs (B, H, qc, D) scaled fp32 against k_j (B, H, kc, D) fp32 ->
    masked scores (B, H, qc, kc), a new tensor the caller may write."""
    s = torch.matmul(qs, k_j.transpose(-1, -2))
    m = _mask(q_pos, kv_pos, causal, window)
    return s if m is None else s.masked_fill_(~m, NEG_INF)


def _heads_first(t, s0: int, n: int):
    """Rows s0 : s0 + n of (B, S, H, D) -> fp32 (B, H, n, D); a view when
    ``t`` is fp32, else a copy of those rows only."""
    return t[:, s0:s0 + n].float().permute(0, 2, 1, 3)


def _chunk(n: int, c: int) -> int:
    return n if n % c else c


def _flash_fwd(q, k, v, q_pos, kv_pos, causal, window, q_chunk, kv_chunk):
    """-> (out (B, Sq, H, D) fp32, lse (B, H, Sq) fp32)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qc, kc = _chunk(Sq, q_chunk), _chunk(Skv, kv_chunk)
    scale = D ** -0.5
    out = q.new_empty((B, H, Sq, D), dtype=torch.float32)
    lse = q.new_empty((B, H, Sq), dtype=torch.float32)
    for q0 in range(0, Sq, qc):
        qs, qp = _heads_first(q, q0, qc) * scale, q_pos[q0:q0 + qc]
        m = qs.new_full((B, H, qc), NEG_INF)
        l = qs.new_zeros((B, H, qc))
        acc = qs.new_zeros((B, H, qc, D))
        for c0 in range(0, Skv, kc):
            s = _scores(qs, _heads_first(k, c0, kc), qp,
                        kv_pos[c0:c0 + kc], causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = s.sub_(m_new[..., None]).exp_()
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc.mul_(corr[..., None]).add_(
                torch.matmul(p, _heads_first(v, c0, kc)))
            del s, p
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        out[:, :, q0:q0 + qc] = acc / l_safe[..., None]
        lse[:, :, q0:q0 + qc] = m + torch.log(l_safe)
    return out.permute(0, 2, 1, 3), lse


def _flash_bwd(q, k, v, out, lse, q_pos, kv_pos, dout, causal, window,
               q_chunk, kv_chunk):
    """-> (dq, dk, dv), each in its input's dtype and layout.  q, k, v
    stay as saved; a chunk is cast to fp32 where it is used, the
    (qc, kc) work is done in place, and every chunk of dq / dk / dv is
    written straight into its result."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    qc, kc = _chunk(Sq, q_chunk), _chunk(Skv, kv_chunk)
    scale = D ** -0.5
    delta = lse.new_empty((B, H, Sq))           # rowsum(dO * O), a q block
    for q0 in range(0, Sq, qc):                 # at a time
        delta[:, :, q0:q0 + qc] = torch.einsum(
            "bqhd,bqhd->bhq", dout[:, q0:q0 + qc].float(),
            out[:, q0:q0 + qc].float())

    def p_of(qs_i, k_j, q0, c0):
        s = _scores(qs_i, k_j, q_pos[q0:q0 + qc], kv_pos[c0:c0 + kc],
                    causal, window)
        return s.sub_(lse[:, :, q0:q0 + qc, None]).exp_()

    def ds_of(p, do_i, v_j, q0):
        dp = torch.matmul(do_i, v_j.transpose(-1, -2))
        return dp.sub_(delta[:, :, q0:q0 + qc, None]).mul_(p)

    dq, dk, dv = (torch.empty_like(t, memory_format=torch.contiguous_format)
                  for t in (q, k, v))
    for q0 in range(0, Sq, qc):                 # dq: a q block at a time
        qs_i = _heads_first(q, q0, qc) * scale
        do_i = _heads_first(dout, q0, qc)
        acc = qs_i.new_zeros((B, H, qc, D))
        for c0 in range(0, Skv, kc):
            k_j = _heads_first(k, c0, kc)
            ds = ds_of(p_of(qs_i, k_j, q0, c0), do_i,
                       _heads_first(v, c0, kc), q0)
            acc = acc + torch.matmul(ds, k_j) * scale
            del ds
        dq[:, q0:q0 + qc] = acc.permute(0, 2, 1, 3)
    for c0 in range(0, Skv, kc):                # dk, dv: a kv chunk at a time
        k_j, v_j = _heads_first(k, c0, kc), _heads_first(v, c0, kc)
        dk_acc = k_j.new_zeros((B, H, kc, D))
        dv_acc = k_j.new_zeros((B, H, kc, D))
        for q0 in range(0, Sq, qc):
            q_i = _heads_first(q, q0, qc)
            do_i = _heads_first(dout, q0, qc)
            p = p_of(q_i * scale, k_j, q0, c0)
            dv_acc = dv_acc + torch.matmul(p.transpose(-1, -2), do_i)
            ds = ds_of(p, do_i, v_j, q0)
            del p
            dk_acc = dk_acc + torch.matmul(ds.transpose(-1, -2), q_i) * scale
            del ds
        dk[:, c0:c0 + kc] = dk_acc.permute(0, 2, 1, 3)
        dv[:, c0:c0 + kc] = dv_acc.permute(0, 2, 1, 3)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, q_chunk,
                kv_chunk):
        out, lse = _flash_fwd(q, k, v, q_pos, kv_pos, causal, window,
                              q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.cfg = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, out, lse, q_pos, kv_pos, dout,
                                *ctx.cfg)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, q_pos, kv_pos, causal: bool = True,
                    window: Optional[int] = None, q_chunk: int = 1024,
                    kv_chunk: int = 1024):
    """q, k, v: flat-head (B, S, H, Dh) -> (B, Sq, H, Dh) fp32; q_pos
    (Sq,), kv_pos (Skv,) absolute positions.  Gradients flow to q, k and
    v, each in its own dtype."""
    return _FlashAttention.apply(q, k, v, q_pos, kv_pos, causal, window,
                                 q_chunk, kv_chunk)
