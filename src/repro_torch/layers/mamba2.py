"""Mamba-2 (SSD, state-space duality) block, counterpart of
``repro/layers/mamba2.py``.

in_proj -> (z | x | B | C | dt), a short causal depthwise conv1d on
(x | B | C), the SSD scan, a gated RMSNorm, out_proj.

The prefill's scan is ``kernels/ssd/ops.py::ssd_op``: on a CUDA tensor
the hand-written ``ssd_chunked`` kernel, on a CPU tensor its plain
version (``reference=True`` takes the plain version on any device).  JAX
runs a jnp chunked scan here that also returns the final state; the
kernel returns y only, so the final state that prefill hands to decode
is computed here in plain torch (``_final_state``).  Decode is the
one-step recurrence, in plain torch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as coll
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.layers.linear import init_linear, linear
from repro_torch.layers.norms import init_rmsnorm, rmsnorm

__all__ = ["Mamba2Config", "init_mamba2", "mamba2", "init_mamba2_cache",
           "mamba2_decode"]


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256
    dtype: torch.dtype = torch.float32

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        if self.d_inner % self.head_dim:
            raise ValueError(f"d_inner {self.d_inner} is not a multiple of "
                             f"head_dim {self.head_dim}")
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state


def init_mamba2(generator: torch.Generator, cfg: Mamba2Config, device=None):
    H = cfg.n_heads
    gd = generator.device
    zxbcdt = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + H
    # dt bias such that softplus(dt_bias) spans [1e-3, 1e-1] (mamba's)
    u = torch.rand((H,), generator=generator, device=gd)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    dt_bias = dt + torch.log(-torch.expm1(-dt))          # inverse softplus
    conv_w = torch.randn((cfg.d_conv, cfg.conv_dim), generator=generator,
                         device=gd) * cfg.d_conv ** -0.5
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": init_linear(generator, cfg.d_model, zxbcdt,
                               dtype=cfg.dtype, device=device),
        "conv_w": conv_w.to(device=device, dtype=cfg.dtype),
        "conv_b": torch.zeros((cfg.conv_dim,), dtype=cfg.dtype,
                              device=device),
        "A_log": torch.log(torch.arange(1, H + 1, **f32)),
        "dt_bias": dt_bias.to(**f32),
        "D": torch.ones((H,), **f32),
        "norm": init_rmsnorm(cfg.d_inner, cfg.dtype, device),
        "out_proj": init_linear(generator, cfg.d_inner, cfg.d_model,
                                dtype=cfg.dtype, device=device),
    }


def _causal_conv1d(x, w, b):
    """Depthwise causal conv.  x: (B, S, C), w: (K, C), b: (C,)."""
    K, S = w.shape[0], x.shape[1]
    xpad = F.pad(x, (0, 0, K - 1, 0))
    out = sum(xpad[:, i: i + S, :] * w[i][None, None, :] for i in range(K))
    return out + b[None, None, :]


def _split_zxbcdt(proj, cfg: Mamba2Config):
    di, gs = cfg.d_inner, cfg.n_groups * cfg.d_state
    return (proj[..., :di], proj[..., di: 2 * di + 2 * gs],
            proj[..., 2 * di + 2 * gs:])


def _final_state(x, dt, A, B):
    """The SSM state after the last token, (b, h, p, n) fp32:
    sum_s exp(sum_{t > s} dt_t A) dt_s x_s B_s^T.  The decay exponent is
    a reverse cumsum of dA = dt A, summed from the end, so the terms that
    matter (small exponents) carry no cancellation of large partial
    sums.  x: (b, s, h, p); dt: (b, s, h) fp32; A: (h,); B: (b, s, g, n).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dA = dt * A[None, None, :]
    after = torch.flip(torch.cumsum(torch.flip(dA, [1]), 1), [1])  # t >= s
    after = F.pad(after[:, 1:], (0, 0, 0, 1))                       # t > s
    xw = (x.float() * (torch.exp(after) * dt)[..., None])
    xw = xw.reshape(b, s, g, h // g, p)
    st = torch.einsum("bsgrp,bsgn->bgrpn", xw, B.float())
    return st.reshape(b, h, p, n)


def mamba2(params, x, cfg: Mamba2Config, *, return_cache: bool = False,
           reference: bool = False):
    """Prefill forward.  x: (B, S, D) -> (B, S, D), and with
    ``return_cache=True`` the decode cache (the conv tail in x's dtype
    and the final SSM state, fp32).  ``reference=True`` runs the scan's
    plain version."""
    Bsz, S, _ = x.shape
    H, P, N, G = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    proj = linear(params["in_proj"], x)
    z, xbc_raw, dt = _split_zxbcdt(proj, cfg)
    xbc = F.silu(_causal_conv1d(xbc_raw, params["conv_w"].to(x.dtype),
                                params["conv_b"].to(x.dtype)))
    xin = xbc[..., : cfg.d_inner].reshape(Bsz, S, H, P)
    Bssm = xbc[..., cfg.d_inner: cfg.d_inner + G * N].reshape(Bsz, S, G, N)
    Cssm = xbc[..., cfg.d_inner + G * N:].reshape(Bsz, S, G, N)
    dt = F.softplus(dt.float() + params["dt_bias"][None, None, :])
    A = -torch.exp(params["A_log"])
    y = ssd_op(xin, dt, A, Bssm, Cssm, chunk=cfg.chunk, D_skip=params["D"],
               reference=reference)
    y = y.reshape(Bsz, S, cfg.d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = linear(params["out_proj"], y)
    if not return_cache:
        return out
    K = cfg.d_conv - 1
    # a copy: a view would keep the whole in_proj output alive with the
    # cache (0.55 GB a layer at 32k tokens)
    tail = (xbc_raw[:, S - K:, :].clone() if S >= K
            else F.pad(xbc_raw, (0, 0, K - S, 0)))
    return out, {"conv": tail, "ssm": _final_state(xin, dt, A, Bssm)}


def init_mamba2_cache(cfg: Mamba2Config, batch: int, dtype=torch.float32,
                      device=None):
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(params, x, cache, cfg: Mamba2Config, spec=None):
    """One-token recurrent step.  x: (B, 1, D) -> (B, 1, D), new cache.
    The conv window is computed in the promoted dtype of the cache and
    the input (fp32 for the fp32 cache), as JAX's concatenation
    promotes.  ``spec``: the cache leaves' ``CACHE_RULES`` specs under
    the installed ``ShardingCtx``, the cache the rank's blocks: the rank
    convolves its conv channels and updates its SSM heads; the conv
    output and the heads' outputs are all-gathered (activations, not
    the cache) for the SSM and the output projection."""
    Bsz = x.shape[0]
    H, P, N, G = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    proj = linear(params["in_proj"], x)
    z, xbc, dt = _split_zxbcdt(proj, cfg)
    C, Hl = cache["conv"].shape[-1], cache["ssm"].shape[1]
    conv_axes = spec["conv"].axes(2) if spec is not None else ()
    head_axes = spec["ssm"].axes(1) if spec is not None else ()
    c0 = coll.axis_index(conv_axes) * C if conv_axes else 0
    h0 = coll.axis_index(head_axes) * Hl if head_axes else 0
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    if spec is not None:
        xbc = xbc.narrow(-1, c0, C)
        conv_w, conv_b = conv_w.narrow(-1, c0, C), conv_b.narrow(-1, c0, C)
    wd = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    win = torch.cat([cache["conv"].to(wd), xbc.to(wd)], dim=1)   # (B, K, C)
    w = conv_w.to(x.dtype).to(wd)
    conv_out = (torch.einsum("bkc,kc->bc", win, w) + conv_b.to(x.dtype))
    xbc1 = F.silu(conv_out)
    if spec is not None:
        xbc1 = coll.all_gather(xbc1, conv_axes, axis=-1)
    xin = xbc1[..., : cfg.d_inner].reshape(Bsz, H, P)
    Bssm = xbc1[..., cfg.d_inner: cfg.d_inner + G * N].reshape(Bsz, G, N)
    Cssm = xbc1[..., cfg.d_inner + G * N:].reshape(Bsz, G, N)
    rep = H // G
    Bh = torch.repeat_interleave(Bssm, rep, dim=1).float()      # (B, H, N)
    Ch = torch.repeat_interleave(Cssm, rep, dim=1).float()
    dtv = F.softplus(dt.float()[:, 0, :] + params["dt_bias"][None, :])
    A = -torch.exp(params["A_log"])
    D = params["D"]
    xf = xin.float()
    if spec is not None:
        Bh, Ch, dtv, xf = (t.narrow(1, h0, Hl) for t in (Bh, Ch, dtv, xf))
        A, D = A.narrow(0, h0, Hl), D.narrow(0, h0, Hl)
    decay = torch.exp(dtv * A[None, :])                          # (B, H)
    new_ssm = (cache["ssm"] * decay[..., None, None]
               + dtv[..., None, None] * xf[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_ssm)
    y = y + D[None, :, None] * xf
    if spec is not None:
        y = coll.all_gather(y, head_axes, axis=1)
    y = y.reshape(Bsz, 1, cfg.d_inner).to(x.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    return linear(params["out_proj"], y), {"conv": win[:, 1:, :],
                                           "ssm": new_ssm}
