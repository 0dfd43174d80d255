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

Tensor parallelism (``distributed/tp.py``): under a context whose
``model`` axis splits them, ``in_proj`` is the rank's columns, whose
product is gathered whole (a column block of ``z | x | B | C | dt``
does not follow the heads); the rank convolves its ``conv_w`` channels
and gathers their output; the scan runs on the rank's heads (JAX's
``shard(xin, "dp", "sp", "tp", None)``), the gated RMSNorm sums its
squares over the split, and ``out_proj`` is a row-parallel product.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.tp import (
    Block, param_block, spec_block, take, to_spec, whole)
from repro_torch.kernels.ssd.ops import ssd_op
from repro_torch.layers.linear import init_linear, linear, row_linear
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


def _in_proj(params, x, cfg: Mamba2Config):
    """``in_proj`` -> (z, x | B | C, dt), every column: a contiguous
    column block of ``z | x | B | C | dt`` does not follow the heads, so
    the rank's block of the product is gathered whole."""
    n = 2 * cfg.d_inner + 2 * cfg.n_groups * cfg.d_state + cfg.n_heads
    proj = take(linear(params["in_proj"], x), -1,
                param_block(("fsdp", "tp"), (cfg.d_model, n)), whole(n))
    return _split_zxbcdt(proj, cfg)


def _head_block(cfg: Mamba2Config) -> Block:
    """The rank's SSD heads, JAX's ``shard(xin, "dp", "sp", "tp",
    None)``."""
    return param_block(("tp",), (cfg.n_heads,))


def _groups_of(t, hb: Block, cfg: Mamba2Config, dim: int):
    """The B / C groups (along ``dim``) that the heads ``hb`` read."""
    rep = cfg.n_heads // cfg.n_groups
    g0, g1 = hb.start // rep, (hb.stop - 1) // rep + 1
    n = hb.stop - hb.start
    if (g0, g1) != (0, cfg.n_groups) and n % (g1 - g0):
        raise ValueError(f"heads [{hb.start}, {hb.stop}) straddle the SSM "
                         f"groups of {rep} heads")
    return t.narrow(dim, g0, g1 - g0)


def _out(params, y, z, hb: Block, cfg: Mamba2Config, eps: float = 1e-6):
    """The heads ``hb``'s y (B, S, their d_inner) -> the gated RMSNorm
    over ``d_inner`` and ``out_proj``: each on the rank's block of
    ``d_inner`` under ``norm/scale`` and ``out_proj``'s rows (one
    block), the norm's sum of squares ``psum``'d over the split."""
    P, di = cfg.head_dim, cfg.d_inner
    rows = param_block(("tp", "fsdp"), (di, cfg.d_model), dim=0)
    have = Block(di, hb.start * P, hb.stop * P, hb.axes)
    yz = take(y * F.silu(take(z, -1, whole(di), have)), -1, have, rows)
    yz = rmsnorm(params["norm"], yz, eps, axes=rows.axes)
    return row_linear(params["out_proj"], yz, rows, cfg.d_model)


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
           reference: bool = False, cache_spec=None):
    """Prefill forward.  x: (B, S, D) -> (B, S, D), and with
    ``return_cache=True`` the decode cache (the conv tail in x's dtype
    and the final SSM state, fp32).  ``reference=True`` runs the scan's
    plain version.  Under a context whose ``model`` axis splits them
    (see the module docstring) the rank convolves its ``conv_w``
    channels, scans its heads and returns, with ``cache_spec`` (the
    leaves' ``CACHE_RULES`` specs, the rows the rank's), the rank's
    ``/conv`` block and its heads' ``/ssm`` state."""
    Bsz, S, _ = x.shape
    H, P, N, G = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    z, xbc_raw, dt = _in_proj(params, x, cfg)
    cb = param_block((None, "tp"), (cfg.d_conv, cfg.conv_dim))
    xbc = F.silu(_causal_conv1d(
        xbc_raw[..., cb.start:cb.stop], params["conv_w"].to(x.dtype),
        params["conv_b"][cb.start:cb.stop].to(x.dtype)))
    xbc = take(xbc, -1, cb, whole(cfg.conv_dim))
    hb = _head_block(cfg)
    xin = xbc[..., hb.start * P: hb.stop * P].reshape(
        Bsz, S, hb.stop - hb.start, P)
    Bssm = _groups_of(xbc[..., cfg.d_inner: cfg.d_inner + G * N].reshape(
        Bsz, S, G, N), hb, cfg, 2)
    Cssm = _groups_of(xbc[..., cfg.d_inner + G * N:].reshape(
        Bsz, S, G, N), hb, cfg, 2)
    dt = F.softplus(dt[..., hb.start:hb.stop].float()
                    + params["dt_bias"][None, None, hb.start:hb.stop])
    A = -torch.exp(params["A_log"][hb.start:hb.stop])
    y = ssd_op(xin, dt, A, Bssm, Cssm, chunk=cfg.chunk,
               D_skip=params["D"][hb.start:hb.stop], reference=reference)
    y = y.reshape(Bsz, S, -1).to(x.dtype)
    out = _out(params, y, z, hb, cfg)
    if not return_cache:
        return out
    K = cfg.d_conv - 1
    # a copy: a view would keep the whole in_proj output alive with the
    # cache (0.55 GB a layer at 32k tokens)
    tail = (xbc_raw[:, S - K:, :].clone() if S >= K
            else F.pad(xbc_raw, (0, 0, K - S, 0)))
    ssm = _final_state(xin, dt, A, Bssm)
    if cache_spec is not None:
        tail = to_spec(tail, cache_spec["conv"])
        ssm = to_spec(ssm, cache_spec["ssm"], {1: hb})
    return out, {"conv": tail, "ssm": ssm}


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
    convolves its conv channels (``conv_w``'s block, the same split)
    and updates its SSM heads; the conv output is all-gathered (an
    activation, not the cache) for the heads' x and B / C, and the
    heads' outputs reach the gated norm and ``out_proj`` as the
    prefill's."""
    Bsz = x.shape[0]
    H, P, N, G = cfg.n_heads, cfg.head_dim, cfg.d_state, cfg.n_groups
    z, xbc, dt = _in_proj(params, x, cfg)
    C, Hl = cache["conv"].shape[-1], cache["ssm"].shape[1]
    cs = spec_block(spec and spec["conv"], 2, cfg.conv_dim)
    hb = spec_block(spec and spec["ssm"], 1, H)
    if (cs.stop - cs.start, hb.stop - hb.start) != (C, Hl):
        raise ValueError(f"cache blocks {C}, {Hl} against the specs' "
                         f"{cs}, {hb}")
    xbc = xbc[..., cs.start:cs.stop]
    conv_w = take(params["conv_w"], -1,
                  param_block((None, "tp"), (cfg.d_conv, cfg.conv_dim)), cs)
    conv_b = params["conv_b"][cs.start:cs.stop]
    wd = torch.promote_types(cache["conv"].dtype, xbc.dtype)
    win = torch.cat([cache["conv"].to(wd), xbc.to(wd)], dim=1)   # (B, K, C)
    w = conv_w.to(x.dtype).to(wd)
    conv_out = (torch.einsum("bkc,kc->bc", win, w) + conv_b.to(x.dtype))
    xbc1 = take(F.silu(conv_out), -1, cs, whole(cfg.conv_dim))
    xf = xbc1[..., hb.start * P: hb.stop * P].reshape(Bsz, Hl, P).float()
    Bssm = xbc1[..., cfg.d_inner: cfg.d_inner + G * N].reshape(Bsz, G, N)
    Cssm = xbc1[..., cfg.d_inner + G * N:].reshape(Bsz, G, N)
    rep = H // G
    Bh = torch.repeat_interleave(Bssm, rep, dim=1)[:, hb.start:hb.stop]
    Ch = torch.repeat_interleave(Cssm, rep, dim=1)[:, hb.start:hb.stop]
    Bh, Ch = Bh.float(), Ch.float()                              # (B, Hl, N)
    dtv = F.softplus(dt.float()[:, 0, hb.start:hb.stop]
                     + params["dt_bias"][None, hb.start:hb.stop])
    A = -torch.exp(params["A_log"][hb.start:hb.stop])
    D = params["D"][hb.start:hb.stop]
    decay = torch.exp(dtv * A[None, :])                          # (B, Hl)
    new_ssm = (cache["ssm"] * decay[..., None, None]
               + dtv[..., None, None] * xf[..., :, None] * Bh[..., None, :])
    y = torch.einsum("bhn,bhpn->bhp", Ch, new_ssm)
    y = y + D[None, :, None] * xf
    y = y.reshape(Bsz, 1, Hl * P).to(x.dtype)
    return _out(params, y, z, hb, cfg), {"conv": win[:, 1:, :],
                                         "ssm": new_ssm}
