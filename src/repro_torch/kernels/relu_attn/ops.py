"""ReLU linear attention on the framework's layouts, the fused MSA
module and its registry impl.

``relu_linear_attention`` takes (B, N, H, D) and runs the non-causal
kernel (EfficientViT's MSA core) or the causal one (the LM form), as
JAX's public op does.

``msa_fused_apply`` runs one EfficientViT MSA module with every
multi-scale branch, image and head in ONE attention launch: the
branches are stacked, the q/k/v split (``[Q heads | K heads | V
heads]`` channel order) reaches the kernel as strided views, and the
kernel writes the (B, H, W, branches * heads * d) map the output
projection reads.  At fp
the QKV projection, aggregation convs and output projection stay plain
torch ops, as the JAX package leaves them to XLA.  At FIX8
(``int8_proj``) the projections run the W8A8 GEMM kernel and the
aggregation branches the grouped int8 kernel
(``kernels/int8_matmul``, ``kernels/group_conv``).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, act_fp, quantize_act
from repro_torch.core.relu_attention import (
    _conv_any, msa_aggregate, msa_project)
from repro_torch.kernels.autotune import (
    autotune, backend_tag, bench_randn, fault_point, on_card, shape_key,
    tile_work)
from repro_torch.kernels.recompute import with_recompute_grad
from repro_torch.kernels.registry import SMEM_LIMIT, KernelBase, register
from repro_torch.kernels.relu_attn.kernel import (
    relu_attn_causal, relu_attn_noncausal, relu_attn_plan)
from repro_torch.kernels.relu_attn.ref import (
    relu_attn_causal_scan, relu_attn_noncausal_ref)

__all__ = ["relu_linear_attention", "msa_attention_fn", "msa_fused_apply",
           "MsaKernel", "MSA_DEFAULT_BLOCK_N", "BLOCK_N_CANDIDATES",
           "candidate_block_n", "tune_block_n"]

MSA_DEFAULT_BLOCK_N = 256   # most tokens the attention stages at once
# JAX's candidate order (``repro/kernels/relu_attn/ops.py``), the default
# first
BLOCK_N_CANDIDATES = (256, 128, 64, 512)


def candidate_block_n(n: int, d: int) -> tuple:
    """The token tiles the autotuner times at ``n`` tokens of width
    ``d``: ``BLOCK_N_CANDIDATES`` whose CTA fits, one per distinct tile
    (``min(n, block_n)``), the default first."""
    out, tiles = [], set()
    for bn in BLOCK_N_CANDIDATES:
        plan = relu_attn_plan(n, d, bn)
        if plan["smem"] <= SMEM_LIMIT and plan["tile"] not in tiles:
            tiles.add(plan["tile"])
            out.append({"block_n": bn})
    return tuple(out) or ({"block_n": MSA_DEFAULT_BLOCK_N},)


def tune_block_n(g: int, n: int, heads: int, d: int, *,
                 allow_sweep: bool = True, device=None) -> dict:
    """``{"block_n"}`` for the attention core of ``g`` (branch, image)
    rows of ``n`` tokens and ``heads`` heads of width ``d``: the cached
    or swept choice among ``candidate_block_n``, timed on
    ``relu_attn_noncausal`` alone with random q/k/v split from one
    stacked map (the strided views the MSA passes).  ``allow_sweep=False``
    gives the default without reading the cache; off the card, the cached
    choice or the default.  The key's batch is branches x images x heads,
    as JAX's."""
    key = shape_key(batch=g * heads, spatial=(n,), d=d, dtype="f32",
                    backend=backend_tag(device))
    cands = candidate_block_n(n, d)
    if not allow_sweep:
        fault_point("relu_attn", key)
        return dict(cands[0])
    bench = None
    if on_card(device):
        (t,) = bench_randn(device, (g, n, 3, heads, d))

        def bench(cand):
            return relu_attn_noncausal(t[:, :, 0], t[:, :, 1], t[:, :, 2],
                                       **cand)
    return autotune("relu_attn", key, cands, bench)


def _fold_heads(x):
    """(B, N, H, D) -> (B*H, N, D), contiguous."""
    B, N, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, N, D).contiguous()


def _unfold_heads(x, B, H):
    BH, N, D = x.shape
    return x.reshape(B, H, N, D).transpose(1, 2)


def relu_linear_attention(q, k, v, *, causal: bool = False,
                          block_n: int = 256, reference: bool = False):
    """Fused ReLU linear attention.  q, k, v: (B, N, H, D) -> (B, N, H, D)
    fp32.  Non-causal: one ``relu_attn_noncausal`` launch over the heads
    in place (token tile ``block_n``); causal: the heads fold into rows
    of ``relu_attn_causal`` (chunk ``block_n``), which takes fp32 or bf16
    as it is.  ``reference=True`` runs the kernel's plain version on the
    same inputs instead, on any device (the LM's reference forward).
    The causal form is differentiable: its backward recomputes through
    the plain version (``kernels/recompute.py``; no backward kernel, as
    JAX has none)."""
    if not causal:
        if reference:
            return relu_attn_noncausal_ref(q.float(), k.float(), v.float())
        return relu_attn_noncausal(q.float(), k.float(), v.float(),
                                   block_n=block_n)
    B, _, H, _ = q.shape
    qf, kf, vf = _fold_heads(q), _fold_heads(k), _fold_heads(v)
    if reference:
        out = relu_attn_causal_scan(qf, kf, vf, chunk=block_n)
    else:
        out = with_recompute_grad(relu_attn_causal, relu_attn_causal_scan,
                                  qf, kf, vf, chunk=block_n)
    return _unfold_heads(out, B, H)


def msa_attention_fn(q, k, v):
    """Drop-in ``attention_fn`` for ``core.relu_attention.msa``
    (B, N, h, d)."""
    return relu_linear_attention(q, k, v, causal=False).to(q.dtype)


def _int8_branches(params, x, n_heads: int):
    """FIX8 ``[qkv, agg_s...]``: the QKV projection as the W8A8 GEMM
    (taking a producer's ``QTensor`` as it is), then ONE per-image
    quantize of the QKV map feeding every aggregation scale's grouped
    int8 kernel (the reference convs when an aggregation is not fully
    quantized)."""
    from repro_torch.kernels.group_conv.ops import group_agg_apply_int8
    from repro_torch.kernels.int8_matmul.ops import conv1x1_w8a8

    qkv = conv1x1_w8a8(params["qkv"]["qconv"], x)
    multi = [qkv]
    if all("qconv" in a["dw"] and "qconv" in a["pw"]
           for a in params["aggreg"]):
        if params["aggreg"]:
            qkv_qt = quantize_act(qkv)
            multi += [group_agg_apply_int8(a, qkv_qt)
                      for a in params["aggreg"]]
    else:
        for agg in params["aggreg"]:
            a = _conv_any(agg["dw"], qkv, groups=qkv.shape[-1])
            multi.append(_conv_any(agg["pw"], a, groups=3 * n_heads))
    return multi


def msa_fused_apply(params, x, n_heads: int, head_dim: int, *,
                    block_n: int = MSA_DEFAULT_BLOCK_N,
                    int8_proj: bool = False, epilogue=None):
    """x: (B, H, W, C), or a producer's ``QTensor`` -> (B, H, W, C); one
    attention launch.  ``int8_proj`` routes the projections through the
    W8A8 GEMM when both are quantized; an int8 ``epilogue`` then makes
    the output projection emit a ``QTensor`` (``int8_matmul_emit``)."""
    qt = isinstance(x, QTensor)
    B, H, W, _ = x.shape
    dtype = (x.fp.dtype if qt and x.fp is not None
             else torch.float32 if qt else x.dtype)
    int8 = (int8_proj and "qconv" in params["qkv"]
            and "qconv" in params["proj"])
    multi = (_int8_branches(params, x, n_heads) if int8
             else msa_aggregate(params, act_fp(x), n_heads))
    stack = torch.stack(multi)                               # (S,B,H,W,3T)
    S, N = stack.shape[0], H * W
    total = n_heads * head_dim
    t = stack.reshape(S * B, N, 3, n_heads, head_dim)
    # the attention writes branch s of image b straight into channels
    # [s*T, (s+1)*T) of the (B, H, W, S*T) map the projection reads
    out = torch.empty((B, H, W, S * total), dtype=torch.float32,
                      device=stack.device)
    relu_attn_noncausal(t[:, :, 0], t[:, :, 1], t[:, :, 2], block_n=block_n,
                        out=out.view(B, N, S, n_heads, head_dim)
                        .permute(2, 0, 1, 3, 4))
    out = out.to(dtype)
    if int8:
        from repro_torch.kernels.int8_matmul.ops import conv1x1_w8a8
        return conv1x1_w8a8(params["proj"]["qconv"], out, epilogue=epilogue)
    return msa_project(params, out)


@register
class MsaKernel(KernelBase):
    """(msa, fp): all branches and heads fold into one attention launch;
    the projections stay on the reference conv path."""
    kind, precision, dtype = "msa", "fp", "f32"
    int8_proj = False

    def site_precision(self, params):
        return ("int8" if "qconv" in params["qkv"]
                and "qconv" in params["proj"] else "fp")

    def resolve_precision(self, site_prec, requested):
        # never a fallback: a mismatch keeps the projections on the
        # reference path while the attention core fuses either way
        if requested in ("auto", site_prec):
            return site_prec, None
        return "fp", None

    def smem_bytes(self, site, blocks):
        _, H, W, _ = site.in_shape
        return relu_attn_plan(H * W, site.attrs["head_dim"],
                              blocks["block_n"])["smem"]

    def tune(self, site, *, autotune=True, device=None):
        B, H, W, _ = site.in_shape
        return tune_block_n(site.attrs["n_branches"] * B, H * W,
                            site.attrs["heads"], site.attrs["head_dim"],
                            allow_sweep=autotune, device=device)

    def candidates(self, site):
        _, H, W, _ = site.in_shape
        return candidate_block_n(H * W, site.attrs["head_dim"])

    def block_work(self, site, blocks):
        _, H, W, _ = site.in_shape
        return tile_work(H * W, min(H * W, blocks["block_n"]))

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        blocks = decision.blocks if decision is not None else {}
        return msa_fused_apply(params, x, site.attrs["heads"],
                               site.attrs["head_dim"],
                               block_n=blocks.get("block_n",
                                                  MSA_DEFAULT_BLOCK_N),
                               int8_proj=self.int8_proj, epilogue=epilogue)

    def ref(self, params, x, site, **kw):
        from repro_torch.core.relu_attention import MSAConfig, msa
        return msa(params, x, MSAConfig(x.shape[-1], site.attrs["head_dim"],
                                        site.attrs["scales"]))
