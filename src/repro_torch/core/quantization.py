"""FIX8 (int8) post-training quantization, counterpart of
``repro/core/quantization.py``: the paper's 8-bit fixed-point arithmetic.

Scheme: BN folded into the preceding conv; weights symmetric int8 per
output channel; activations symmetric int8 per image (dynamic absmax);
int32 accumulation, dequantized by (s_act * s_w) per channel.

Every fp32 epilogue keeps the JAX function's operation order, and every
division takes a tensor divisor (``common.device.scalar``): on a CUDA
tensor PyTorch turns division by a Python scalar into multiplication by
its reciprocal, which would make these plain versions differ between
the CPU and the card.  The int32 sums are exact: torch has no int8
convolution with an int32 accumulator, so they run in float64 on the
int8 values (every sum here is far below 2**53) and are rounded to fp32
once, as JAX's ``int32 -> float32`` conversion rounds them.

``quantize_lm_params`` is the LM weight-only int8 (W8) transform: JAX's
tree walk leaf for leaf, each stacked weight quantized one leading index
(layer, expert) at a time, which gives the same bits with one slice's
fp32 copy in memory instead of the whole tensor's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.common.device import scalar
from repro_torch.layers.conv import conv2d
from repro_torch.layers.norms import bn_fold_scale_bias

__all__ = ["QTensor", "act_fp", "quantize_act", "quantize_tensor",
           "quantize_with_scale", "calibrate_act_scale", "dequantize",
           "fold_bn_into_conv", "quantize_conv_bn", "quantize_linear",
           "quantize_efficientvit", "conv2d_int8", "matmul_int8", "int_sums",
           "quantize_lm_params"]

QMAX = 127


class QTensor(NamedTuple):
    """A quantized activation crossing a producer -> consumer boundary:
    ``q`` int8, its per-image (or per-tensor) fp32 ``scale``, and the fp
    activation ``fp`` when the epilogue's residual policy keeps it."""
    q: torch.Tensor
    scale: torch.Tensor               # fp32 () or (B,)
    fp: Optional[torch.Tensor] = None

    @property
    def shape(self):
        return self.q.shape

    def scale_col(self) -> torch.Tensor:
        """The scale as a (B,) vector over the leading batch axis."""
        s = self.scale.float().reshape(-1)
        return s.expand(self.q.shape[0])


def act_fp(y):
    """The fp view of an activation: a ``QTensor`` -> its kept fp tensor."""
    if isinstance(y, QTensor):
        if y.fp is None:
            raise ValueError(
                "QTensor without a kept fp activation reached a consumer "
                "that needs full precision: epilogue assignment bug")
        return y.fp
    return y


def _scale_of(absmax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-8) / 127, in fp32, on any device."""
    return torch.clamp_min(absmax, 1e-8) / scalar(float(QMAX), absmax.device)


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -QMAX - 1, QMAX).to(
        torch.int8)


def quantize_act(x, *, keep_fp: bool = False) -> QTensor:
    """Per-image symmetric absmax quantization (identical to the
    per-tensor scheme at batch 1); ``keep_fp`` carries ``x`` alongside."""
    xf = x.float()
    absmax = torch.amax(xf.abs(), dim=tuple(range(1, x.dim())))
    scale = _scale_of(absmax)                                    # (B,)
    q = _quantize(xf, scale.reshape((-1,) + (1,) * (x.dim() - 1)))
    return QTensor(q, scale, x if keep_fp else None)


def quantize_tensor(x, axis=None):
    """Symmetric int8.  ``axis=None``: one scale; else one per index of
    ``axis`` (kept as a size-1-elsewhere shape, as JAX's keepdims)."""
    xf = x.float()
    if axis is None:
        absmax = torch.amax(xf.abs())
    else:
        red = tuple(i for i in range(x.dim()) if i != axis % x.dim())
        absmax = torch.amax(xf.abs(), dim=red, keepdim=True)
    scale = _scale_of(absmax)
    return _quantize(xf, scale), scale


def quantize_with_scale(x, scale):
    """Symmetric int8 against a precomputed (calibrated) scale."""
    return _quantize(x.float(), torch.as_tensor(scale, dtype=torch.float32,
                                                device=x.device))


def calibrate_act_scale(samples):
    """Static per-tensor activation scale from calibration batches: the
    symmetric scale covering the joint absmax of ``samples`` (a tensor
    or an iterable of tensors), for ``x_scale`` in
    ``kernels.int8_matmul.ops.linear_w8a8`` / ``conv1x1_w8a8``."""
    if isinstance(samples, torch.Tensor):
        samples = [samples]
    absmax = torch.zeros((), dtype=torch.float32)
    for s in samples:
        absmax = torch.maximum(absmax.to(s.device),
                               torch.amax(s.float().abs()))
    return _scale_of(absmax)


def dequantize(q, scale):
    return q.float() * scale


def fold_bn_into_conv(conv_p, bn_p, eps: float = 1e-5):
    """(conv, BN) -> folded (w', b') with BN absorbed per output channel."""
    gamma, beta = bn_fold_scale_bias(bn_p, eps)
    w = conv_p["w"].float() * gamma[None, None, None, :]
    b = conv_p.get("b")
    b = beta if b is None else beta + b.float() * gamma
    return w, b


def quantize_conv_bn(p, eps: float = 1e-5):
    """{'conv','bn'} -> {'qconv': {q (HWIO int8), scale (F,), bias (F,)}}."""
    w, b = fold_bn_into_conv(p["conv"], p["bn"], eps)
    q, scale = quantize_tensor(w, axis=-1)       # per output channel
    return {"qconv": {"q": q, "scale": scale[0, 0, 0, :], "bias": b}}


def int_sums(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 sums of an int8 matrix product, as fp32:
    (..., K) int8 @ (K, N) int8."""
    return (a.double() @ b.double()).float()


def _conv_int(xq, wq, *, stride: int, groups: int) -> torch.Tensor:
    """Exact int32 sums of an int8 SAME conv (NHWC, HWIO), as fp32."""
    return conv2d({"w": wq.double()}, xq.double(), stride=stride,
                  groups=groups).float()


def conv2d_int8(qp, x, *, stride: int = 1, groups: int = 1):
    """FIX8 conv: per-image act quant, int8 conv with exact int32 sums,
    fp32 dequant ``acc * (sx * scale) + bias``.  ``x`` may be a producer's
    ``QTensor``; its scales then broadcast through the dequant."""
    if isinstance(x, QTensor):
        xq, sx = x.q, x.scale_col().reshape(-1, 1, 1, 1)
        out_dtype = x.fp.dtype if x.fp is not None else torch.float32
    else:
        qt = quantize_act(x)
        xq, sx = qt.q, qt.scale.reshape(-1, 1, 1, 1)
        out_dtype = x.dtype
    acc = _conv_int(xq, qp["q"], stride=stride, groups=groups)
    y = acc * (sx * qp["scale"][None, None, None, :])
    return (y + qp["bias"][None, None, None, :]).to(out_dtype)


def matmul_int8(x, qw, w_scale):
    """(..., d) fp x int8 (d, f): per-leading-element act quant, exact
    int32 sums, ``acc * (sx * w_scale)``."""
    xf = x.float()
    if x.dim() <= 1:
        absmax = torch.amax(xf.abs())
    else:
        absmax = torch.amax(xf.abs(), dim=tuple(range(1, x.dim())),
                            keepdim=True)
    sx = _scale_of(absmax)
    acc = int_sums(_quantize(xf, sx), qw)
    return (acc * (sx * w_scale)).to(x.dtype)


def quantize_linear(p):
    q, scale = quantize_tensor(p["w"], axis=-1)
    out = {"qw": q, "scale": scale[0, :]}
    if "b" in p:
        out["bias"] = p["b"].float()
    return out


def _is_conv_bn(node) -> bool:
    return isinstance(node, dict) and set(node) == {"conv", "bn"}


def quantize_efficientvit(params):
    """Fold and quantize every conv+BN block of an EfficientViT param
    tree; bare convs (MSA qkv/aggreg) get int8 weights, the MSA output
    projection folds ``proj_bn``, and the FC layers become ``qw``."""

    def walk(node):
        if _is_conv_bn(node):
            return quantize_conv_bn(node)
        if isinstance(node, dict):
            if "proj" in node and "proj_bn" in node:     # MSA tail
                out = {k: walk(v) for k, v in node.items()
                       if k not in ("proj", "proj_bn")}
                out["proj"] = quantize_conv_bn(
                    {"conv": node["proj"], "bn": node["proj_bn"]})
                return out
            if set(node) == {"w"} and node["w"].dim() == 4:   # bare conv
                q, scale = quantize_tensor(node["w"], axis=-1)
                return {"qconv": {
                    "q": q, "scale": scale[0, 0, 0, :],
                    "bias": torch.zeros(node["w"].shape[-1],
                                        device=node["w"].device)}}
            if set(node) == {"w"} and node["w"].dim() == 2:   # fc
                return quantize_linear(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)


# ---------------------------------------------------------------------------
# LM weight-only int8 (W8)
# ---------------------------------------------------------------------------

_W8_SKIP = ("norm", "ln1", "ln2", "ln3", "final_norm", "enc_norm", "router",
            "conv_w", "conv_b", "A_log", "dt_bias", "D", "proj_bn", "bn")


def _q_per_out_channel(w):
    """int8 per (stack..., out channel): the scale reduces the in dim
    (axis -2) only -> (q int8, scale fp32 (..., 1, out))."""
    wf = w.float()
    scale = _scale_of(torch.amax(wf.abs(), dim=-2, keepdim=True))
    return _quantize(wf, scale), scale


def _q_sliced(w):
    """``_q_per_out_channel`` one leading index at a time: the same bits
    (each scale reduces within its own (in, out) slice), with one slice's
    fp32 copy alive instead of the whole tensor's."""
    if w.dim() <= 2 or w.device.type == "meta":   # meta: shapes only
        return _q_per_out_channel(w)
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-2] + (1, w.shape[-1]),
                        dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], scale[i] = _q_sliced(w[i])
    return q, scale


def quantize_lm_params(params):
    """Weight-only int8 transform of an LM (or enc-dec) param tree, as
    JAX's: matmul weights ``{"w": (..., in, out)}`` become ``{"qw" int8,
    "scale" (..., 1, out)}`` (a bias ``"b"`` kept); embedding tables
    ``{"qt" int8, "scale" (V, 1)}``; MoE expert tensors (stacked or not)
    ``{"q" int8, "scale"}``.  Norms, biases, routers and SSM scalars stay
    as they are (the same substring tests on the path as JAX's).
    ``layers.linear`` and ``layers.moe`` dequantize on use."""

    def walk(node, path=""):
        if isinstance(node, dict):
            if any(s in path.rsplit("/", 1)[-1] for s in _W8_SKIP):
                return node
            if "table" in node and node["table"].dim() == 2:
                q, scale = quantize_tensor(node["table"], axis=0)
                return {"qt": q, "scale": scale.float()}
            if "w" in node and node["w"].dim() >= 2 \
                    and not any(s in path for s in _W8_SKIP):
                q, scale = _q_sliced(node["w"])
                out = {"qw": q, "scale": scale}
                if "b" in node:
                    out["b"] = node["b"]
                return out
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        if isinstance(node, torch.Tensor) and node.dim() >= 3 and \
                path.rsplit("/", 1)[-1] in ("w_in", "w_gate", "w_out"):
            q, scale = _q_sliced(node)
            return {"q": q, "scale": scale}
        return node

    return walk(params)
