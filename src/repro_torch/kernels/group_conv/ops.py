"""The grouped int8 aggregation kernel for param trees + its registry
impl, counterpart of ``repro/kernels/group_conv/ops.py``.

``group_agg_apply_int8(agg_params, x)`` consumes one entry of a
quantized MSA module's ``aggreg`` list ({'dw','pw'}, each a ``qconv``)
and runs ``group_agg_int8``: the FIX8 MSA module
(``kernels.relu_attn.ops.msa_fused_apply``) calls it once per scale,
which is why a fused int8 MSA site counts ``n_branches`` launches
(``core.fusion.EXPECTED_B1_FUSED_LAUNCHES_INT8``).
"""
from __future__ import annotations

from repro_torch.core.quantization import QTensor, conv2d_int8, quantize_act
from repro_torch.kernels.group_conv.kernel import (
    group_agg_int8, group_agg_path)
from repro_torch.kernels.group_conv.ref import block_diag
from repro_torch.kernels.registry import KernelBase, register

__all__ = ["group_agg_apply_int8", "GroupAggInt8Kernel", "block_diag"]


def group_agg_apply_int8(agg_params, x):
    """One quantized aggregation branch.  ``x``: the fp QKV map (quantized
    here per image) or a ``QTensor`` -> (B, H, W, C) fp32."""
    qd, qp = agg_params["dw"]["qconv"], agg_params["pw"]["qconv"]
    qt = x if isinstance(x, QTensor) else quantize_act(x)
    return group_agg_int8(qt.q.contiguous(), qt.scale,
                          qd["q"][:, :, 0, :].contiguous(), qd["scale"],
                          qd["bias"], qp["q"][0, 0].contiguous(),
                          qp["scale"], qp["bias"])


@register
class GroupAggInt8Kernel(KernelBase):
    """(group_agg, int8): an int8-only kind (``get_probe`` resolves it
    without an fp twin).  ``lower`` emits no such site for EfficientViT;
    the MSA module calls ``group_agg_apply_int8`` itself."""
    kind, precision, dtype = "group_agg", "int8", "i8"
    takes_q = True

    def site_precision(self, params):
        return ("int8" if "qconv" in params.get("dw", {})
                and "qconv" in params.get("pw", {}) else "fp")

    def smem_bytes(self, site, blocks):
        """The branches' paths (``group_agg_path``) for a site whose input
        is the (B, H, W, 3 * heads * head_dim) QKV map, with the MSA
        site's ``head_dim`` and ``scales``."""
        _, H, W, C = site.in_shape
        return max(group_agg_path(H, W, C, site.attrs["head_dim"], s)["smem"]
                   for s in site.attrs["scales"])

    def apply(self, params, x, site, decision=None, *, epilogue=None):
        return group_agg_apply_int8(params, x)

    def ref(self, params, x, site, **kw):
        C = x.shape[-1]
        groups_pw = C // params["pw"]["qconv"]["q"].shape[2]
        y = conv2d_int8(params["dw"]["qconv"], x, groups=C)
        return conv2d_int8(params["pw"]["qconv"], y, groups=groups_pw)
