"""Typed program IR: ONE lowering of EfficientViT that everything runs.

Counterpart of ``repro/core/program.py``:

    ``lower(cfg) -> Program``     architecture walk, done ONCE
    ``execute(program, params, x, plan=...)``
                                  the forward, interpreting the IR
    ``manifest(program)``         hardware op records (MACs/shapes)

``execute`` routes fusible sites (``dsconv | mbconv | msa``) through the
kernel registry (``repro_torch.kernels.registry``) when a ``FusionPlan``
decision fuses them; with ``plan=None`` it runs the reference ops.  A
``quantize_efficientvit`` (FIX8) tree runs the int8 dataflow: producers
named by the plan's epilogues hand their consumers ``QTensor``s.  A
plan's super-site groups (``SuperSite``) run as one chain launch each.
``execute(..., profile=)`` records each site's window with an
``obs.profile.SiteProfiler`` (JAX's profiled execution; groups off).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping, Tuple

from repro_torch.common.device import scalar
from repro_torch.common.errors import LoweringError
from repro_torch.core.efficientvit import (
    B1, EfficientViTConfig, OpRecord, conv_bn_act, dsconv, hardswish, mbconv)
from repro_torch.core.quantization import act_fp, matmul_int8, quantize_act
from repro_torch.core.relu_attention import (
    MSAConfig, msa, relu_global_attention)

__all__ = ["Epilogue", "EPILOGUE_FP", "Site", "SuperSite", "Program",
           "lower", "execute", "manifest", "site_records", "FUSIBLE_KINDS",
           "SUPERSITE_KINDS", "params_at"]


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """Producer-side output descriptor of one ``Site``.

    ``out_dtype="int8"`` makes the producer emit a ``QTensor`` with a
    ``"dynamic"`` (per-image absmax) ``scale``.  ``residual``: ``"none"``
    emits int8 only; ``"post-add"`` quantizes after the site's own fp
    residual add; ``"keep-fp"`` also keeps the fp activation for the
    consumer's residual add.
    """
    out_dtype: str = "fp32"    # "fp32" | "int8"
    scale: str = "none"        # "none" | "dynamic"
    residual: str = "none"     # "none" | "post-add" | "keep-fp"

    @property
    def emits_q(self) -> bool:
        return self.out_dtype == "int8"

    @property
    def keeps_fp(self) -> bool:
        """The fp activation also crosses the site boundary."""
        return self.out_dtype == "fp32" or self.residual != "none"


EPILOGUE_FP = Epilogue()

# Structural kinds ``execute`` interprets inline; every other kind is
# fusible and plans through the kernel registry.
STRUCTURAL_KINDS = ("conv_bn", "gap", "fc")
FUSIBLE_KINDS = ("dsconv", "mbconv", "msa")
# Conv-chain kinds the super-site grouping pass may join into one launch
# (core.fusion.plan_program + kernels/supersite).
SUPERSITE_KINDS = ("dsconv", "mbconv")


@dataclasses.dataclass(frozen=True)
class Site:
    """One schedulable node of the lowered network.

    ``name`` is the dotted site id shared with ``FusionPlan`` decisions
    (e.g. ``"S3.evit0.msa"``); ``param_path`` indexes the param tree
    (str = dict key, int = list index); ``attrs`` carries kind-specific
    geometry (mbconv: ``mid``; msa: ``heads``/``head_dim``/``scales``/
    ``n_branches``; conv_bn: ``k``).
    """
    name: str
    kind: str                  # conv_bn | dsconv | mbconv | msa | gap | fc
    stage: str                 # stem | S1..S4 | head
    param_path: Tuple[Any, ...]
    in_shape: Tuple[int, ...]  # (B, H, W, C) - (B, C) for fc
    out_shape: Tuple[int, ...]
    stride: int = 1
    residual: bool = False     # out = x + op(x)
    act: bool = False          # trailing Hardswish (conv_bn / fc sites)
    attrs: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    epilogue: Epilogue = EPILOGUE_FP

    @property
    def local_name(self) -> str:
        """Site name with the stage prefix stripped (manifest naming)."""
        prefix = f"{self.stage}."
        return self.name[len(prefix):] if self.name.startswith(prefix) \
            else self.name


@dataclasses.dataclass(frozen=True)
class SuperSite:
    """A chain of consecutive conv ``Site``s run as ONE kernel launch
    (``kernels/supersite``): member intermediates stay on chip, member
    weights come from one packed block.  Built by the fusion planner's
    grouping pass; ``of`` validates the chain so a bad grouping fails at
    plan time as a typed ``LoweringError``."""
    name: str
    stage: str
    sites: Tuple[Site, ...]

    @classmethod
    def of(cls, program: "Program", names, name: str | None = None
           ) -> "SuperSite":
        """Validate + build a super-site from member site names: >= 2
        consecutive sites of ``program``, one stage, conv kinds only, each
        consuming exactly its predecessor's output."""
        names = tuple(names)
        if len(names) < 2:
            raise LoweringError(
                f"super-site needs >= 2 members, got {names}",
                site=names[0] if names else None)
        idx = {s.name: i for i, s in enumerate(program.sites)}
        for n in names:
            if n not in idx:
                raise LoweringError(f"super-site member {n!r} is not a "
                                    f"site of the program", site=n)
        order = [idx[n] for n in names]
        if order != list(range(order[0], order[0] + len(names))):
            raise LoweringError(
                f"super-site members {names} are not consecutive "
                f"program sites", site=names[0])
        members = tuple(program.sites[i] for i in order)
        stage = members[0].stage
        for m in members:
            if m.kind not in SUPERSITE_KINDS:
                raise LoweringError(
                    f"super-site member {m.name} has kind {m.kind!r}; "
                    f"only {SUPERSITE_KINDS} chain", site=m.name)
            if m.stage != stage:
                raise LoweringError(
                    f"super-site member {m.name} is in stage {m.stage}, "
                    f"group started in {stage}", site=m.name)
        for a, b in zip(members, members[1:]):
            if a.out_shape != b.in_shape:
                raise LoweringError(
                    f"super-site chain break {a.name} -> {b.name}: "
                    f"{a.out_shape} != {b.in_shape}", site=b.name)
        return cls(name or f"{stage}.ss", stage, members)

    # Site-like surface, so registry impls treat a chain as one unit.
    kind: str = dataclasses.field(default="supersite", init=False)

    @property
    def members(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.sites)

    @property
    def in_shape(self) -> Tuple[int, ...]:
        return self.sites[0].in_shape

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return self.sites[-1].out_shape


@dataclasses.dataclass(frozen=True)
class Program:
    """Frozen, ordered lowering of one EfficientViT configuration."""
    cfg: EfficientViTConfig
    batch: int
    image_size: int
    sites: Tuple[Site, ...]

    def site(self, name: str) -> Site:
        for s in self.sites:
            if s.name == name:
                return s
        raise KeyError(name)

    def by_kind(self, *kinds: str) -> Tuple[Site, ...]:
        return tuple(s for s in self.sites if s.kind in kinds)

    def fusible(self) -> Tuple[Site, ...]:
        """Sites the kernel registry can route: the fusion-plan keys."""
        return tuple(s for s in self.sites
                     if s.kind not in STRUCTURAL_KINDS)

    def with_epilogues(self, plan) -> "Program":
        """A new program whose sites carry the plan's epilogue
        assignments (``core.fusion.plan_program``'s producer -> consumer
        pass), so the dtype each boundary delivers is readable from the
        program itself: the executor cache and the cycle model read it
        here."""
        eps = getattr(plan, "epilogues", None) or {}
        sites = tuple(
            dataclasses.replace(s, epilogue=eps[s.name]) if s.name in eps
            else s for s in self.sites)
        return Program(self.cfg, self.batch, self.image_size, sites)


def params_at(params, path: Tuple[Any, ...]):
    """Resolve a ``Site.param_path`` against a param tree."""
    node = params
    for key in path:
        node = node[key]
    return node


# ---------------------------------------------------------------------------
# lower: cfg -> Program (the single architecture walk)
# ---------------------------------------------------------------------------

_SEQ_FIELDS = ("widths", "depths", "msa_scales", "head_widths")


def lower(cfg: EfficientViTConfig = B1, *, batch: int = 1,
          image_size: int | None = None) -> Program:
    """Lower a config to the frozen ``Site`` sequence (cached; list
    fields are normalized to tuples so the config hashes)."""
    repl = {f: tuple(v) for f in _SEQ_FIELDS
            if not isinstance(v := getattr(cfg, f), tuple)}
    if repl:
        cfg = dataclasses.replace(cfg, **repl)
    return _lower(cfg, batch, image_size)


def _validate_geometry(sites: Tuple[Site, ...], size: int) -> None:
    """Each site consumes exactly what its predecessor produced, residual
    sites preserve shape, no extent collapses to zero; violations raise
    ``LoweringError`` naming the site."""
    prev = None
    for s in sites:
        if any(dim <= 0 for dim in s.out_shape):
            raise LoweringError(
                f"site {s.name}: out_shape {s.out_shape} has a "
                f"non-positive dim at image_size={size}", site=s.name)
        if prev is not None and s.in_shape != prev.out_shape:
            raise LoweringError(
                f"geometry break at {prev.name} -> {s.name}: "
                f"{prev.out_shape} != {s.in_shape}", site=s.name)
        if s.residual and s.in_shape != s.out_shape:
            raise LoweringError(
                f"residual site {s.name} is not shape-preserving: "
                f"{s.in_shape} -> {s.out_shape}", site=s.name)
        prev = s


@functools.lru_cache(maxsize=64)
def _lower(cfg: EfficientViTConfig, batch: int,
           image_size: int | None) -> Program:
    w, d = cfg.widths, cfg.depths
    size = image_size or cfg.image_size
    B = batch
    if B < 1:
        raise LoweringError(f"batch must be >= 1, got {B}")
    if size % 32:
        raise LoweringError(
            f"image_size={size}: EfficientViT downsamples by 2 five "
            f"times (stem, S1, S2, S3.down, S4.down), so serving "
            f"resolutions must be multiples of 32 (192/224/256/...)")
    sites: list[Site] = []
    r = size // 2

    sites.append(Site("stem.conv1", "conv_bn", "stem", ("stem_conv",),
                      (B, size, size, 3), (B, r, r, w[0]), stride=2,
                      act=True, attrs={"k": 3}))
    for i in range(d[0]):
        sites.append(Site(f"stem.ds{i}", "dsconv", "stem", ("stem_ds", i),
                          (B, r, r, w[0]), (B, r, r, w[0]), residual=True))
    for si in (1, 2):
        c_in = w[si - 1]
        for bi in range(d[si]):
            stride = 2 if bi == 0 else 1
            ro = r // stride
            sites.append(Site(
                f"S{si}.mb{bi}", "mbconv", f"S{si}", (f"stage{si}", bi),
                (B, r, r, c_in), (B, ro, ro, w[si]), stride=stride,
                residual=bi > 0, attrs={"mid": c_in * cfg.expand_ratio}))
            r, c_in = ro, w[si]
    for si in (3, 4):
        c = w[si]
        sites.append(Site(
            f"S{si}.down", "mbconv", f"S{si}", (f"stage{si}", "down"),
            (B, r, r, w[si - 1]), (B, r // 2, r // 2, c), stride=2,
            attrs={"mid": w[si - 1] * cfg.expand_ratio}))
        r //= 2
        heads = c // cfg.head_dim
        for bi in range(d[si]):
            sites.append(Site(
                f"S{si}.evit{bi}.msa", "msa", f"S{si}",
                (f"stage{si}", "blocks", bi, "msa"),
                (B, r, r, c), (B, r, r, c), residual=True,
                attrs={"heads": heads, "head_dim": cfg.head_dim,
                       "scales": tuple(cfg.msa_scales),
                       "n_branches": 1 + len(cfg.msa_scales)}))
            sites.append(Site(
                f"S{si}.evit{bi}.mb", "mbconv", f"S{si}",
                (f"stage{si}", "blocks", bi, "mbconv"),
                (B, r, r, c), (B, r, r, c), residual=True,
                attrs={"mid": c * cfg.expand_ratio}))
    hw1, hw2 = cfg.head_widths
    sites.append(Site("head.conv", "conv_bn", "head", ("head", "conv"),
                      (B, r, r, w[4]), (B, r, r, hw1), act=True,
                      attrs={"k": 1}))
    sites.append(Site("head.gap", "gap", "head", (),
                      (B, r, r, hw1), (B, hw1)))
    sites.append(Site("head.fc1", "fc", "head", ("head", "fc1"),
                      (B, hw1), (B, hw2), act=True))
    sites.append(Site("head.fc2", "fc", "head", ("head", "fc2"),
                      (B, hw2), (B, cfg.num_classes)))
    _validate_geometry(tuple(sites), size)
    return Program(cfg, B, size, tuple(sites))


# ---------------------------------------------------------------------------
# execute: interpret the IR (reference ops + registry dispatch)
# ---------------------------------------------------------------------------

def _fc(p, h):
    if "qw" in p:
        return matmul_int8(h, p["qw"], p["scale"])
    return h @ p["w"].to(h.dtype)


def _gap(y):
    """Mean over H, W: a sequential sum over the positions, then one true
    division.  This is XLA's order for spatial extents below 32, and it
    does not depend on the batch on any device (``torch.mean`` on CUDA
    picks its reduction split by shape)."""
    B, H, W, C = y.shape
    flat = y.reshape(B, H * W, C)
    acc = flat[:, 0]
    for i in range(1, H * W):
        acc = acc + flat[:, i]
    return acc / scalar(float(H * W), acc.device)


def _dispatch(site: Site, p, y, plan, cfg, attention_fn, kernel_ep):
    """Fusible site: the registry kernel when the plan fuses it, else
    the reference op (the impl's ``ref`` for kinds beyond the built-ins).
    ``y`` may be a producer's ``QTensor`` (only fused int8 consumers are
    handed one); ``kernel_ep`` is the in-kernel part of this site's own
    epilogue (``None`` for fp output or a post-add policy)."""
    d = plan.get(site.name) if plan is not None else None
    if d is not None and d.fused:
        from repro_torch.kernels.registry import get_kernel
        ep_kw = {} if kernel_ep is None else {"epilogue": kernel_ep}
        return get_kernel(site.kind, d.precision).apply(p, y, site, d,
                                                        **ep_kw)
    y = act_fp(y)
    if site.kind == "dsconv":
        return dsconv(p, y, stride=site.stride)
    if site.kind == "mbconv":
        return mbconv(p, y, stride=site.stride)
    if site.kind == "msa":
        return msa(p, y, MSAConfig(site.in_shape[-1], site.attrs["head_dim"],
                                   site.attrs["scales"], cfg.dtype),
                   attention_fn=attention_fn)
    from repro_torch.kernels.registry import get_probe
    return get_probe(site.kind).ref(p, y, site)


def execute(program: Program, params, x, *, plan=None, attention_fn=None,
            profile=None):
    """Run the lowered program.  x: (B, H, W, 3) -> (B, num_classes).

    ``plan`` is an optional ``core.fusion.FusionPlan`` over the same
    ``Program``: fused sites launch the registry's CUDA kernels (their
    plain versions on CPU tensors) at the precision each decision
    carries, and the plan's epilogues make producers emit ``QTensor``s
    for fused int8 consumers; residual adds stay fp.  ``plan=None`` runs
    the reference ops.  ``attention_fn`` replaces the attention core of
    the reference MSA (``plan=None`` only).  A plan's super-site groups
    run as one chain launch each, entered at the first member; the other
    members are skipped, and the last member's epilogue is the chain's
    exit.  Eager: nothing here waits on the device.

    ``profile`` is an optional ``repro_torch.obs.profile.SiteProfiler``:
    ``profile.begin(site)`` before each site and ``profile.end(site, y)``
    after it record the site's window under its name.  Super-site groups
    are off under ``profile`` (the drift report needs one window per
    site), so a profiled forward launches every member on its own.
    """
    if attention_fn is not None and plan is not None:
        raise ValueError("attention_fn replaces the reference attention "
                         "core; it takes plan=None")
    attention_fn = attention_fn or relu_global_attention
    epilogues = getattr(plan, "epilogues", None) or {}
    groups = (getattr(plan, "groups", None) or {}) if profile is None \
        else {}
    group_entry, group_skip = {}, set()
    for g in groups.values():
        group_entry[g.members[0]] = g
        group_skip.update(g.members[1:])
    y = x
    for site in program.sites:
        if site.name in group_skip:
            continue
        if site.name in group_entry:
            from repro_torch.kernels.registry import get_kernel
            g = group_entry[site.name]
            sup = SuperSite.of(program, g.members, name=g.name)
            y = get_kernel("supersite", g.precision).apply(
                params, y, sup, g, epilogue=epilogues.get(g.members[-1]))
            continue
        if profile is not None:
            profile.begin(site)
        p = params_at(params, site.param_path) if site.param_path else None
        ep = epilogues.get(site.name)
        if site.kind == "conv_bn":
            y = conv_bn_act(p, y, stride=site.stride, act=site.act)
            if ep is not None and ep.emits_q:
                # structural producer: the boundary tensor is int8
                y = quantize_act(y, keep_fp=ep.residual != "none")
        elif site.kind == "gap":
            y = _gap(act_fp(y))
        elif site.kind == "fc":
            y = _fc(p, act_fp(y))
            if site.act:
                y = hardswish(y)
        else:
            # the kernel runs the epilogue itself only for non-residual
            # sites; a residual producer quantizes after its fp add
            kernel_ep = ep if (ep is not None and ep.emits_q
                               and not site.residual) else None
            out = _dispatch(site, p, y, plan, program.cfg, attention_fn,
                            kernel_ep)
            if site.residual:
                s = act_fp(y) + act_fp(out)
                y = quantize_act(s, keep_fp=True) if (
                    ep is not None and ep.emits_q) else s
            else:
                y = out     # a QTensor when the kernel ran its epilogue
        if profile is not None:
            y = profile.end(site, y)
    return y


# ---------------------------------------------------------------------------
# manifest: IR -> hardware op records
# ---------------------------------------------------------------------------

def _mbconv_records(site: Site) -> list[OpRecord]:
    _, H, _, C = site.in_shape
    _, Ho, _, F = site.out_shape
    mid = site.attrs["mid"]
    n = site.local_name
    return [
        OpRecord(site.stage, f"{n}.pw1", "pw", H, H, C, mid),
        OpRecord(site.stage, f"{n}.dw", "dw", Ho, Ho, mid, mid, 3,
                 fused_with_prev=False),
        OpRecord(site.stage, f"{n}.pw2", "pw", Ho, Ho, mid, F,
                 fused_with_prev=True),
    ]


def _msa_records(site: Site) -> list[OpRecord]:
    _, r, _, c = site.in_shape
    heads, head_dim = site.attrs["heads"], site.attrs["head_dim"]
    scales = site.attrs["scales"]
    total = heads * head_dim
    n_tok = r * r
    n_scales = 1 + len(scales)
    pre = site.local_name[:-len(".msa")]         # "evit{bi}"
    ops = [OpRecord(site.stage, f"{pre}.qkv", "pw", r, r, c, 3 * total)]
    for s in scales:
        ops.append(OpRecord(site.stage, f"{pre}.agg{s}.dw", "dw", r, r,
                            3 * total, 3 * total, s))
        ops.append(OpRecord(site.stage, f"{pre}.agg{s}.pw", "group_pw",
                            r, r, head_dim, 3 * total, fused_with_prev=True))
    ops.append(OpRecord(site.stage, f"{pre}.ktv", "matmul",
                        n_scales * heads * head_dim, 1, n_tok, head_dim))
    ops.append(OpRecord(site.stage, f"{pre}.qz", "matmul",
                        n_scales * heads * n_tok, 1, head_dim,
                        head_dim + 1, fused_with_prev=True))
    ops.append(OpRecord(site.stage, f"{pre}.proj", "pw", r, r,
                        n_scales * total, c))
    return ops


def site_records(program: Program) -> list[Tuple[Site, list[OpRecord]]]:
    """Per-site hardware op records: ``[(site, [ops...]), ...]``; every
    ``fused_with_prev`` pairing lies within one site's list."""
    out: list[Tuple[Site, list[OpRecord]]] = []
    for site in program.sites:
        ops: list[OpRecord] = []
        if site.kind == "conv_bn":
            _, _, _, C = site.in_shape
            _, r, _, F = site.out_shape
            k = site.attrs.get("k", 1)
            ops.append(OpRecord(site.stage, site.local_name,
                                "conv" if k > 1 else "pw", r, r, C, F, k))
        elif site.kind == "dsconv":
            _, r, _, C = site.in_shape
            F = site.out_shape[-1]
            n = site.local_name
            ops.append(OpRecord(site.stage, f"{n}.dw", "dw", r, r, C, C, 3))
            ops.append(OpRecord(site.stage, f"{n}.pw", "pw", r, r, C, F,
                                fused_with_prev=True))
        elif site.kind == "mbconv":
            ops.extend(_mbconv_records(site))
        elif site.kind == "msa":
            ops.extend(_msa_records(site))
        elif site.kind == "fc":
            ops.append(OpRecord(site.stage, site.local_name, "matmul", 1, 1,
                                site.in_shape[-1], site.out_shape[-1]))
        out.append((site, ops))
    return out


def manifest(program: Program) -> list[OpRecord]:
    """Per-hardware-op records of one inference (batch excluded)."""
    return [op for _, ops in site_records(program) for op in ops]
