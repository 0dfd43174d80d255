"""Fusion planning: freeze per-site kernel routing for one ``Program``.

Counterpart of ``repro/core/fusion.py``.  ``plan_program`` runs ONE loop
over the lowered IR's fusible sites, consulting the kernel registry for
each: which precision the site's params support, which blocks (band
height, chunk, tile) to freeze, and whether one CTA of the Hopper kernel
fits in shared memory with them.  ``execute`` then dispatches by table
lookup.

Blocks come from each kernel's tuner (``KernelImpl.tune``): with
``autotune=True`` on the card a cold cache times the family's candidates
(``kernels.autotune``, CUDA events) and freezes the fastest; off the
card, with ``autotune=False`` or without a sweep, the first candidate,
the kernel's deterministic pick.  Sweeps run here, at plan time, never
inside a CUDA graph capture.  A quantized (``quantize_efficientvit``)
tree plans the FIX8 kernels, whose path rules tune nothing, and
``assign_epilogues`` then gives each producer of a fused int8 consumer
an int8 ``Epilogue`` (the int8 dataflow; ``epilogues=False`` keeps the
consumer-side quantize).  The super-site grouping pass
(``supersites=True``, the default as in JAX) then joins runs of
consecutive fused conv sites of one stage into single-launch groups.
``demote=`` forces named sites to the reference path (reason
``"fault"``), the serving degradation ladder's lever; ``overrides=``
(``SiteOverride``) pins a site's route, precision or blocks, and
``group_break`` splits a chain at a site.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

__all__ = ["SiteDecision", "SiteOverride", "GroupDecision", "FusionPlan",
           "build_plan", "plan_program", "plan_report", "report_dict",
           "launch_counts", "decision_shape",
           "assign_epilogues", "EXPECTED_B1_FUSED_LAUNCHES",
           "EXPECTED_B1_FUSED_LAUNCHES_INT8",
           "EXPECTED_B1_SUPERSITE_LAUNCHES",
           "EXPECTED_B1_SUPERSITE_LAUNCHES_INT8"]

# Drift gate: one fused launch per fusible site of EfficientViT-B1
# (1 stem DSConv + 2+3 MBConv + 2 downsamples + (3+4) x (MSA + MBConv)).
EXPECTED_B1_FUSED_LAUNCHES = 22
# FIX8: a fused int8 MSA site counts ``n_branches`` launches (the
# attention core + one grouped aggregation kernel per scale): 22 + 7.
EXPECTED_B1_FUSED_LAUNCHES_INT8 = 29
# The default plan groups B1's S1 [mb0, mb1] (-1 launch) and S2 [mb0,
# mb1, mb2] (-2) into one launch each; stem.ds0 is a run of one and the
# S3/S4 conv sites interleave with MSA sites.  The numbers above remain
# the ``supersites=False`` expectation.
EXPECTED_B1_SUPERSITE_LAUNCHES = 19           # 22 - 3
EXPECTED_B1_SUPERSITE_LAUNCHES_INT8 = 26      # 29 - 3


@dataclasses.dataclass(frozen=True)
class SiteDecision:
    name: str              # e.g. "S3.evit0.msa"
    kind: str              # dsconv | mbconv | msa
    fused: bool
    reason: str            # "ok" | "vmem" (does not fit in shared memory)
    #                        | "quantized" | "not-quantized" | "mixed"
    #                        | "disabled" | "fault" (demoted by the
    #                        degradation ladder) | "search" (pinned by a
    #                        ``SiteOverride``)
    blocks: Mapping[str, int] = dataclasses.field(default_factory=dict)
    #                        fp mbconv: {"block_rows", "block_m", "split"}
    #                        (band, mid chunk, CTAs per cluster); fp
    #                        dsconv: {"block_rows"}; msa:
    #                        {"block_n"}; int8 conv kinds: {}
    shape: tuple = ()      # (B, H, W, C, mid, F, stride) / (BH, N, D, S, C)
    precision: str = "fp"  # "fp" | "int8": which kernel family runs
    reused: bool = False   # blocks inherited from a donor plan
    epilogue: object = None   # core.program.Epilogue of this site's own
    #                           output (producer side); None -> fp
    q_in: bool = False     # the producer's epilogue delivers this site's
    #                        input quantized (an int8 boundary)
    group: str = ""        # super-site membership ("" = ungrouped)

    def to_dict(self) -> dict:
        """JSON-serializable form (JAX's ``SiteDecision.to_dict``)."""
        ep = self.epilogue
        return {
            "name": self.name, "kind": self.kind, "fused": self.fused,
            "reason": self.reason, "blocks": dict(self.blocks),
            "shape": list(self.shape), "precision": self.precision,
            "reused": self.reused, "q_in": self.q_in, "group": self.group,
            "epilogue": None if ep is None else {
                "out_dtype": ep.out_dtype, "scale": ep.scale,
                "residual": ep.residual},
        }


@dataclasses.dataclass(frozen=True)
class SiteOverride:
    """One site's entry in an externally supplied schedule.

    ``plan_program(overrides={name: SiteOverride})`` consults it before
    its own policy:

      ``fused=False``       pin the site to the reference path (reason
                            ``reason``, default ``"search"``);
      ``fused=True``/None   plan normally, with ``precision`` (when set)
                            as this site's requested precision and
                            ``blocks`` (when set) frozen verbatim: the
                            tuner is never consulted.

    The shared-memory fit still runs for a fused override, so an override
    chooses among launchable schedules only (one that does not fit gets
    ``"vmem"``).  ``group_break=True`` stops the super-site pass from
    extending a chain across this site (a chain may still start here).
    An override keyed by a super-site group's name (``"S1.ss0"``) with
    ``blocks`` freezes that chain's blocks (the port's fp chain tuner
    sweeps on the card; a schedule artifact pins its choice).
    """
    fused: bool | None = None
    precision: str | None = None      # None -> the plan-level request
    blocks: Mapping[str, int] | None = None   # None -> donor/tuner path
    reason: str = "search"
    group_break: bool | None = None

    @classmethod
    def from_decision(cls, d: "SiteDecision | dict") -> "SiteOverride":
        """Pin a frozen decision so replanning reproduces it.
        ``group_break`` is left unset: one decision cannot know its
        chain."""
        if isinstance(d, SiteDecision):
            d = d.to_dict()
        return cls(fused=bool(d["fused"]), precision=d.get("precision"),
                   blocks=dict(d.get("blocks") or {}),
                   reason=d.get("reason", "search"))

    def to_dict(self) -> dict:
        return {"fused": self.fused, "precision": self.precision,
                "blocks": None if self.blocks is None else dict(self.blocks),
                "reason": self.reason, "group_break": self.group_break}


@dataclasses.dataclass(frozen=True)
class GroupDecision:
    """One super-site group frozen into a plan: ``members`` name the
    consecutive conv sites the executor runs as ONE ``kernels/supersite``
    launch (``core.program.SuperSite.of`` re-derives the chain)."""
    name: str                 # e.g. "S1.ss0"
    members: tuple            # member site names, program order
    precision: str = "fp"     # uniform across the chain
    blocks: Mapping[str, int] = dataclasses.field(default_factory=dict)
    #                           fp: {"block_rows", "block_m"} (band,
    #                           DW-stage chunk); int8: {}
    shape: tuple = ()         # in_shape + out_shape of the chain
    reused: bool = False      # blocks inherited from a donor plan
    kind: str = "supersite"

    def to_dict(self) -> dict:
        return {"name": self.name, "members": list(self.members),
                "precision": self.precision, "blocks": dict(self.blocks),
                "shape": list(self.shape), "kind": self.kind}


@dataclasses.dataclass(frozen=True)
class FusionPlan:
    decisions: Mapping[str, SiteDecision]
    # producer-side output epilogues by site name, structural producers
    # (a quantized stem conv feeding a fused int8 DSConv) included
    epilogues: Mapping[str, object] = dataclasses.field(default_factory=dict)
    # super-site groups by name (member decisions carry ``group``)
    groups: Mapping[str, GroupDecision] = dataclasses.field(
        default_factory=dict)

    def get(self, name):
        return self.decisions.get(name)

    def n_fused(self) -> int:
        return sum(d.fused for d in self.decisions.values())


def decision_shape(site) -> tuple:
    """A ``Site`` -> the ``SiteDecision.shape`` tuple the accounting
    consumes: conv kinds (B, H, W, C, mid, F, stride); msa (BH, n_tok,
    head_dim, n_branches, channels)."""
    if site.kind == "msa":
        B, H, W, C = site.in_shape
        bh = site.attrs["n_branches"] * B * site.attrs["heads"]
        return (bh, H * W, site.attrs["head_dim"],
                site.attrs["n_branches"], C)
    if len(site.in_shape) == 4:
        B, H, W, C = site.in_shape
        return (B, H, W, C, site.attrs.get("mid", C), site.out_shape[-1],
                site.stride)
    return tuple(site.in_shape) + tuple(site.out_shape)


def _reusable_blocks(reuse, site, prec, impl):
    """Donor blocks for this site, or None if no safe donor exists.

    A donor qualifies when it fused the same-named site at the same
    precision with identical per-sample geometry (the decision shape
    without its leading batch axis); a family whose blocks follow the
    batch (``batch_dependent_tiles``) needs the exact shape."""
    d = reuse.get(site.name) if reuse is not None else None
    if (d is None or not d.fused or d.kind != site.kind
            or d.precision != prec):
        return None
    shape = decision_shape(site)
    if getattr(impl, "batch_dependent_tiles", False):
        if tuple(d.shape) != tuple(shape):
            return None
    elif tuple(d.shape[1:]) != tuple(shape[1:]):
        return None
    return dict(d.blocks)


def _decide(site, params, *, enabled, autotune, device, precision,
            reuse=None, override=None):
    from repro_torch.kernels.registry import get_kernel, get_probe

    shape = decision_shape(site)
    if override is not None and override.fused is False:
        return SiteDecision(site.name, site.kind, False, override.reason,
                            shape=shape,
                            precision=override.precision or "fp")
    if not enabled:
        return SiteDecision(site.name, site.kind, False, "disabled",
                            shape=shape)
    if override is not None and override.precision is not None:
        precision = override.precision
    probe = get_probe(site.kind)
    prec, fail = probe.resolve_precision(probe.site_precision(params),
                                         precision)
    if fail is not None:
        return SiteDecision(site.name, site.kind, False, fail, shape=shape)
    impl = get_kernel(site.kind, prec)
    reused = False
    if override is not None and override.blocks is not None:
        # frozen verbatim: the tuner is not consulted
        blocks = dict(override.blocks)
    else:
        blocks = _reusable_blocks(reuse, site, prec, impl)
        reused = blocks is not None
        if not reused:
            blocks = impl.tune(site, autotune=autotune, device=device)
    if impl.smem_bytes(site, blocks) > impl.smem_budget:
        return SiteDecision(site.name, site.kind, False, "vmem",
                            shape=shape, precision=prec)
    return SiteDecision(site.name, site.kind, True, "ok", blocks, shape,
                        precision=prec, reused=reused)


def _tree_device(tree):
    """The device of a param tree's first tensor (None for no tensor)."""
    if hasattr(tree, "device") and hasattr(tree, "dtype"):
        return tree.device
    values = tree.values() if isinstance(tree, dict) else \
        tree if isinstance(tree, (list, tuple)) else ()
    for v in values:
        d = _tree_device(v)
        if d is not None:
            return d
    return None


def plan_program(program, params, *, fuse_dsconv: bool = True,
                 fuse_mbconv: bool = True, fuse_msa: bool = True,
                 autotune: bool = True,
                 precision: str = "auto",
                 reuse: FusionPlan | None = None,
                 epilogues: bool = True,
                 demote=(),
                 overrides: Mapping[str, SiteOverride] | None = None,
                 supersites: bool = True) -> FusionPlan:
    """Freeze per-site routing for a lowered ``core.program.Program``.

    ``precision``: "auto" matches each site's params; "fp"/"int8" force
    one family and demote mismatched sites to the reference path.
    ``autotune`` (default on, as in JAX): where the params live on the
    card, a tuner whose cache has no entry times its candidates here
    (``kernels.autotune``); elsewhere, or with ``False``, each family's
    deterministic pick.  ``reuse``: a donor plan (another batch bucket
    at the same resolution); sites and groups whose geometry matches a
    fused donor decision inherit its blocks (``reused=True``) without a
    consultation.  ``epilogues`` (default on) runs ``assign_epilogues``;
    ``False`` assigns no epilogue and no ``q_in``, so each int8 consumer
    quantizes its own input.  ``supersites`` (on by default) runs the
    grouping pass last (``_group_supersites``); ``False`` keeps per-site
    launches.  ``overrides``: ``{site name: SiteOverride}``, consulted
    before the planner's own policy (see ``SiteOverride``); a
    ``group_break`` splits a chain at its site, and an entry under a
    group's name freezes that chain's blocks.  ``demote``: site names
    forced to the reference path with reason ``"fault"`` before any
    decision runs (the degradation ladder's lever); it wins over an
    override, and the grouping pass runs after it, so a demoted member
    leaves its group and the members around it regroup.  A failure
    inside one site's decision (a tuner's fault hook, a sweep, a probe)
    is re-raised as ``PlanError`` naming the site, an injected fault's
    ``injected`` flag kept.
    """
    from repro_torch.core.program import params_at

    if precision not in ("auto", "fp", "int8"):
        raise ValueError(f"precision must be auto|fp|int8, got {precision!r}")
    enabled = {"dsconv": fuse_dsconv, "mbconv": fuse_mbconv,
               "msa": fuse_msa}
    demote = frozenset(demote)
    overrides = overrides or {}
    device = _tree_device(params)
    decisions: dict[str, SiteDecision] = {}
    for site in program.fusible():
        if site.name in demote:
            decisions[site.name] = SiteDecision(
                site.name, site.kind, False, "fault",
                shape=decision_shape(site))
            continue
        try:
            decisions[site.name] = _decide(
                site, params_at(params, site.param_path),
                enabled=enabled.get(site.kind, True), autotune=autotune,
                device=device, precision=precision, reuse=reuse,
                override=overrides.get(site.name))
        except Exception as e:
            raise _plan_error(site.name, e) from e
    ep_map: dict = {}
    if epilogues:
        ep_map, q_in = assign_epilogues(program, params, decisions)
        for name, d in decisions.items():
            if name in ep_map or name in q_in:
                decisions[name] = dataclasses.replace(
                    d, epilogue=ep_map.get(name), q_in=name in q_in)
    groups = (_group_supersites(program, decisions, reuse, overrides,
                                autotune=autotune, device=device)
              if supersites else {})
    return FusionPlan(decisions=decisions, epilogues=ep_map, groups=groups)


def _plan_error(name, e):
    """``PlanError`` naming the site (a typed error's own site first),
    injected when the cause was."""
    from repro_torch.common.errors import PlanError, ReproError
    site = getattr(e, "site", None) if isinstance(e, ReproError) else None
    err = PlanError(f"planning {name} failed: {e}", site=site or name)
    err.injected = getattr(e, "injected", False)
    return err


def build_plan(params, cfg, *, batch: int = 1, image_size: int | None = None,
               fuse_dsconv: bool = True, fuse_mbconv: bool = True,
               fuse_msa: bool = True, autotune: bool = True,
               precision: str = "auto",
               epilogues: bool = True) -> FusionPlan:
    """Lower the config, then plan it: ``plan_program(lower(cfg, batch=,
    image_size=), params, ...)``."""
    from repro_torch.core.program import lower

    program = lower(cfg, batch=batch, image_size=image_size)
    return plan_program(program, params, fuse_dsconv=fuse_dsconv,
                        fuse_mbconv=fuse_mbconv, fuse_msa=fuse_msa,
                        autotune=autotune, precision=precision,
                        epilogues=epilogues)


def _group_blocks(sup, prec, reuse, gname, autotune, device,
                  override=None):
    """(blocks, reused) of a chain, or None when the chain fits no CTA.
    An override under the group's name with ``blocks`` freezes them
    verbatim (the tuner is not consulted; the fit still runs).  A donor
    group qualifies when it has the same name, members and precision and
    the exact shape: the fp band height follows the batch."""
    from repro_torch.kernels.registry import get_kernel

    impl = get_kernel("supersite", prec)
    if override is not None and override.blocks is not None:
        blocks = dict(override.blocks)
        if impl.smem_bytes(sup, blocks) > impl.smem_budget:
            return None
        return blocks, False
    g = reuse.groups.get(gname) if reuse is not None else None
    if (g is not None and g.members == sup.members and g.precision == prec
            and tuple(g.shape) == tuple(sup.in_shape) + tuple(sup.out_shape)):
        return dict(g.blocks), True
    try:
        blocks = impl.tune(sup, autotune=autotune, device=device)
    except Exception as e:
        raise _plan_error(sup.members[0], e) from e
    if blocks is None or impl.smem_bytes(sup, blocks) > impl.smem_budget:
        return None
    return blocks, False


def _group_supersites(program, decisions, reuse=None, overrides=None, *,
                      autotune=False, device=None):
    """The super-site pass: maximal runs of consecutive, same-stage,
    uniform-precision fused conv sites -> ``GroupDecision``s, each run as
    ONE ``kernels/supersite`` launch.

    Runs after epilogue assignment and updates ``decisions`` in place:
    members get ``group=<name>``; an fp site the per-site pass demoted for
    shared memory (``"vmem"``) is rescued into a group whose banded chain
    fits and becomes ``fused=True, reason="ok"``.  Any other demotion
    splits the run around the site, and so does an override's
    ``group_break`` (the chain may start at that site).  A chain whose
    tuner raises is reported by its first member (``PlanError``).
    """
    from repro_torch.core.program import SUPERSITE_KINDS, SuperSite

    overrides = overrides or {}
    groups: dict[str, GroupDecision] = {}
    counters: dict[str, int] = {}
    run: list = []                       # [(site, decision), ...]

    def member_decision(site):
        if site.kind not in SUPERSITE_KINDS:
            return None
        d = decisions.get(site.name)
        if d is None:
            return None
        if d.fused and d.reason == "ok":
            return d
        # only fp is rescued: an int8 site that did not fit alone does
        # not fit in a whole-map chain either
        if not d.fused and d.reason == "vmem" and d.precision == "fp":
            return d
        return None

    def flush():
        nonlocal run
        members, run = run, []
        if len(members) < 2:
            return
        names = tuple(s.name for s, _ in members)
        prec = members[0][1].precision
        stage = names[0].split(".", 1)[0]
        gname = f"{stage}.ss{counters.get(stage, 0)}"
        sup = SuperSite.of(program, names, name=gname)
        fit = _group_blocks(sup, prec, reuse, gname, autotune, device,
                            overrides.get(gname))
        if fit is None:
            return
        counters[stage] = counters.get(stage, 0) + 1
        groups[gname] = GroupDecision(
            gname, names, precision=prec, blocks=fit[0],
            shape=tuple(sup.in_shape) + tuple(sup.out_shape),
            reused=fit[1])
        for s, d in members:
            decisions[s.name] = dataclasses.replace(
                d, fused=True, reason="ok", group=gname)

    prev_stage = None
    for site in program.sites:
        d = member_decision(site)
        if d is None:
            flush()
            prev_stage = None
            continue
        ov = overrides.get(site.name)
        stage = site.name.split(".", 1)[0]
        if run and (bool(getattr(ov, "group_break", None))
                    or stage != prev_stage
                    or d.precision != run[0][1].precision):
            flush()
        run.append((site, d))
        prev_stage = stage
    flush()
    return groups


def assign_epilogues(program, params, decisions):
    """One pass over consecutive (producer, consumer) site pairs.

    A consumer takes an int8 input when it is a fused int8 site whose
    kernel consumes ``QTensor``s (``takes_q``) or a structural conv with
    quantized params; a producer can emit one when it is a fused int8
    site whose kernel family quantizes its output (``emits_q``) or a
    structural quantized conv.  When both hold, the producer gets an
    ``Epilogue("int8", "dynamic", residual)``: ``"post-add"`` when the
    producer is residual (its fp add runs first), ``"keep-fp"`` when the
    consumer is (its fp add needs the fp activation), else ``"none"``.
    Returns ``(epilogues by site name, names whose input arrives int8)``.
    """
    from repro_torch.core.program import Epilogue, params_at
    from repro_torch.kernels.registry import get_kernel

    def quantized_conv(site):
        if site.kind != "conv_bn" or not site.param_path:
            return False
        p = params_at(params, site.param_path)
        return isinstance(p, dict) and "qconv" in p

    def fused_int8(site, flag):
        d = decisions.get(site.name)
        return (d is not None and d.fused and d.precision == "int8"
                and getattr(get_kernel(site.kind, "int8"), flag, False))

    def consumes_q(site):
        return (quantized_conv(site) if site.kind == "conv_bn"
                else fused_int8(site, "takes_q"))

    def emits_q(site):
        return (quantized_conv(site) if site.kind == "conv_bn"
                else fused_int8(site, "emits_q"))

    epilogues: dict[str, object] = {}
    q_in: set[str] = set()
    for prod, cons in zip(program.sites, program.sites[1:]):
        if not (consumes_q(cons) and emits_q(prod)):
            continue
        residual = ("post-add" if prod.residual
                    else "keep-fp" if cons.residual else "none")
        epilogues[prod.name] = Epilogue("int8", "dynamic", residual)
        q_in.add(cons.name)
    return epilogues, q_in


# ---------------------------------------------------------------------------
# analytic accounting (device memory bytes + launch counts per site)
# ---------------------------------------------------------------------------

def _mbconv_bytes(B, H, W, C, mid, F, stride, precision="fp"):
    """Activation bytes: unfused = every op round-trips device memory
    (fp32 either way: the reference FIX8 chain dequantizes between ops);
    fused = x in once (int8 for the FIX8 kernel), out once (fp32)."""
    Ho, Wo = H // stride, W // stride
    xn, midn = B * H * W * C, B * H * W * mid
    dwn, outn = B * Ho * Wo * mid, B * Ho * Wo * F
    return ((xn + 2 * midn + 2 * dwn + outn) * 4,
            xn * (1 if precision == "int8" else 4) + outn * 4)


def _dsconv_bytes(B, H, W, C, F, precision="fp"):
    xn, outn = B * H * W * C, B * H * W * F
    return ((3 * xn + outn) * 4,
            xn * (1 if precision == "int8" else 4) + outn * 4)


def _msa_bytes(BH, N, D):
    """Attention-core traffic, all branches/heads folded: the unfused
    dataflow materializes ReLU(Q)/ReLU(K), the state, numerator and
    divisor; the fused kernel reads Q/K/V once and writes once."""
    u = BH * N * D * 4
    state = BH * (D * D + D) * 4
    den = BH * N * 4
    return 3 * u + 4 * u + 2 * state + 2 * u + 2 * den + u, 4 * u


def _weight_bytes(kind, shape, precision) -> int:
    if kind == "mbconv":
        _, _, _, C, mid, F, _ = shape
        n = C * mid + 9 * mid + mid * F
    elif kind == "dsconv":
        _, _, _, C, _, F, _ = shape
        n = 9 * C + C * F
    else:
        _, _, _, n_branches, C = shape
        n = 3 * C * C + n_branches * C * C
    return n * (1 if precision == "int8" else 4)


def _site_accounting(kind, shape, precision):
    """(bytes unfused, bytes fused, weight bytes, (launches ref, fused)).
    A fused int8 MSA site launches the attention core and one grouped
    aggregation kernel per scale: ``n_branches`` launches."""
    if kind == "mbconv":
        unf, fus = _mbconv_bytes(*shape, precision)
        launches = (3, 1)
    elif kind == "dsconv":
        B, H, W, C, _, F, _ = shape
        unf, fus = _dsconv_bytes(B, H, W, C, F, precision)
        launches = (2, 1)
    elif kind == "msa":
        BH, N, D, n_branches = shape[:4]
        unf, fus = _msa_bytes(BH, N, D)
        launches = (2 * n_branches,
                    n_branches if precision == "int8" else 1)
    else:
        return 0, 0, 0, (1, 1)
    return unf, fus, _weight_bytes(kind, shape, precision), launches


def _delivered_bytes(d, unf, fus):
    """Activation bytes the executed program moves at a conv site, from
    the epilogue assignments: the input is 1 byte/element only when the
    producer's epilogue emitted it; the output is what the site's own
    epilogue writes: int8 (1), fp (4), or both (5)."""
    if not d.fused or d.kind not in ("mbconv", "dsconv"):
        return fus if d.fused else unf
    B, H, W, C, _, F, stride = d.shape
    outn = (B * (H // stride) * (W // stride) * F if d.kind == "mbconv"
            else B * H * W * F)
    ep = d.epilogue
    out_b = (outn * 4 if ep is None or not ep.emits_q
             else outn * (1 + (4 if ep.keeps_fp else 0)))
    return B * H * W * C * (1 if d.q_in else 4) + out_b


def _group_delivered(d, first: bool, last: bool) -> int:
    """Activation bytes a super-site member moves: the chain's entry
    boundary on its first member, the exit boundary (per the exit
    epilogue) on its last, nothing in between (on chip)."""
    B, H, W, C, _, F, stride = d.shape
    delivered = B * H * W * C * (1 if d.q_in else 4) if first else 0
    if last:
        outn = (B * (H // stride) * (W // stride) * F if d.kind == "mbconv"
                else B * H * W * F)
        ep = d.epilogue
        delivered += (outn * 4 if ep is None or not ep.emits_q
                      else outn * (1 + (4 if ep.keeps_fp else 0)))
    return delivered


def plan_report(plan: FusionPlan) -> list[dict]:
    """Per-site analytic device-memory bytes (unfused, fused, delivered
    under the plan's epilogues), weight bytes and launch counts.

    A super-site group's one launch lands on its FIRST member's row (0
    on the others); its delivered bytes are the chain's entry on the
    first member and its exit on the last.  ``hbm_w`` stays per member:
    the pack holds each member's weights once."""
    first_of = {g.members[0] for g in plan.groups.values()}
    last_of = {g.members[-1] for g in plan.groups.values()}
    rows = []
    for d in plan.decisions.values():
        unf, fus, w_bytes, launches = _site_accounting(d.kind, d.shape,
                                                       d.precision)
        if d.group and d.kind in ("mbconv", "dsconv"):
            launches_fused = int(d.name in first_of)
            delivered = _group_delivered(d, d.name in first_of,
                                         d.name in last_of)
        else:
            launches_fused = launches[1] if d.fused else launches[0]
            delivered = _delivered_bytes(d, unf, fus)
        rows.append({
            "site": d.name, "kind": d.kind, "fused": d.fused,
            "reason": d.reason, "precision": d.precision, "group": d.group,
            "hbm_unfused": unf, "hbm_fused": fus if d.fused else unf,
            "hbm_w": w_bytes, "hbm_delivered": delivered,
            "q_in": d.q_in, "epilogue": d.epilogue,
            "launches_ref": launches[0], "launches_fused": launches_fused,
        })
    return rows


def report_dict(plan: FusionPlan) -> list[dict]:
    """``plan_report`` with every value JSON-serializable: the
    ``epilogue`` column as a plain dict (``SiteDecision.to_dict``'s
    form)."""
    rows = []
    for r in plan_report(plan):
        ep = r["epilogue"]
        rows.append({**r, "epilogue": None if ep is None else {
            "out_dtype": ep.out_dtype, "scale": ep.scale,
            "residual": ep.residual}})
    return rows


def launch_counts(plan: FusionPlan) -> dict:
    rep = plan_report(plan)
    return {"reference": sum(r["launches_ref"] for r in rep),
            "fused": sum(r["launches_fused"] for r in rep)}
