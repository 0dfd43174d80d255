"""Cycle-level performance model of the paper's FPGA accelerator.

Counterpart of ``repro/core/accelerator_model.py``: pure arithmetic over
the port's ``lower`` / ``manifest`` / ``site_records``, so its rows equal
JAX's float for float.  The cycles and milliseconds it predicts are the
paper's FPGA's (200 MHz, ZCU102), not the H100's; ``obs.profile`` sets
them beside measured device time.

Reproduces the hardware of §III/§IV: L parallel processing groups (PGs),
each with an RPE engine (M PE lines x N MACs, DW- or PW-mode) and a MAT
engine (S MAT lines x T multipliers), plus the K-adder-tree/divider path
for MSA.  The TMP dataflow (Fig. 5) is modeled as a two-resource schedule:

* DW-mode (self-accumulation): M lines hold M consecutive output pixels,
  N MACs per line hold N channels; a k x k window drains in k^2 cycles.
* PW-mode / MAT (down-forward accumulation): reduction parallelism is the
  *input-channel* dimension only (width N or T); the k x k spatial taps of
  a generic Conv are temporal.  This is why the 3-channel first conv can
  only use 3/8 of the multipliers = 37.5% (Fig. 6 observation (1)).
* Inter-layer fusion: a DWConv runs on the RPE while its successor PWConv
  starts on the MAT from the streamed outputs; when the DW drains, the
  RPE joins the PW (paper: "it can join the computation of the concurrent
  PWConv").
* Intra-layer MSA fusion: ReLU(K)^T V runs on the RPE while the
  K-adder-tree does the rowsum for free; ReLU(Q) @ [Z | ksum] runs
  concurrently on the MAT; divisions happen in post-processing.

The model consumes op records expanded from the program IR
(``core.program.lower`` + ``manifest`` — the same lowering the
forward executes), so Fig. 6 / Table II numbers trace to the same source
of truth as the model that runs.  DRAM traffic is modeled at int8 with
double-buffered overlap (cycles = max(compute, memory)); fusion removes
intermediate round-trips.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from repro_torch.core.efficientvit import B1, EfficientViTConfig, OpRecord
from repro_torch.core.program import Program, lower, manifest


@dataclasses.dataclass(frozen=True)
class HwConfig:
    M: int = 8            # RPE PE lines
    N: int = 8            # MACs per RPE line
    S: int = 8            # MAT lines
    T: int = 8            # multipliers per MAT line
    L: int = 16           # processing groups
    freq_hz: float = 200e6
    dram_gbps: float = 19.2       # ZCU102 DDR4 effective
    power_w: float = 7.43          # paper Table II measurement
    dsp_used: int = 1024
    # On-chip activation budget (ping-pong buffers A/C of Fig. 4).  Feature
    # maps at or under this size stay resident between layers; larger ones
    # round-trip DRAM.  ZCU102 used 160 BRAM36 (~720 KB total incl. weights).
    act_buffer_bytes: int = 512 * 1024

    @property
    def rpe_mults(self) -> int:
        return self.M * self.N * self.L

    @property
    def mat_mults(self) -> int:
        return self.S * self.T * self.L

    @property
    def total_mults(self) -> int:
        return self.rpe_mults + self.mat_mults

    @property
    def peak_gops(self) -> float:
        return self.total_mults * 2 * self.freq_hz / 1e9

    @property
    def bytes_per_cycle(self) -> float:
        return self.dram_gbps * 1e9 / self.freq_hz


@dataclasses.dataclass
class ScheduledOp:
    name: str
    stage: str
    macs: int
    compute_cycles: float
    dram_bytes: float
    cycles: float          # max(compute, memory)
    fused: bool

    @property
    def util(self) -> float:
        return 0.0 if self.cycles == 0 else self.macs / (self.cycles * 2048)


# ---------------------------------------------------------------------------
# per-engine cycle primitives
# ---------------------------------------------------------------------------

def _dw_cycles(op: OpRecord, hw: HwConfig, pgs: int) -> float:
    """DW mode on the RPE: k^2 cycles per (M pixels x N channels) block.

    The (channel-block x pixel-block) grid is spread across the ``pgs``
    processing groups, so small feature maps (e.g. S4's 7x7) still engage
    every PG via channel blocks.
    """
    pixels = op.h * op.w
    blocks = math.ceil(op.c_out / hw.N) * math.ceil(pixels / hw.M)
    return op.k * op.k * math.ceil(blocks / pgs)


def _pw_cycles(op: OpRecord, width: int, lines: int) -> float:
    """PW mode / MAT: reduction over input channels at ``width`` per cycle;
    spatial taps temporal; ``lines`` outputs in flight."""
    outputs = op.h * op.w * op.c_out
    red = op.c_in  # channel reduction (group_pw: channels-per-group)
    spatial = op.k * op.k if op.kind == "conv" else 1
    return spatial * math.ceil(red / width) * math.ceil(outputs / lines)


def _op_io_bytes(op: OpRecord):
    """(weight_bytes, input_bytes, output_bytes) at int8."""
    if op.kind == "dw":
        weights = op.c_out * op.k * op.k
        inp = op.h * op.w * op.c_out  # halo ignored
    elif op.kind == "conv":
        weights = op.k * op.k * op.c_in * op.c_out
        inp = op.h * op.w * op.c_in
    elif op.kind == "group_pw":
        weights = op.c_in * op.c_out
        inp = op.h * op.w * op.c_out
    else:  # pw / matmul
        weights = op.c_in * op.c_out
        inp = op.h * op.w * op.c_in
    out = op.h * op.w * op.c_out
    return float(weights), float(inp), float(out)


def _op_dram_bytes(op: OpRecord, hw: HwConfig, *, skip_in=False,
                   skip_out=False, act_mult: float = 1.0,
                   w_mult: float = 1.0) -> float:
    """DRAM traffic: weights always stream; activations only when the
    feature map exceeds the on-chip ping-pong budget (or fusion skips it).

    ``act_mult`` / ``w_mult`` scale the int8 baseline to other storage
    precisions (4.0 = fp32) — the lever the offline schedule search uses
    to cost per-site precision decisions; the defaults keep the paper's
    all-int8 model (fig6/table2) byte-identical.  The on-chip residency
    test stays at the int8 element count: precision changes what a
    round-trip costs, not the paper's buffer-fit policy.
    """
    weights, inp, out = _op_io_bytes(op)
    if skip_in or inp <= hw.act_buffer_bytes:
        inp = 0.0
    if skip_out or out <= hw.act_buffer_bytes:
        out = 0.0
    return weights * w_mult + (inp + out) * act_mult


# ---------------------------------------------------------------------------
# TMP schedule
# ---------------------------------------------------------------------------

def _fused_pair_cycles(producer: OpRecord, consumer: OpRecord,
                       hw: HwConfig) -> float:
    """Producer on RPE; consumer starts on MAT, RPE joins when drained.

    Solves  S*L/cpo * t  +  M*L/cpo * max(0, t - t1)  >=  outputs.
    """
    if producer.kind == "dw":
        t1 = _dw_cycles(producer, hw, hw.L)
    else:  # matmul producer (ReLU(K)^T V) runs in PW mode on the RPE
        t1 = _pw_cycles(producer, hw.N, hw.M * hw.L)
    outputs = consumer.h * consumer.w * consumer.c_out
    spatial = consumer.k * consumer.k if consumer.kind == "conv" else 1
    cpo = spatial * math.ceil(consumer.c_in / hw.T)
    mat_rate = hw.S * hw.L / cpo          # outputs per cycle on MAT
    rpe_rate = hw.M * hw.L / cpo          # once joined
    t_mat_only = outputs / mat_rate
    if t_mat_only <= t1:
        # consumer drains no faster than producer feeds it
        return t1
    rem = outputs - mat_rate * t1
    return t1 + rem / (mat_rate + rpe_rate)


def schedule(ops: Sequence[OpRecord], hw: HwConfig = HwConfig(), *,
             fuse: bool = True, act_mult: float = 1.0,
             w_mult: float = 1.0) -> list[ScheduledOp]:
    """Schedule the manifest; returns per-(fused-)op cycles and traffic.

    ``act_mult``/``w_mult`` pass through to the DRAM model (int8
    baseline = 1.0); compute cycles are precision-independent — the
    PE/MAT arrays run at one MAC per multiplier per cycle either way.
    """
    out: list[ScheduledOp] = []
    mults = dict(act_mult=act_mult, w_mult=w_mult)
    i = 0
    while i < len(ops):
        op = ops[i]
        nxt: Optional[OpRecord] = ops[i + 1] if i + 1 < len(ops) else None
        if fuse and nxt is not None and nxt.fused_with_prev:
            cyc = _fused_pair_cycles(op, nxt, hw)
            macs = op.macs + nxt.macs
            dram = (_op_dram_bytes(op, hw, skip_out=True, **mults)
                    + _op_dram_bytes(nxt, hw, skip_in=True, **mults))
            total = max(cyc, dram / hw.bytes_per_cycle)
            out.append(ScheduledOp(f"{op.name}+{nxt.name}", op.stage, macs,
                                   cyc, dram, total, True))
            i += 2
            continue
        if op.kind == "dw":
            cyc = _dw_cycles(op, hw, hw.L)   # MAT idles: DW is RPE-only
        else:
            # both engines in PW mode (widths equal: N == T)
            cyc = _pw_cycles(op, hw.N, (hw.M + hw.S) * hw.L)
        dram = _op_dram_bytes(op, hw, **mults)
        total = max(cyc, dram / hw.bytes_per_cycle)
        out.append(ScheduledOp(op.name, op.stage, op.macs, cyc, dram, total,
                               False))
        i += 1
    return out


@dataclasses.dataclass
class Report:
    total_macs: int
    total_cycles: float
    dram_bytes: float
    hw: HwConfig

    @property
    def latency_ms(self) -> float:
        return self.total_cycles / self.hw.freq_hz * 1e3

    @property
    def gops(self) -> float:
        return 2 * self.total_macs / (self.total_cycles / self.hw.freq_hz) / 1e9

    @property
    def utilization(self) -> float:
        return self.gops / self.hw.peak_gops

    @property
    def gops_per_w(self) -> float:
        return self.gops / self.hw.power_w

    @property
    def gops_per_dsp(self) -> float:
        return self.gops / self.hw.dsp_used

    def to_dict(self) -> dict:
        """Machine-readable summary (JSON-serializable plain types)."""
        return {
            "total_macs": int(self.total_macs),
            "total_cycles": float(self.total_cycles),
            "dram_bytes": float(self.dram_bytes),
            "latency_ms": self.latency_ms,
            "gops": self.gops,
            "utilization": self.utilization,
            "gops_per_w": self.gops_per_w,
            "gops_per_dsp": self.gops_per_dsp,
        }


def analyze_program(program: Program, hw: HwConfig = HwConfig(), *,
                    fuse: bool = True, include_head: bool = False):
    """IR pipeline: Program -> manifest -> schedule -> (report, per-stage,
    per-op).  The cycle model and the forward consume the SAME
    lowering, so fig6/table2 numbers cannot drift from what runs.

    ``include_head=False`` matches the paper's evaluation scope: Fig. 6
    covers "a generic Conv, a DSConv layer, and four stages (S1-S4)" —
    the classification head (batch-1, DRAM-bound FC matmuls) is not part
    of the accelerator workload.

    The model's DRAM traffic assumes int8 activations throughout — the
    steady-state the epilogue dataflow now delivers.  When ``program``
    is plan-annotated (``Program.with_epilogues``), the one divergence
    from that ideal is charged explicitly: a site whose epilogue keeps
    the fp activation alongside the int8 one (the residual-fp policies)
    moves 4 extra bytes/element at its boundary whenever that feature
    map exceeds the on-chip budget.  Un-annotated programs (fig6/table2)
    carry no epilogues and are unchanged.
    """
    ops = manifest(program)
    if not include_head:
        ops = [o for o in ops if o.stage != "head"]
    sched = schedule(ops, hw, fuse=fuse)
    residual_fp_bytes = sum(
        4.0 * s.out_shape[1] * s.out_shape[2] * s.out_shape[3]
        for s in program.sites
        if s.epilogue.emits_q and s.epilogue.residual != "none"
        and (include_head or s.stage != "head")
        and s.out_shape[1] * s.out_shape[2] * s.out_shape[3]
        > hw.act_buffer_bytes)
    rep = Report(sum(s.macs for s in sched),
                 sum(s.cycles for s in sched),
                 sum(s.dram_bytes for s in sched) + residual_fp_bytes, hw)
    stages: dict[str, dict] = {}
    for s in sched:
        st = stages.setdefault(s.stage, {"macs": 0, "cycles": 0.0, "dram": 0.0})
        st["macs"] += s.macs
        st["cycles"] += s.cycles
        st["dram"] += s.dram_bytes
    for st in stages.values():
        st["util"] = st["macs"] / (st["cycles"] * hw.total_mults)
        st["latency_ms"] = st["cycles"] / hw.freq_hz * 1e3
    return rep, stages, sched


def site_breakdown(program: Program, hw: HwConfig = HwConfig(), *,
                   plan=None, include_head: bool = False,
                   default_precision: str = "int8") -> list[dict]:
    """Per-``Site`` machine-readable cycle/DRAM rows under a plan.

    Each row re-costs one site's op group with the site's OWN routing
    decision instead of the paper's global all-fused/all-int8
    assumption:

      * a ``FusionPlan`` decision with ``fused=False`` schedules the
        site's ops unfused (every ``fused_with_prev`` pairing broken);
      * the decided precision scales DRAM traffic — int8 weights move
        1 byte/element, fp32 weights 4; activations cost 1 byte only on
        a *fused int8* site (the producer-emitted boundary), and fp32
        everywhere else, including demoted int8 sites whose reference
        chain dequantizes between ops (matching ``core.fusion``'s
        analytic accounting);
      * a site whose epilogue keeps the fp activation alongside the
        int8 one is charged the residual-fp boundary bytes (as
        ``analyze_program`` does), memory-bound.

    Sites outside the plan (structural convs, the head, ``plan=None``)
    cost at ``default_precision`` fully fused — ``"int8"`` (default)
    reproduces ``analyze_program``'s totals exactly when no plan is
    given; the offline schedule search passes the serving precision so
    fp and int8 candidate schedules are comparable.

    Super-site members (``SiteDecision.group`` set by the planner's
    grouping pass) keep their per-site compute/DRAM rows — the chain
    does the same MACs — but the group's ONE launch lands on the first
    member's row (0 for the rest), and the member rows carry ``blocks:
    {}``: the chain kernel bands over output rows itself, so the
    member's per-site tile choice no longer runs (the search evaluator
    scores the launch delta, not stale per-site tiling overcompute).

    Scheduling each site separately is exact, not an approximation:
    ``core.program.site_records`` guarantees no fused pair spans a site
    boundary.  This is the evaluator surface of the search subsystem —
    and the machine-readable twin of the per-op table fig6 prints.
    """
    from repro_torch.core.program import site_records

    assert default_precision in ("fp", "int8"), default_precision
    groups = getattr(plan, "groups", None) or {}
    group_first = {g.members[0] for g in groups.values()}
    rows: list[dict] = []
    for site, ops in site_records(program):
        if not include_head and site.stage == "head":
            continue
        d = plan.get(site.name) if plan is not None else None
        fused = d.fused if d is not None else True
        prec = d.precision if d is not None else default_precision
        act_mult = 1.0 if (fused and prec == "int8") else 4.0
        w_mult = 1.0 if prec == "int8" else 4.0
        sched = schedule(ops, hw, fuse=fused, act_mult=act_mult,
                         w_mult=w_mult)
        dram = sum(s.dram_bytes for s in sched)
        cycles = sum(s.cycles for s in sched)
        ep = site.epilogue
        if ep.emits_q and ep.residual != "none":
            n = site.out_shape[1] * site.out_shape[2] * site.out_shape[3]
            if n > hw.act_buffer_bytes:
                extra = 4.0 * n
                dram += extra
                cycles += extra / hw.bytes_per_cycle
        grouped = d is not None and bool(getattr(d, "group", ""))
        rows.append({
            "site": site.name, "kind": site.kind, "stage": site.stage,
            "fused": bool(fused), "precision": prec,
            "reason": d.reason if d is not None else "-",
            "blocks": {} if grouped else (
                dict(d.blocks) if d is not None else {}),
            "group": d.group if grouped else "",
            # scheduled op groups = launches: fusion merges paired ops
            # into one, the reference path launches every op separately;
            # a super-site member's launch collapses onto the first row
            "launches": (1 if site.name in group_first else 0) if grouped
            else len(sched),
            "macs": int(sum(s.macs for s in sched)),
            "compute_cycles": float(sum(s.compute_cycles for s in sched)),
            "dram_bytes": float(dram),
            "cycles": float(cycles),
        })
    return rows


def analyze(cfg: EfficientViTConfig = B1, hw: HwConfig = HwConfig(), *,
            fuse: bool = True, include_head: bool = False):
    """Back-compat shim: lower the config and analyze the program."""
    return analyze_program(lower(cfg), hw, fuse=fuse,
                           include_head=include_head)


# Paper Table II reference rows, for the comparison benchmark.
TABLE_II = {
    "EfficientViT [8] (CPU)": dict(gops=54.7, power=11.0, eff=4.97),
    "ViA [16] (Alveo U50)": dict(gops=309.6, power=39.0, eff=7.92),
    "Auto-ViT-Acc [17] (ZCU102)": dict(gops=711.2, power=8.46, eff=84.1),
    "Paper (ZCU102)": dict(gops=780.2, power=7.43, eff=105.1),
}
