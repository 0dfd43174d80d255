#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed N]

1. Set-up: exits non-zero without a CUDA card or without the port's
   package beside this script; prints the card's name and power limit;
   builds every kernel from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together) and prints each kernel's register and
   shared-memory use.
2. fp32 phase.
   a. Each fp32 kernel against its plain PyTorch version on the card, at
      every distinct shape of the B1@224 main path at batch 1 and 8:
      ``max|d| <= 1e-4 * max(1, max|ref|)``.  Times are device times
      from CUDA events over back-to-back launches (inputs warm in L2),
      median of 5 windows; the bound is max(bytes / 3.35 TB/s, flops /
      67 TFLOP/s), the H100 SXM's published memory rate and non-tensor
      fp32 rate, with each input read once and each output written once.
      The super-site chain kernel ``supersite_fused`` runs at the two
      chains of B1@224 (S1.ss0 = S1.mb0..mb1, S2.ss0 = S2.mb0..mb2) with
      the band height and channel chunk the planner picks; its bound
      counts the chain's input, output and weight pack once and the
      members' MACs without the bands' halo recompute.  A sweep times
      it at band heights 1, 2, 4 and chunks 16, 32 beside the choice.
   b. ``VisionEngine`` over B1@224 fp32 (random weights and BN
      statistics from ``--seed``, microbatch 8) serves 12 requests with
      mixed deadlines through its scheduler, on the default plan, which
      groups exactly S1.ss0 and S2.ss0 in every bucket (their blocks,
      band windows and recompute factors are printed).  Every launch
      counter is reset just before and read just after: each dispatched
      forward must launch dsconv_fused 1x, mbconv_fused 9x,
      relu_attn_noncausal 7x and supersite_fused 2x.  The logits must
      match the port's reference forward (``execute`` with ``plan=None``)
      on the card within rtol = atol = 1e-3, with the same top-1.  Each
      group's weight pack is built once per engine and hit by every
      later bucket.  One batch-8 forward under the per-site plan
      (``supersites=False``) must match the grouped one within 1e-4 *
      max(1, max|logit|), with the same top-1.
3. FIX8 phase.
   a. Each int8 kernel against its plain PyTorch version at every B1@224
      int8 shape on the path, batch 1 and 8, on random int8 codes: the
      int8 outputs and the fp32 outputs must be EQUAL (both round every
      fp32 step in the same order).  The bound is max(bytes / 3.35 TB/s,
      int8 ops / 1,979 TOPS); ``int8_matmul`` is also timed against
      ``torch._int_mm`` + the same epilogue, a yardstick the port never
      calls.  ``supersite_fused_int8`` runs both chains with the served
      exit (int8 codes + scales + the kept fp map).
   b. ``VisionEngine.quantized`` over the same fp tree, quantized by the
      port, serves the same trace on the default plan (S1.ss0 and S2.ss0
      grouped).  Counters reset just before, read just after: each
      forward must launch int8_matmul 14x, group_agg_int8 7x,
      mbconv_fused_int8 7x, mbconv_fused_int8_emit 2x, dsconv_fused_int8
      1x, relu_attn_noncausal 7x and supersite_fused_int8 2x.  The logits
      must have the top-1 of the port's int8 reference forward and lie
      within 0.1 * max|logit| of it (the int8 requants turn the fp32
      attention core's reduction-order ulps into whole-code flips; the
      measured gap is printed), row i of a batch-8 forward must equal the
      batch-1 forward of image i bit for bit, and the batch-8 forward
      under the per-site plan must equal the grouped one bit for bit.
      Pack residency as in 2b.
4. One JSON line with every kernel's launches on its served run(s),
   error and times (ms are per B1@224 batch-8 forward: the sum over
   that forward's calls).
5. The last line: ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

PEAK_BYTES_PER_S = 3.35e12    # H100 SXM HBM3 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32, non-tensor (data sheet)
PEAK_INT8_OPS = 1979e12       # H100 SXM int8 tensor cores, dense
TOL = 1e-4
CHAOS = 0.1                   # FIX8 served logits vs the int8 reference
# the default plan's super-site groups at B1@224, both precisions
GROUPS = {"S1.ss0": ("S1.mb0", "S1.mb1"),
          "S2.ss0": ("S2.mb0", "S2.mb1", "S2.mb2")}
GROUPED = {m for members in GROUPS.values() for m in members}


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def device_ms(fn, reps: int = 20, windows: int = 5) -> float:
    """Median over ``windows`` of the mean device time of ``reps``
    back-to-back calls, from CUDA events.  A sleep kernel queued first
    keeps the card busy while the host enqueues the calls, so host
    overhead between launches does not count."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (1.5 * host_s + 1e-3)))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / reps)
    return statistics.median(out)


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_FP32_FLOPS
          ) -> tuple[float, str]:
    t_b, t_f = nbytes / PEAK_BYTES_PER_S, ops / peak_ops
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations")


def kernel_cases(batch: int, gen):
    """(kernel, site names, shape label, kernel fn, plain fn, bytes,
    flops) for every distinct fused shape of B1@224 at ``batch``.  The
    names are the sites whose per-site launch the served (grouped) plan
    makes; a shape only the super-site members have is still checked,
    with no site to its name (the per-site plan launches it)."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import decision_shape
    from repro_torch.core.program import lower
    from repro_torch.kernels.dsconv.kernel import dsconv_fused
    from repro_torch.kernels.dsconv.ref import dsconv_ref
    from repro_torch.kernels.mbconv.kernel import mbconv_fused
    from repro_torch.kernels.mbconv.ref import mbconv_ref
    from repro_torch.kernels.relu_attn.kernel import relu_attn_noncausal
    from repro_torch.kernels.relu_attn.ref import relu_attn_noncausal_ref

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).cuda()

    groups: dict = {}
    for site in lower(B1, batch=batch).fusible():
        groups.setdefault((site.kind, decision_shape(site)), []).append(site)
    cases = []
    for (kind, shape), sites in groups.items():
        s = sites[0]
        names = [x.name for x in sites if x.name not in GROUPED]
        if kind == "dsconv":
            B, H, W, C, _, F, st = shape
            x, dw, db = rnd(B, H, W, C), rnd(3, 3, C, scale=1 / 3), rnd(C)
            pw, pb = rnd(C, F, scale=C ** -0.5), rnd(F)
            args = (x, dw, db, pw, pb)
            kfn = lambda a=args, st=st: dsconv_fused(*a, stride=st)
            pfn = lambda a=args, st=st: dsconv_ref(*a, stride=st)
            nbytes = 4 * (x.numel() + dw.numel() + db.numel() + pw.numel()
                          + pb.numel() + B * (H // st) * (W // st) * F)
            flops = 2 * B * (H // st) * (W // st) * (9 * C + C * F)
            label = f"x{tuple(x.shape)} F={F} s={st}"
            name = "dsconv_fused"
        elif kind == "mbconv":
            B, H, W, C, M, F, st = shape
            Ho, Wo = H // st, W // st
            x = rnd(B, H, W, C)
            w1, b1 = rnd(C, M, scale=C ** -0.5), rnd(M)
            dw, db = rnd(3, 3, M, scale=1 / 3), rnd(M)
            w2, b2 = rnd(M, F, scale=M ** -0.5), rnd(F)
            args = (x, w1, b1, dw, db, w2, b2)
            kfn = lambda a=args, st=st: mbconv_fused(*a, stride=st)
            pfn = lambda a=args, st=st: mbconv_ref(*a, stride=st)
            nbytes = 4 * (sum(t.numel() for t in args) + B * Ho * Wo * F)
            flops = 2 * B * (H * W * C * M + Ho * Wo * M * (9 + F))
            label = f"x{tuple(x.shape)} M={M} F={F} s={st}"
            name = "mbconv_fused"
        else:
            B, H, W, C = s.in_shape
            heads, d = s.attrs["heads"], s.attrs["head_dim"]
            G, N, T = s.attrs["n_branches"] * B, H * W, heads * d
            t = rnd(G, N, 3 * T).reshape(G, N, 3, heads, d)
            args = (t[:, :, 0], t[:, :, 1], t[:, :, 2])
            kfn = lambda a=args: relu_attn_noncausal(*a)
            pfn = lambda a=args: relu_attn_noncausal_ref(*a)
            nbytes = 4 * 4 * G * N * T
            flops = G * heads * (4 * N * d * d + 3 * N * d)
            label = f"qkv({G},{N},3x{heads}x{d})"
            name = "relu_attn_noncausal"
        cases.append((name, names, label, kfn, pfn, nbytes, flops))
    return cases




def int8_kernel_cases(batch: int, gen):
    """(kernel, site names, shape label, kernel fn, plain fn, bytes, int8
    ops, library fn or None) for every distinct int8 kernel shape of the
    B1@224 FIX8 path at ``batch``, on random int8 codes, named as in
    ``kernel_cases``.  Each fn returns a tuple of tensors."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.fusion import decision_shape
    from repro_torch.core.program import lower
    from repro_torch.kernels.dsconv.kernel import dsconv_fused_int8
    from repro_torch.kernels.dsconv.ref import dsconv_int8_ref
    from repro_torch.kernels.group_conv.kernel import group_agg_int8
    from repro_torch.kernels.group_conv.ref import (
        block_diag, group_agg_int8_ref)
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.kernels.mbconv.kernel import (
        mbconv_fused_int8, mbconv_fused_int8_emit)
    from repro_torch.kernels.mbconv.ref import mbconv_int8_ref
    from repro_torch.core.quantization import quantize_act

    def i8(*shape):
        return torch.randint(-128, 128, shape, generator=gen,
                             dtype=torch.int8).cuda()

    def sc(*shape, base=1e-2):
        return (base * (0.5 + torch.rand(shape, generator=gen))).cuda()

    def bias(*shape):
        return torch.randn(shape, generator=gen).cuda()

    def nb(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    groups: dict = {}
    program = lower(B1, batch=batch)
    for site in program.fusible():
        shape = decision_shape(site)
        if site.kind == "mbconv":
            emit = not site.residual     # the int8 plan's keep-fp producers
            key = ("mbconv_fused_int8_emit" if emit else
                   "mbconv_fused_int8", shape)
            groups.setdefault(key, []).append(site)
        elif site.kind == "dsconv":
            groups.setdefault(("dsconv_fused_int8", shape), []).append(site)
        else:
            B, H, W, C = site.in_shape
            n_br = site.attrs["n_branches"]
            for key in (("int8_matmul", (B * H * W, C, 3 * C)),
                        ("int8_matmul", (B * H * W, n_br * C, C)),
                        ("group_agg_int8", (B, H, W, 3 * C))):
                groups.setdefault(key, []).append(site)
    cases = []
    for (name, shape), sites in groups.items():
        names = [x.name for x in sites if x.name not in GROUPED]
        lib = None
        if name == "int8_matmul":
            M, K, N = shape
            x, w, xs, ws = i8(M, K), i8(K, N), sc(M), sc(N)
            kfn = lambda a=(x, w, xs, ws): (int8_matmul(*a),)
            pfn = lambda a=(x, w, xs, ws): (int8_matmul_ref(*a),)
            if M > 16 and K % 8 == 0 and N % 8 == 0:
                lib = lambda a=(x, w, xs, ws): (
                    torch._int_mm(a[0], a[1]).float() * a[2][:, None]
                    * a[3][None, :],)
            nbytes = nb(x, w, xs, ws) + 4 * M * N
            ops = 2 * M * K * N
            label = f"({M}x{K})@({K}x{N})"
        elif name == "group_agg_int8":
            B, H, W, C = shape
            d = 16
            args = (i8(B, H, W, C), sc(B), i8(5, 5, C), sc(C), bias(C))
            pw, tail = i8(d, C), (sc(C), bias(C))
            dense = block_diag(pw)
            kfn = lambda a=args, pw=pw, t=tail: (group_agg_int8(*a, pw, *t),)
            pfn = lambda a=args, dn=dense, t=tail: (
                group_agg_int8_ref(*a, dn, *t),)
            nbytes = nb(*args, pw, *tail) + 4 * B * H * W * C
            ops = 2 * B * H * W * C * (25 + d)
            label = f"x{(B, H, W, C)} s=5 d={d}"
        elif name == "dsconv_fused_int8":
            B, H, W, C, _, F, st = shape
            args = (i8(B, H, W, C), sc(B), i8(3, 3, C), sc(C), bias(C),
                    i8(C, F), sc(F), bias(F))
            kfn = lambda a=args, st=st: (dsconv_fused_int8(*a, stride=st),)
            pfn = lambda a=args, st=st: (dsconv_int8_ref(*a, stride=st),)
            nbytes = nb(*args) + 4 * B * (H // st) * (W // st) * F
            ops = 2 * B * (H // st) * (W // st) * (9 * C + C * F)
            label = f"x{(B, H, W, C)} F={F} s={st}"
        else:
            B, H, W, C, M, F, st = shape
            Ho, Wo = H // st, W // st
            args = (i8(B, H, W, C), sc(B), i8(C, M), sc(M, base=2e-3),
                    bias(M), i8(3, 3, M), sc(M), bias(M), i8(M, F), sc(F),
                    bias(F))
            if name == "mbconv_fused_int8":
                kfn = lambda a=args, st=st: (
                    mbconv_fused_int8(*a, stride=st),)
                pfn = lambda a=args, st=st: (mbconv_int8_ref(*a, stride=st),)
                out_bytes = 4 * B * Ho * Wo * F
            else:
                kfn = lambda a=args, st=st: mbconv_fused_int8_emit(
                    *a, stride=st)

                def pfn(a=args, st=st):
                    out = mbconv_int8_ref(*a, stride=st)
                    qt = quantize_act(out)
                    return qt.q, qt.scale, out
                out_bytes = 5 * B * Ho * Wo * F + 4 * B
            nbytes = nb(*args) + out_bytes
            ops = 2 * B * (H * W * C * M + Ho * Wo * M * (9 + F))
            label = f"x{(B, H, W, C)} M={M} F={F} s={st}"
        cases.append((name, names, label, kfn, pfn, nbytes, ops, lib))
    return cases

def chain_macs(sup) -> int:
    """Multiply-adds of one image through a chain's members, without the
    bands' halo recompute."""
    n = 0
    for m in sup.sites:
        _, H, W, C = m.in_shape
        _, Ho, Wo, F = m.out_shape
        if m.kind == "mbconv":
            M = m.attrs["mid"]
            n += H * W * C * M + Ho * Wo * M * (9 + F)
        else:
            n += Ho * Wo * C * (9 + F)
    return n


def chain_cases(batch: int, gen, params, qparams):
    """(fp32 cases, int8 cases) of the two super-site chains of B1@224 at
    ``batch``, as ``kernel_cases`` / ``int8_kernel_cases`` give them:
    random inputs, the weights of the served trees."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.program import SuperSite, lower
    from repro_torch.kernels.supersite.kernel import (
        supersite_fused, supersite_fused_int8)
    from repro_torch.kernels.supersite.ops import (
        choose_blocks, make_fp_geom, make_int8_geom)
    from repro_torch.kernels.supersite.pack import pack_weights
    from repro_torch.kernels.supersite.ref import (
        supersite_int8_ref, supersite_ref)

    program = lower(B1, batch=batch)
    fp_cases, q_cases = [], []
    for name, members in GROUPS.items():
        sup = SuperSite.of(program, members, name=name)
        B = batch
        _, Ho, Wo, F = sup.out_shape
        ops = 2 * B * chain_macs(sup)
        pack = pack_weights(params, sup, "fp")
        blocks = choose_blocks(sup)
        geom = make_fp_geom(sup, pack, blocks["block_rows"],
                            blocks["block_m"])
        x = torch.randn(sup.in_shape, generator=gen).cuda()
        fp_cases.append((
            "supersite_fused", [name],
            f"{name} x{tuple(x.shape)} R={geom.block_rows} "
            f"bm={geom.block_m} bands={geom.n_bands}",
            lambda x=x, p=pack, g=geom: supersite_fused(x, p.fp, geom=g),
            lambda x=x, p=pack, g=geom: supersite_ref(x, p.fp, geom=g),
            4 * (x.numel() + B * Ho * Wo * F) + pack.nbytes, ops))
        qpack = pack_weights(qparams, sup, "int8")
        qgeom = make_int8_geom(sup, qpack)
        x_q = torch.randint(-128, 128, sup.in_shape, generator=gen,
                            dtype=torch.int8).cuda()
        xs = (1e-2 * (0.5 + torch.rand(B, generator=gen))).cuda()
        q_cases.append((
            "supersite_fused_int8", [name],
            f"{name} x{tuple(x_q.shape)} exit int8+fp",
            lambda a=(x_q, xs, qpack.q, qpack.fp), g=qgeom:
                supersite_fused_int8(*a, geom=g, exit_emit=True,
                                     keep_fp=True),
            lambda a=(x_q, xs, qpack.q, qpack.fp), g=qgeom:
                supersite_int8_ref(*a, geom=g, exit_emit=True),
            x_q.numel() + 4 * B + 5 * B * Ho * Wo * F + 4 * B
            + qpack.nbytes, ops, None))
    return fp_cases, q_cases


def band_sweep(params, gen) -> None:
    """Time ``supersite_fused`` at both B1@224 chains, batch 1 and 8, over
    band heights and channel chunks around the planner's choice (the
    evidence ``choose_blocks`` follows)."""
    import torch
    from repro_torch.core.efficientvit import B1
    from repro_torch.core.program import SuperSite, lower
    from repro_torch.kernels.registry import SMEM_LIMIT
    from repro_torch.kernels.supersite.kernel import supersite_fused
    from repro_torch.kernels.supersite.ops import (
        choose_blocks, make_fp_geom, supersite_smem_bytes)
    from repro_torch.kernels.supersite.pack import pack_weights

    for batch in (1, 8):
        program = lower(B1, batch=batch)
        for name, members in GROUPS.items():
            sup = SuperSite.of(program, members, name=name)
            pack = pack_weights(params, sup, "fp")
            x = torch.randn(sup.in_shape, generator=gen).cuda()
            chosen = choose_blocks(sup)
            cells = []
            for rows in (1, 2, 4):
                for bm in (16, 32):
                    if supersite_smem_bytes(sup, rows, bm) > SMEM_LIMIT:
                        continue
                    geom = make_fp_geom(sup, pack, rows, bm)
                    ms = device_ms(lambda g=geom: supersite_fused(
                        x, pack.fp, geom=g), reps=10, windows=3)
                    cells.append(f"R={rows},bm={bm}:{ms:.4f}")
            print(f"[band sweep] {name} B={batch} chosen {chosen}; ms "
                  f"{' '.join(cells)}")


def check_groups(engine, tag) -> None:
    """Every bucket's plan groups exactly ``GROUPS``; print each group's
    blocks, its band windows and the rows each member computes per row
    it hands on (the halo recompute), and the pack counters: one build
    per group per engine, a hit for every later bucket."""
    from repro_torch.core.program import SuperSite
    from repro_torch.kernels.supersite.ops import fp_windows

    for key in engine.cache.keys():
        ex = engine.cache.get(key.batch, key.resolution)
        got = {g.name: tuple(g.members) for g in ex.plan.groups.values()}
        if got != GROUPS:
            raise AssertionError(f"bucket {key.batch}: groups {got}, "
                                 f"expected {GROUPS}")
        for g in ex.plan.groups.values():
            text = f"[{tag}] bucket {key.batch} {g.name} {g.precision} " \
                   f"blocks {dict(g.blocks)}"
            if g.precision == "fp":
                sup = SuperSite.of(ex.program, g.members, name=g.name)
                nb, members = fp_windows(sup, g.blocks["block_rows"])
                text += "; windows/recompute " + ", ".join(
                    f"{m_.n_out}<-{m_.length} rows "
                    f"x{m_.n_out * nb / (m_.h_in // m_.stride):.2f}"
                    for m_ in members)
            print(text)
    counters = engine.telemetry.counters
    built = counters.get("weight_pack_built", 0)
    hits = counters.get("weight_pack_hit", 0)
    n_buckets = len(engine.cache.keys())
    print(f"[{tag}] weight packs: built {built}, hit {hits} over "
          f"{n_buckets} buckets")
    if built != len(GROUPS) or hits != len(GROUPS) * (n_buckets - 1):
        raise AssertionError(f"weight packs built {built}, hit {hits}: "
                             f"expected one build per group per engine")


def grouped_vs_per_site(engine, x8, tag, exact: bool):
    """The batch-8 forward of the served (grouped) plan against the same
    forward under ``supersites=False``."""
    import torch
    from repro_torch.core.fusion import plan_program
    from repro_torch.core.program import execute

    ex = engine.cache.get(8, x8.shape[1])
    flat = plan_program(ex.program, engine.params, supersites=False)
    if flat.groups or not ex.plan.groups:
        raise AssertionError("the per-site plan must not group, the "
                             "served one must")
    with torch.inference_mode():
        got = engine.logits(x8)
        want = execute(ex.program, engine.params, x8, plan=flat)
    torch.cuda.synchronize()
    d = (got - want).abs().max().item()
    top = max(1.0, want.abs().max().item())
    print(f"[{tag}] grouped vs per-site plan, batch 8: max|d| {d:.3e} "
          f"(max(1, max|logit|) {top:.3e})")
    if exact and not torch.equal(got, want):
        raise AssertionError(f"grouped FIX8 logits differ from per-site: "
                             f"{int((got != want).sum())} of {got.numel()}")
    if not d <= TOL * top:
        raise AssertionError(f"grouped fp32 logits {d:.3e} from per-site")
    if not torch.equal(got.argmax(-1), want.argmax(-1)):
        raise AssertionError("grouped top-1 differs from per-site")


def randomize_bn(tree, gen) -> None:
    """Give every BatchNorm non-trivial statistics (init is identity,
    which would leave BN folding untested)."""
    import torch
    if isinstance(tree, dict):
        if set(tree) == {"scale", "bias", "mean", "var"}:
            n = tree["scale"].shape[0]
            dev = tree["scale"].device
            tree["scale"] = (0.8 + 0.4 * torch.rand(n, generator=gen)).to(dev)
            tree["bias"] = (0.1 * torch.randn(n, generator=gen)).to(dev)
            tree["mean"] = (0.1 * torch.randn(n, generator=gen)).to(dev)
            tree["var"] = (0.5 + torch.rand(n, generator=gen)).to(dev)
            return
        for v in tree.values():
            randomize_bn(v, gen)
    elif isinstance(tree, list):
        for v in tree:
            randomize_bn(v, gen)


def check_kernels(cases, batch, per_fwd, max_err, exact: bool):
    """Run each case's kernel and plain version, hold them together,
    time both (and the library yardstick), print one [kernel] line each
    and add the batch-8 times to ``per_fwd``."""
    import torch
    peak = PEAK_INT8_OPS if exact else PEAK_FP32_FLOPS
    for case in cases:
        name, sites, label, kfn, pfn, nbytes, ops = case[:7]
        lib = case[7] if len(case) > 7 else None
        got, ref = kfn(), pfn()
        torch.cuda.synchronize()
        if exact:
            got, ref = tuple(got), tuple(ref)
            diff = [int((g != r).sum()) for g, r in zip(got, ref)]
            if any(diff) or any(g.dtype != r.dtype for g, r in zip(got, ref)):
                raise AssertionError(f"{name} {label}: elements differing "
                                     f"from the plain version: {diff}")
            err = max((g.float() - r.float()).abs().max().item()
                      for g, r in zip(got, ref))
        else:
            err = (got - ref).abs().max().item()
            scale = max(1.0, ref.abs().max().item())
            if not err <= TOL * scale:
                raise AssertionError(
                    f"{name} {label}: max|d| {err:.3e} > "
                    f"{TOL} * {scale:.3e}")
        max_err[name] = max(max_err[name], err)
        ms = device_ms(kfn)
        plain_ms = device_ms(pfn, reps=5 if exact else 20)
        lib_ms = device_ms(lib) if lib is not None else None
        b_ms, by = bound(nbytes, ops, peak)
        lib_txt = f" library_ms={lib_ms:.5f}" if lib_ms is not None else ""
        print(f"[kernel] {name} B={batch} {label} sites={len(sites)} "
              f"max|d|={err:.3e} ms={ms:.5f} plain_ms={plain_ms:.5f}"
              f"{lib_txt} bound_ms={b_ms:.5f} ({by}) roofline="
              f"{b_ms / ms:.3f}")
        if batch == 8:
            acc = per_fwd[name]
            n = len(sites)
            acc["ms"] += n * ms
            acc["plain_ms"] += n * plain_ms
            acc["bound_ms"] += n * b_ms
            acc["bytes_s"] += n * nbytes / PEAK_BYTES_PER_S
            acc["ops_s"] += n * ops / peak
            if lib_ms is not None:
                acc["library_ms"] = acc.get("library_ms", 0.0) + n * lib_ms


def serve_trace(engine, images, wrappers, expected, tag):
    """Serve 12 requests with mixed deadlines through the engine's
    scheduler with every launch counter reset just before and read just
    after; check the launches per dispatched forward.  Returns (logits,
    launches)."""
    import numpy as np
    import torch
    from repro_torch.serving.scheduler import Request

    engine.warmup()
    sched = engine.scheduler()
    # request 2 is due at once (flushes 3 requests to bucket 4), requests
    # 3..10 fill bucket 8, request 11 goes to bucket 1 at drain
    deadlines = [60_000.0, None, 0.0] + [60_000.0, None] * 4 + [None]
    reqs = [Request(i, images[i], deadline_ms=deadlines[i],
                    timeout_ms=600_000.0) for i in range(12)]
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
        sched.step()
    sched.step(drain=True)
    t_fin = time.perf_counter()
    sched.finalize()
    wall = time.perf_counter() - t0
    fin = time.perf_counter() - t_fin
    launches = {k: w.launches for k, w in wrappers.items()}
    if any(r.status != "completed" for r in reqs):
        raise AssertionError([(r.rid, r.status, r.error) for r in reqs])
    dispatched = [(k[0], k[1]) for k, b in engine.telemetry.buckets.items()
                  for _ in range(b.dispatches)]
    n_fwd = len(dispatched)
    print(f"[{tag}] dispatched (bucket, res): {sorted(dispatched)}; "
          f"launches {launches}; {len(reqs)} images in {wall * 1e3:.2f} ms "
          f"= {len(reqs) / wall:.1f} images/s")
    print(f"[{tag}] host: submit + step (copy in, enqueue the forwards) "
          f"{(wall - fin) * 1e3:.2f} ms, finalize (waiting on the card) "
          f"{fin * 1e3:.2f} ms")
    for name, per in expected.items():
        if launches[name] != per * n_fwd:
            raise AssertionError(f"{name}: {launches[name]} launches for "
                                 f"{n_fwd} forwards, expected {per} each")
    for key, b in sorted(engine.telemetry.buckets.items()):
        s = b.snapshot()
        print(f"[{tag}] bucket {key}: dispatches={b.dispatches} "
              f"samples={b.samples} padded={b.padded} "
              f"latency_ms p50={s['latency_ms_p50']:.3f} "
              f"max={max(b.latency_ms):.3f}")
    got = np.stack([r.logits for r in reqs])
    if not np.all(np.isfinite(got)) or got.shape[0] != 12:
        raise AssertionError(f"bad logits: shape {got.shape}")
    torch.cuda.synchronize()
    return got, launches


def steady_state(engine, rng, tag):
    """64 images as 8 full buckets, host clock to a synchronize; then one
    batch-8 forward's device time (CUDA events, the host's enqueue hidden
    behind a sleep kernel) beside the host's time to enqueue it."""
    import numpy as np
    import torch
    batch64 = torch.from_numpy(
        rng.standard_normal((64, 224, 224, 3)).astype(np.float32)).cuda()
    engine.logits(batch64[:8])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.logits(batch64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[{tag}] steady state: 64 images in 8 buckets of 8: "
          f"{wall * 1e3:.2f} ms = {64 / wall:.1f} images/s")
    ex = engine.cache.get(8, 224)
    fwd = lambda: ex(engine.params, batch64[:8])
    dev = device_ms(fwd, reps=5, windows=3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        fwd()
    host = (time.perf_counter() - t0) / 5 * 1e3
    torch.cuda.synchronize()
    per = wall / 8 * 1e3
    print(f"[{tag}] one batch-8 forward: device {dev:.3f} ms, host enqueue "
          f"{host:.3f} ms, steady state {per:.3f} ms per forward (device "
          f"idle {max(0.0, 1 - dev / per):.1%} of it)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device is available")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail(f"the port's package is not at {SRC}/repro_torch")
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch.core.efficientvit import B1, init_efficientvit
    from repro_torch.core.program import execute, lower
    from repro_torch.kernels.build import build
    from repro_torch.kernels.dsconv.kernel import (
        dsconv_fused, dsconv_fused_int8)
    from repro_torch.kernels.group_conv.kernel import group_agg_int8
    from repro_torch.kernels.int8_matmul.kernel import int8_matmul
    from repro_torch.kernels.mbconv.kernel import (
        mbconv_fused, mbconv_fused_int8, mbconv_fused_int8_emit)
    from repro_torch.core.quantization import quantize_efficientvit
    from repro_torch.kernels.relu_attn.kernel import relu_attn_noncausal
    from repro_torch.kernels.supersite.kernel import (
        supersite_fused, supersite_fused_int8)
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    # -- 1. set-up ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")
    t0 = time.perf_counter()
    logs = build()
    print(f"[build] {len(logs)} kernel libraries built in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    wrappers = {"dsconv_fused": dsconv_fused, "mbconv_fused": mbconv_fused,
                "relu_attn_noncausal": relu_attn_noncausal,
                "mbconv_fused_int8": mbconv_fused_int8,
                "mbconv_fused_int8_emit": mbconv_fused_int8_emit,
                "dsconv_fused_int8": dsconv_fused_int8,
                "int8_matmul": int8_matmul,
                "group_agg_int8": group_agg_int8,
                "supersite_fused": supersite_fused,
                "supersite_fused_int8": supersite_fused_int8}
    expected_fp = {"dsconv_fused": 1, "mbconv_fused": 9,
                   "relu_attn_noncausal": 7, "mbconv_fused_int8": 0,
                   "mbconv_fused_int8_emit": 0, "dsconv_fused_int8": 0,
                   "int8_matmul": 0, "group_agg_int8": 0,
                   "supersite_fused": 2, "supersite_fused_int8": 0}
    expected_int8 = {"dsconv_fused": 0, "mbconv_fused": 0,
                     "relu_attn_noncausal": 7, "mbconv_fused_int8": 7,
                     "mbconv_fused_int8_emit": 2, "dsconv_fused_int8": 1,
                     "int8_matmul": 14, "group_agg_int8": 7,
                     "supersite_fused": 0, "supersite_fused_int8": 2}
    csrc, jk = "src/repro_torch/csrc/", "src/repro/kernels/"
    sources = {
        "dsconv_fused": (csrc + "dsconv.cu", jk + "dsconv/kernel.py:57"),
        "mbconv_fused": (csrc + "mbconv.cu", jk + "mbconv/kernel.py:69"),
        "relu_attn_noncausal": (csrc + "relu_attn.cu",
                                jk + "relu_attn/kernel.py:68"),
        "mbconv_fused_int8": (csrc + "mbconv_int8.cu",
                              jk + "mbconv/kernel.py:168"),
        "mbconv_fused_int8_emit": (csrc + "mbconv_int8.cu",
                                   jk + "mbconv/kernel.py:283"),
        "dsconv_fused_int8": (csrc + "dsconv_int8.cu",
                              jk + "dsconv/kernel.py:138"),
        "int8_matmul": (csrc + "int8_matmul.cu",
                        jk + "int8_matmul/kernel.py:45"),
        "group_agg_int8": (csrc + "group_agg.cu",
                           jk + "group_conv/kernel.py:60"),
        "supersite_fused": (csrc + "supersite.cu",
                            jk + "supersite/kernel.py:191"),
        "supersite_fused_int8": (csrc + "supersite_int8.cu",
                                 jk + "supersite/kernel.py:353"),
    }
    gen = torch.Generator().manual_seed(args.seed)
    per_fwd = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bytes_s": 0.0, "ops_s": 0.0} for k in wrappers}
    max_err = {k: 0.0 for k in wrappers}

    params = init_efficientvit(gen, B1, "cuda")
    randomize_bn(params, gen)
    qparams = quantize_efficientvit(params)
    chains = {b: chain_cases(b, gen, params, qparams) for b in (1, 8)}

    # -- 2a. fp32 kernels against their plain versions -----------------
    for batch in (1, 8):
        check_kernels(kernel_cases(batch, gen) + chains[batch][0], batch,
                      per_fwd, max_err, exact=False)
    band_sweep(params, gen)

    # -- 2b. the fp32 main path -----------------------------------------
    engine = VisionEngine(params, B1, VisionServeConfig(microbatch=8))
    rng = np.random.default_rng(args.seed)
    images = rng.standard_normal((12, 224, 224, 3)).astype(np.float32)
    got, launches_fp = serve_trace(engine, images, wrappers, expected_fp,
                                   "serve")
    check_groups(engine, "serve")
    with torch.inference_mode():
        ref = execute(lower(B1, batch=12), engine.params,
                      torch.from_numpy(images).cuda()).cpu().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
    if not np.array_equal(got.argmax(-1), ref.argmax(-1)):
        raise AssertionError("top-1 differs from the reference forward")
    print(f"[serve] logits vs reference forward: max|d| "
          f"{np.abs(got - ref).max():.3e} (max|ref| "
          f"{np.abs(ref).max():.3e}), top-1 equal")
    x12 = torch.from_numpy(images).cuda()
    grouped_vs_per_site(engine, x12[:8], "serve", exact=False)
    steady_state(engine, rng, "serve")
    del engine

    # -- 3a. int8 kernels against their plain versions -----------------
    for batch in (1, 8):
        check_kernels(int8_kernel_cases(batch, gen) + chains[batch][1],
                      batch, per_fwd, max_err, exact=True)

    # -- 3b. the FIX8 main path -----------------------------------------
    qengine = VisionEngine.quantized(params, B1,
                                     VisionServeConfig(microbatch=8))
    got, launches_q = serve_trace(qengine, images, wrappers, expected_int8,
                                  "fix8")
    check_groups(qengine, "fix8")
    with torch.inference_mode():
        ref = execute(lower(B1, batch=12), qengine.params,
                      x12).cpu().numpy()
    d, top = np.abs(got - ref).max(), np.abs(ref).max()
    print(f"[fix8] logits vs the int8 reference forward: max|d| {d:.3e} "
          f"(max|ref| {top:.3e}, {d / top:.3e} of it)")
    if not np.array_equal(got.argmax(-1), ref.argmax(-1)):
        raise AssertionError("FIX8 top-1 differs from the int8 reference")
    if not d <= CHAOS * top:
        raise AssertionError(f"FIX8 logits {d:.3e} from the reference, "
                             f"above {CHAOS} * {top:.3e}")
    eight = qengine.logits(x12[:8])
    ones = torch.cat([qengine.logits(x12[i:i + 1]) for i in range(8)])
    if not torch.equal(eight, ones):
        raise AssertionError(
            f"batch invariance: {int((eight != ones).sum())} logits of a "
            f"batch-8 forward differ from the batch-1 forwards")
    print("[fix8] batch invariance: the 8 rows of a batch-8 forward equal "
          "the 8 batch-1 forwards bit for bit")
    grouped_vs_per_site(qengine, x12[:8], "fix8", exact=True)
    steady_state(qengine, rng, "fix8")

    # -- 4. the kernels line --------------------------------------------
    rows = []
    for name in wrappers:
        acc = per_fwd[name]
        src, replaces = sources[name]
        rows.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": launches_fp[name] + launches_q[name],
            "max_abs_err": max_err[name], "ms": acc["ms"],
            "plain_ms": acc["plain_ms"], "bound_ms": acc["bound_ms"],
            "bound_by": ("bytes" if acc["bytes_s"] >= acc["ops_s"]
                         else "operations"),
            "library_ms": acc.get("library_ms")})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
