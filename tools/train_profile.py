#!/usr/bin/env python3
"""Where a training step's time goes, on one CUDA card:

    python3 tools/train_profile.py [--arch zamba2-1.2b] [--backend relu_linear]
                                   [--batch 8] [--seq 1024] [--layers N]

Builds the kernels, makes random params from ``--seed`` (the arch's
dtypes; ``--layers`` cuts the depth) and their default AdamW state,
runs two warm-up steps of ``launch/steps.py``'s ``make_train_step`` on
random tokens, then one step under ``torch.profiler`` (first in the
process: a late capture loses device events).  Printed: the step's host
time to enqueue and wall time to a synchronize, the device's kernel time
(the sum over every kernel) and its share of the wall time, the kernel
time by group (the port's scan kernels, matrix products, the rest), the
launches, the 25 kernels and the 20 operators with the most device
time; each scan's kernel forward and plain-version backward at the
step's shapes, and the backward's total over the step's calls.  Then the same
step's phases one at a time (loss forward, backward, AdamW), each timed
on the host to a synchronize.  Needs a CUDA card; imports nothing of
JAX.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

GEMM = ("gemm", "sm90_xmma", "cutlass", "ampere", "cublas", "splitk")


def group(name: str, port: set) -> str:
    low = name.lower()
    if name in port:
        return "port scan kernels"
    if any(g in low for g in GEMM):
        return "matrix products"
    return "other kernels"


def scan_backward_ms(cfg, batch: int, seq: int, card: str) -> None:
    """Each scan's call at this step's shapes, one layer: the kernel
    forward, and the backward the step runs (autograd of the plain
    version, recomputed), each timed by CUDA events around a call,
    median of 5; and the backward's total over the step's calls."""
    import statistics
    import torch
    from repro_torch.kernels.relu_attn.ops import relu_linear_attention
    from repro_torch.kernels.ssd.ops import ssd_op
    from repro_torch.models.lm import mamba_cfg
    g = torch.Generator(device="cuda").manual_seed(1)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    m = mamba_cfg(cfg)
    cases = {"ssd_chunked": (
        lambda x, dt, B, C: ssd_op(x, dt, -torch.ones(m.n_heads,
                                                       device="cuda"),
                                   B, C, chunk=m.chunk),
        (rand(batch, seq, m.n_heads, m.head_dim, dtype=cfg.cdtype),
         torch.nn.functional.softplus(rand(batch, seq, m.n_heads)),
         rand(batch, seq, 1, m.d_state, dtype=cfg.cdtype),
         rand(batch, seq, 1, m.d_state, dtype=cfg.cdtype)),
        cfg.n_layers)}
    if cfg.attn_backend == "relu_linear" and cfg.family == "zamba2":
        h, d = cfg.n_heads, cfg.head_dim
        cases["relu_attn_causal"] = (
            lambda q, k, v: relu_linear_attention(q, k, v, causal=True),
            tuple(rand(batch, seq, h, d, dtype=cfg.cdtype)
                  for _ in range(3)),
            cfg.n_layers // cfg.shared_attn_every)

    def timed(fn):
        out = []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end))
        return statistics.median(out[1:])

    for name, (fn, inputs, calls) in cases.items():
        xs = [t.requires_grad_() for t in inputs]
        y = fn(*xs)
        cot = torch.randn_like(y)
        fwd = timed(lambda: fn(*xs))
        bwd = timed(lambda: torch.autograd.grad(fn(*xs), xs, cot)) - fwd
        print(f"{name} at this step's shape: forward (kernel) {fwd:.3f} ms, "
              f"backward (plain version recomputed) {bwd:.3f} ms a call; "
              f"{calls} calls a step: {bwd * calls:.3f} ms of backward "
              f"[{card}]")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--backend", default="relu_linear")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_arch
    from repro_torch.kernels.build import build
    from repro_torch.launch.steps import (
        default_opt_cfg, init_train_state, make_train_step, value_and_grad)
    from repro_torch.models.registry import build_model
    from repro_torch.optim.adamw import adamw_update

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    build()
    cfg = get_arch(args.arch).scaled(attn_backend=args.backend)
    if args.layers:
        cfg = cfg.scaled(n_layers=args.layers)
    model = build_model(cfg)
    opt_cfg = default_opt_cfg(cfg)
    params, opt = init_train_state(model, opt_cfg, args.seed, "cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    batch = {k: torch.randint(0, cfg.vocab, (args.batch, args.seq),
                              generator=g, device="cuda")
             for k in ("tokens", "targets")}
    step = make_train_step(model, opt_cfg)
    for _ in range(2):
        params, opt, loss = step(params, opt, batch)
    torch.cuda.synchronize()

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt, loss = step(params, opt, batch)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = collections.Counter()
    calls = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] += e.time_range.elapsed_us()
            calls[e.name] += 1
    port = {n for n in by_name if any(
        k in n for k in ("causal_", "ssd_", "chunk_prefix"))}
    total = sum(by_name.values()) / 1e3
    groups = collections.Counter()
    for n, us in by_name.items():
        groups[group(n, port)] += us / 1e3
    print(f"{cfg.name} {cfg.attn_backend} {cfg.param_dtype}/"
          f"{cfg.compute_dtype}, {cfg.n_layers} layers, B = {args.batch}, "
          f"S = {args.seq}, remat {cfg.remat}, loss {loss.item():.4f} "
          f"[{card}]")
    print(f"one step: host enqueue {host * 1e3:.3f} ms, wall "
          f"{wall * 1e3:.3f} ms, kernel time {total:.3f} ms "
          f"({100 * total / (wall * 1e3):.1f} % of the wall time), "
          f"{sum(calls.values())} kernel launches")
    for name, ms in groups.most_common():
        print(f"  {name}: {ms:.3f} ms ({100 * ms / total:.1f} %)")
    print("top kernels by device time (ms, launches):")
    for name, us in by_name.most_common(25):
        print(f"  {us / 1e3:9.3f} {calls[name]:6d}  {name[:110]}")

    print("top operators by self device time (ms, calls):")
    rows = [r for r in prof.key_averages()
            if r.device_type != DeviceType.CUDA]
    self_us = {id(r): getattr(r, "self_device_time_total",
                              None) or getattr(r, "self_cuda_time_total", 0)
               for r in rows}
    for r in sorted(rows, key=lambda r: -self_us[id(r)])[:20]:
        print(f"  {self_us[id(r)] / 1e3:9.3f} {r.count:6d}  {r.key[:110]}")

    scan_backward_ms(cfg, args.batch, args.seq, card)

    vg = value_and_grad(model.loss)
    for label in ("phases", "phases again"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model.loss(params, batch)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss, grads = vg(params, batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw_update(grads, opt, params, opt_cfg)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"{label}: loss forward (no grad) {(t1 - t0) * 1e3:.3f} ms, "
              f"value_and_grad {(t2 - t1) * 1e3:.3f} ms, AdamW "
              f"{(t3 - t2) * 1e3:.3f} ms [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
