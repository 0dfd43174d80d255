#!/usr/bin/env python3
"""Where a launch of the FIX8 MSA aggregation's cluster kernel spends its
time, on one CUDA card:

    python3 tools/group_agg_phases.py

Builds copies of ``src/repro_torch/csrc/group_agg.cu`` under
``build/ga_phases/`` with one phase of ``group_agg_cluster`` cut out:
``no_dw`` (the DW taps' products), ``no_div`` (the requant's IEEE
divisions, replaced by a cast), ``no_mma`` (the grouped 1x1 and its
stores) and ``no_compute`` (all three), beside the unchanged ``full``
kernel.  Their outputs are wrong: they are timing experiments and serve
no caller.  Runs B1@224's two aggregation maps (S3 14x14x384 at 12
ranks, S4 7x7x768 at 16) at batch 1 and 8 on random int8 codes and
prints each build's µs per launch (CUDA events, ``chip_smoke.device_ms``).

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "ga_phases")
DW = "    for (int dy = 0; dy < S; ++dy) {\n"
DIV = ("      v = i8mma::pack4(quant_i8(f.x, s_y), quant_i8(f.y, s_y),\n"
       "                       quant_i8(f.z, s_y), quant_i8(f.w, s_y));\n")
MMA = "  for (int u = warp; u < units; u += NT / 32) {\n"
CUTS = {DW: "    for (int dy = 0; dy < 0; ++dy) {\n",
        DIV: "      v = i8mma::pack4((int8_t)f.x, (int8_t)f.y, (int8_t)f.z,"
             " (int8_t)f.w);\n",
        MMA: "  for (int u = warp; u < 0; u += NT / 32) {\n"}
BUILDS = {"full": (), "no_dw": (DW,), "no_div": (DIV,), "no_mma": (MMA,),
          "no_compute": (DW, DIV, MMA)}


def build() -> dict:
    """Compile every build at once -> {name: loaded library}."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    os.makedirs(OUT, exist_ok=True)
    src = open(os.path.join(CSRC, "group_agg.cu")).read()
    jobs = {}
    for name, cuts in BUILDS.items():
        text = src
        for anchor in cuts:
            if anchor not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{anchor.strip()!r}")
            text = text.replace(anchor, CUTS[anchor])
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{name}.so")
        jobs[name] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        lib = ctypes.CDLL(so)
        lib.group_agg_int8_i8.argtypes = ([ctypes.c_void_p] * 10
                                          + [ctypes.c_int] * 7
                                          + [ctypes.c_void_p])
        lib.group_agg_int8_i8.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("group_agg_phases: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import device_ms

    libs = build()
    gen = torch.Generator().manual_seed(0)
    i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                   dtype=torch.int8).cuda()
    sc = lambda *sh: (1e-2 * (0.5 + torch.rand(sh, generator=gen))).cuda()
    for B in (1, 8):
        for H, C, ranks in ((14, 384, 12), (7, 768, 16)):
            args = (i8(B, H, H, C), sc(B), i8(5, 5, C), sc(C), sc(C),
                    i8(16, C), sc(C), sc(C))
            out = torch.empty((B, H, H, C), device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            cells = []
            for name, lib in libs.items():
                def call(lib=lib):
                    status = lib.group_agg_int8_i8(
                        *(t.data_ptr() for t in args), None, out.data_ptr(),
                        B, H, H, C, 5, 16, ranks, stream)
                    if status:
                        raise RuntimeError(f"{name}: CUDA error {status}")
                cells.append(f"{name} {device_ms(call) * 1e3:.2f}")
            print(f"[ga phases] B={B} {H}x{H}x{C} ranks={ranks} µs per "
                  f"launch: " + ", ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
