#!/usr/bin/env python3
"""Where a kernel's launch spends its time, on one CUDA card: time it with
parts of its source cut out.

    python3 tools/source_cuts.py TARGET [TARGET ...]

A target (``TARGETS``) names a kernel library of ``src/repro_torch/csrc``,
the kernels of ``chip_smoke.py``'s ``[kernel]`` cases it times
(``kernel_cases`` and ``int8_kernel_cases``, B1@224 at batch 1 and 8, on
random inputs) and its builds: ``full``, the unchanged sources, and
builds with one or more cuts of ``CUTS`` applied, each an (anchor,
replacement) edit of one source file.  Every build is a copy of ``csrc`` under
``build/cuts/<target>/<build>/``, compiled at once (one ``nvcc`` each).
The cases call the kernels' own wrappers, with ``library`` serving each
build in turn, and the script prints each build's µs per call (CUDA
events, ``chip_smoke.device_ms``) and, last, the card's name and power
limit.

A cut build's outputs are wrong, or (``no_division``: reciprocal
multiplies for the IEEE divisions of Hardswish and the requant) not
bit-exact: they are timing experiments and serve no caller.
``nz_division`` keeps the bits: it only keeps zero dividends out of
those divisions (a zero takes ``div.rn.f32``'s slow path).

Targets: ``dsconv`` (``dsconv_fused``'s band kernel at stem.ds0: the
input rows' staging, the DW, the 1x1's arithmetic, the whole 1x1 with
its stores, or Hardswish cut out; ``div_rn``: Hardswish's division by 6
as ``div.rn.f32``, the same bits with its slow-path branch), ``dsconv_int8`` (``dsconv_fused_int8``'s cluster
kernel at stem.ds0), ``group_agg`` (``group_agg_int8`` at the two MSA
maps), ``mbconv_int8`` (``mbconv_fused_int8`` and ``_emit``,
divisions only), and the two chunk-parallel scans, ``relu_attn_causal``
and ``ssd`` (``ssd_chunked``), timed at ``chip_smoke.py``'s library
cases (32k tokens, ms per call, 3 windows of 2 calls): each launch cut in
turn (``no_states``, ``no_prefix``, ``no_out``; ``out_only`` keeps the
output launch alone, on a workspace of stale states) and, inside the
output launch, the state term or the key tiles (the score tiles and
their products); ``int8_matmul_emit`` (its cluster kernel at the
library's 24 cases: the MMA steps, the cluster's absmax, the quantize
and stores, or the epilogue with them cut out; the quantize alone reads
no o without the epilogue, so it is cut with it).
Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")
OUT = os.path.join(ROOT, "build", "cuts")

# cut: [(file, anchor, replacement), ...]; an anchor the source no longer
# has stops the script
CUTS = {
    # dsconv_band
    "dsf_stage": [("dsconv.cu", "    if (t < need && al) {\n",
                   "    if (t < 0) {\n"),
                  ("dsconv.cu", "    } else if (t < need) {\n",
                   "    } else if (t < 0) {\n")],
    "dsf_dw": [("dsconv.cu", "    if (k < nrows) {\n",
                "    if (k < 0) {\n")],
    "dsf_pw_math": [("dsconv.cu",
                     "        for (int c = 0; c < C; c += 4) {\n",
                     "        for (int c = 0; c < 0; c += 4) {\n")],
    "dsf_pw": [("dsconv.cu", "    if (k > 0) {\n", "    if (k < 0) {\n")],
    "dsf_hswish": [("dsconv.cu", "  if (act)\n", "  if (false)\n")],
    "dsf_div": [("common.cuh",
                 "  return x * div6(fminf(fmaxf(x + 3.0f, 0.0f), 6.0f));\n",
                 "  return x * (fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) "
                 "/ 6.0f);\n")],
    # dsconv_i8_cluster
    "ds_dw": [("dsconv_int8.cu",
               "    for (int p = tid / cq; p < P; p += nu / cq) {\n",
               "    for (int p = tid / cq; p < 0; p += nu / cq) {\n")],
    "ds_hswish": [("dsconv_int8.cu",
                   "        if (a.act) y[q] = hswish_rn(y[q]);\n", "\n")],
    "ds_qdiv": [("dsconv_int8.cu",
                 "      v = i8mma::pack4(quant_i8(f.x, s_dw), quant_i8(f.y, "
                 "s_dw),\n                       quant_i8(f.z, s_dw), "
                 "quant_i8(f.w, s_dw));\n",
                 "      v = i8mma::pack4((int8_t)f.x, (int8_t)f.y, "
                 "(int8_t)f.z, (int8_t)f.w);\n")],
    "ds_quant": [("dsconv_int8.cu",
                  "  for (int e = tid; e < P16 * cq; e += DS_NT) {\n",
                  "  for (int e = tid; e < 0; e += DS_NT) {\n")],
    "ds_mma": [("dsconv_int8.cu",
                "  for (int u = warp; u < units; u += DS_NT / 32) {\n",
                "  for (int u = warp; u < 0; u += DS_NT / 32) {\n")],
    "ds_cluster_max": [("dsconv_int8.cu",
                        "      __float_as_uint(i8mma::cluster_max_push(cl, "
                        "vmax, red, ranks)));\n",
                        "      __float_as_uint(vmax));\n")],
    # group_agg_cluster
    "ga_dw": [("group_agg.cu", "    for (int dy = 0; dy < S; ++dy) {\n",
               "    for (int dy = 0; dy < 0; ++dy) {\n")],
    "ga_div": [("group_agg.cu",
                "      v = i8mma::pack4(quant_i8(f.x, s_y), quant_i8(f.y, "
                "s_y),\n                       quant_i8(f.z, s_y), "
                "quant_i8(f.w, s_y));\n",
                "      v = i8mma::pack4((int8_t)f.x, (int8_t)f.y, "
                "(int8_t)f.z, (int8_t)f.w);\n")],
    "ga_mma": [("group_agg.cu",
                "  for (int u = warp; u < units; u += NT / 32) {\n",
                "  for (int u = warp; u < 0; u += NT / 32) {\n")],
    # every int8 kernel: Hardswish's and the requant's IEEE divisions
    "division": [
        ("int8.cuh", "__fdiv_rn(fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), "
         "6.0f), 6.0f)", "__fmul_rn(fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), "
         "6.0f), 1.0f / 6.0f)"),
        ("int8.cuh", "rintf(__fdiv_rn(x, scale))",
         "rintf(__fmul_rn(x, 1.0f / scale))")],
    # the same divisions, bit for bit, with no zero dividend (a zero sends
    # div.rn.f32 to its slow path): divide a stand-in, select the 0
    "nz_division": [
        ("int8.cuh", "  return __fmul_rn(\n      x, __fdiv_rn(fminf(fmaxf("
         "__fadd_rn(x, 3.0f), 0.0f), 6.0f), 6.0f));\n",
         "  const float r = fminf(fmaxf(__fadd_rn(x, 3.0f), 0.0f), 6.0f);\n"
         "  return __fmul_rn(x, r == 0.0f ? 0.0f\n"
         "                                : __fdiv_rn(r == 0.0f ? 6.0f : r, "
         "6.0f));\n"),
        ("int8.cuh", "rintf(__fdiv_rn(x, scale))",
         "(x == 0.0f ? 0.0f : rintf(__fdiv_rn(x == 0.0f ? scale : x, "
         "scale)))")],
}
# int8_emit_gemm (the cluster path of int8_matmul_emit)
CUTS.update({
    "em_mma": [("int8_matmul.cu",
                "    for (int u = warp; u < tiles * ks; u += NT / 32) {\n",
                "    for (int u = warp; u < 0; u += NT / 32) {\n")],
    "em_epi": [("int8_matmul.cu",
                "\n  for (int e = tid; e < rows * c4; e += NT) {\n",
                "\n  for (int e = tid; e < 0; e += NT) {\n")],
    "em_cluster_max": [("int8_matmul.cu",
                        "        i8mma::cluster_max_push(cl, vmax, red, "
                        "gridDim.x)));\n", "        vmax));\n")],
    "em_quant": [("int8_matmul.cu",
                  "    for (int e = tid; e < rows * c16; e += NT) {\n",
                  "    for (int e = tid; e < 0; e += NT) {\n")]})
for _src, _lib in (("relu_attn_causal.cu", "ra"), ("ssd.cu", "ssd")):
    # the chunk-parallel scans: a launch, or a part of the output pass
    CUTS.update({
        f"{_lib}_states": [(_src, "  const bool run_states = nc > 1;\n",
                            "  const bool run_states = false;\n")],
        f"{_lib}_prefix": [(_src, "  const bool run_prefix = nc > 1;\n",
                            "  const bool run_prefix = false;\n")],
        f"{_lib}_out": [(_src, "  const bool run_out = true;\n",
                         "  const bool run_out = false;\n")],
        f"{_lib}_state_term": [(_src, "  if (c > 0) {   // the state term",
                                "  if (false) {   // the state term")],
        f"{_lib}_key_tiles": [(_src,
                               "  for (int ki = 0; ki <= qi; ++ki) {\n",
                               "  for (int ki = 0; ki < 0; ++ki) {\n")]})
# target: (library, kernels of int8_kernel_cases (or, for a kernel no
# served forward runs, of library_cases), {build: cuts})
TARGETS = {
    "dsconv": ("dsconv", ("dsconv_fused",), {
        "full": (), "no_stage": ("dsf_stage",), "no_dw": ("dsf_dw",),
        "no_pw_math": ("dsf_pw_math",), "no_pw": ("dsf_pw",),
        "none": ("dsf_stage", "dsf_dw", "dsf_pw"),
        "no_hswish": ("dsf_hswish",), "div_rn": ("dsf_div",)}),
    "dsconv_int8": ("dsconv_int8", ("dsconv_fused_int8",), {
        "full": (), "no_dw": ("ds_dw",), "no_hswish": ("ds_hswish",),
        "no_qdiv": ("ds_qdiv",), "no_quant": ("ds_quant",),
        "no_mma": ("ds_mma",), "no_cluster_max": ("ds_cluster_max",),
        "none": ("ds_dw", "ds_quant", "ds_mma", "ds_cluster_max"),
        "nz_division": ("nz_division",)}),
    "group_agg": ("group_agg", ("group_agg_int8",), {
        "full": (), "no_dw": ("ga_dw",), "no_div": ("ga_div",),
        "no_mma": ("ga_mma",), "no_compute": ("ga_dw", "ga_div", "ga_mma")}),
    "mbconv_int8": ("mbconv_int8", ("mbconv_fused_int8",
                                    "mbconv_fused_int8_emit"), {
        "full": (), "no_division": ("division",)}),
}
for _target, _lib, _kernel, _p in (
        ("relu_attn_causal", "relu_attn_causal", "relu_attn_causal", "ra"),
        ("ssd", "ssd", "ssd_chunked", "ssd")):
    TARGETS[_target] = (_lib, (_kernel,), {
        "full": (), "no_states": (f"{_p}_states",),
        "no_prefix": (f"{_p}_prefix",), "no_out": (f"{_p}_out",),
        "out_only": (f"{_p}_states", f"{_p}_prefix"),
        "out_no_state_term": (f"{_p}_state_term",),
        "out_no_key_tiles": (f"{_p}_key_tiles",)})
TARGETS["int8_matmul_emit"] = ("int8_matmul", ("int8_matmul_emit",), {
    "full": (), "no_mma": ("em_mma",), "no_cluster_max": ("em_cluster_max",),
    "no_quant": ("em_quant",), "no_epilogue": ("em_epi", "em_quant"),
    "none": ("em_mma", "em_epi", "em_cluster_max", "em_quant")})
LIBRARY_KERNELS = ("relu_attn_causal", "ssd_chunked", "int8_matmul_emit")
SCANS = ("relu_attn_causal", "ssd_chunked")


def edited_copy(dst: str, cuts) -> None:
    """Copy ``csrc`` to ``dst`` and apply the edits of ``cuts``."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(CSRC, dst)
    for cut in cuts:
        for name, anchor, new in CUTS[cut]:
            path = os.path.join(dst, name)
            text = open(path).read()
            if anchor not in text:
                raise RuntimeError(f"{cut}: {name} no longer has "
                                   f"{anchor.strip()!r}")
            with open(path, "w") as f:
                f.write(text.replace(anchor, new))


def compile_all(jobs: dict) -> dict:
    """{key: (source dir, library name)} -> {key: .so path}, one ``nvcc``
    per job, all started at once."""
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc
    procs = {}
    for key, (src, lib) in jobs.items():
        so = os.path.join(src, f"lib{lib}.so")
        procs[key] = (so, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-I", src, "-o", so,
             os.path.join(src, f"{lib}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        out[key] = so
    return out


def serve(lib: str, so: str) -> None:
    """Make ``library(lib)`` return the library at ``so``."""
    from repro_torch.kernels import build
    cdll = ctypes.CDLL(so)
    cdll.repro_cuda_error_string.argtypes = [ctypes.c_int]
    cdll.repro_cuda_error_string.restype = ctypes.c_char_p
    cdll.repro_cuda_clear_error.argtypes = []
    cdll.repro_cuda_clear_error.restype = ctypes.c_int
    build._LIBS[lib] = cdll


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("targets", nargs="+", choices=sorted(TARGETS))
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("source_cuts: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import (
        device_ms, int8_kernel_cases, kernel_cases, library_cases)

    jobs = {}
    for target in args.targets:
        lib, _, builds = TARGETS[target]
        for name, cuts in builds.items():
            dst = os.path.join(OUT, target, name)
            edited_copy(dst, cuts)
            jobs[(target, name)] = (dst, lib)
    sos = compile_all(jobs)
    for target in args.targets:
        lib, kernels, builds = TARGETS[target]
        if set(kernels) <= set(LIBRARY_KERNELS):
            for case, *_ in library_cases(0):
                if case[0] not in kernels:
                    continue
                cells = []
                reps, windows = (2, 3) if case[0] in SCANS else (20, 5)
                for name in builds:
                    serve(lib, sos[(target, name)])
                    cells.append(f"{name} "
                                 f"{device_ms(case[3], reps, windows):.5f}")
                print(f"[cuts {target}] {case[0]} {case[2]} ms per call: "
                      + ", ".join(cells), flush=True)
            continue
        for batch in (1, 8):
            gen = torch.Generator().manual_seed(batch)
            for case in kernel_cases(batch, gen) \
                    + int8_kernel_cases(batch, gen):
                if case[0] not in kernels:
                    continue
                cells = []
                for name in builds:
                    serve(lib, sos[(target, name)])
                    cells.append(f"{name} {device_ms(case[3]) * 1e3:.2f}")
                print(f"[cuts {target}] {case[0]} {case[2]} B={batch} µs "
                      f"per call: " + ", ".join(cells), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
