#!/usr/bin/env python3
"""Time the phases of the FIX8 MBConv's cluster kernel on one CUDA card.

    python3 tools/mbconv_int8_phases.py [--no-division]

Builds an instrumented copy of ``src/repro_torch/csrc`` under
``build/phases/``: thread 0 of the first and the last rank of image 0
reads ``%globaltimer`` at each phase boundary of ``mbi8_cluster``
(staging, PW1, the mid map's cluster max, its quantization, DW, the DW
map's cluster max, its quantization, PW2, the epilogue, the last cluster
barrier).  Runs the served B1@224 shapes (S3, S4, S3.down, S4.down) at
batch 1 and 8 on random int8 codes and prints each phase's µs, the
first rank's, and the launch's CUDA-event time.

``--no-division`` also times a build whose requantization and Hardswish
multiply by a reciprocal instead of dividing (``tools/source_cuts.py``'s
``division`` cut).  That build is NOT
bit-exact and serves no caller: it is a timing experiment that shows
what the kernel's IEEE divisions (``__fdiv_rn``) cost.

Needs a CUDA card and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "phases")
PHASES = ("stage", "pw1", "cmax_mid", "quant_mid", "dw", "cmax_dw",
          "quant_dw", "pw2", "epilogue", "last_sync")
# The source line before which each phase boundary is read.
ANCHORS = (
    "  // stage the image, both weight slices and the DW taps\n",
    "  // PW1: [P x C] . [C x ms] -> dequant -> Hardswish -> the fp32 mid "
    "slice\n",
    "  const float s_mid =\n",
    "  // quantize the mid slice once, into [H+2][W+2][ms] with a zero ring\n",
    "  // DW 3x3 at the stride anchors s - 1 -> dequant -> Hardswish, 4\n",
    "  const float s_dw =\n",
    "  // quantize the DW slice once: the codes every rank's PW2 reads\n",
    "  // PW2: [Po x M] (every rank's codes, through DSMEM) . [M x fs].  "
    "Warps\n",
    "  // dequant, the fp32 output and (emitting) its absmax\n",
    "  cl.sync();  // every rank's DW codes stay alive until all have read "
    "them\n",
)
SHAPES = {"S3": (14, 128, 512, 128, 1), "S4": (7, 256, 1024, 256, 1),
          "S3.down": (28, 64, 256, 128, 2), "S4.down": (14, 128, 512, 256, 2)}


def instrumented(variant: str) -> str:
    """Copy the sources (``no_division``: with ``source_cuts.py``'s
    ``division`` cut), add the timer reads, build; the library path."""
    from source_cuts import compile_all, edited_copy
    dst = os.path.join(OUT, variant)
    edited_copy(dst, ("division",) if variant == "no_division" else ())
    path = os.path.join(dst, "mbconv_int8.cuh")
    text = open(path).read()
    text = text.replace("namespace cg = cooperative_groups;", """\
namespace cg = cooperative_groups;
__device__ unsigned long long mbi8_phase_ns[2][16];
#define MARK(i)                                                        \\
  if (threadIdx.x == 0 && blockIdx.y == 0 &&                           \\
      (rank == 0 || rank == ranks - 1)) {                              \\
    unsigned long long t_;                                             \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));             \\
    mbi8_phase_ns[rank == 0 ? 0 : 1][i] = t_;                          \\
  }""", 1)
    for i, anchor in enumerate(ANCHORS):
        if anchor not in text:
            raise RuntimeError(f"phase anchor not in the source: {anchor!r}")
        text = text.replace(anchor, f"  MARK({i});\n" + anchor, 1)
    last = ANCHORS[-1]
    text = text.replace(last, last + f"  MARK({len(ANCHORS)});\n", 1)
    open(path, "w").write(text)
    with open(os.path.join(dst, "mbconv_int8.cu"), "a") as f:
        f.write("\nREPRO_EXPORT int mbi8_phase_read(unsigned long long* o) "
                "{\n  return (int)cudaMemcpyFromSymbol(o, mbi8_phase_ns, "
                "sizeof(mbi8_phase_ns));\n}\n")
    return compile_all({variant: (dst, "mbconv_int8")})[variant]


def run(so: str, variant: str) -> None:
    import torch
    lib = ctypes.CDLL(so)
    fn = lib.mbconv_int8_i8
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 8 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator().manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for batch in (1, 8):
        for name, (H, C, M, F, st) in SHAPES.items():
            i8 = lambda *sh: torch.randint(-128, 128, sh, generator=gen,
                                           dtype=torch.int8).cuda()
            sc = lambda *sh: (1e-2 * (0.5 + torch.rand(
                sh, generator=gen))).cuda()
            rn = lambda *sh: torch.randn(sh, generator=gen).cuda()
            args = [i8(batch, H, H, C), sc(batch), i8(C, M), 0.2 * sc(M),
                    rn(M), i8(3, 3, M), sc(M), rn(M), i8(M, F), sc(F), rn(F)]
            ho = H // st
            out = torch.empty((batch, ho, ho, F), device="cuda")
            emit = st == 2
            q = torch.empty((batch, ho, ho, F), dtype=torch.int8,
                            device="cuda")
            scales = torch.empty((batch,), device="cuda")
            ptrs = [t.data_ptr() for t in args] + [
                None, None, out.data_ptr(), None,
                q.data_ptr() if emit else None,
                scales.data_ptr() if emit else None]
            call = lambda: fn(*ptrs, batch, H, H, C, M, F, st, 16, stream)
            for _ in range(5):
                if call():
                    raise RuntimeError(f"{name}: launch failed")
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 32)()
            if lib.mbi8_phase_read(buf):
                raise RuntimeError("reading the phase timers failed")
            t = [buf[i] for i in range(len(PHASES) + 1)]
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(20):
                call()
            end.record()
            end.synchronize()
            print(f"[phases {variant}] {name} B={batch}: launch "
                  f"{start.elapsed_time(end) / 20 * 1e3:.2f} us (events); "
                  f"rank 0 {(t[-1] - t[0]) / 1e3:.2f} us: " + " ".join(
                      f"{p}={(t[i + 1] - t[i]) / 1e3:.2f}"
                      for i, p in enumerate(PHASES)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--no-division", action="store_true",
                    help="also time the (not bit-exact) build without the "
                         "IEEE divisions")
    args = ap.parse_args()
    sys.path[:0] = [os.path.dirname(os.path.abspath(__file__)),
                    os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("mbconv_int8_phases: no CUDA device is available",
              file=sys.stderr)
        return 1
    for variant in ("exact",) + (("no_division",) if args.no_division
                                 else ()):
        run(instrumented(variant), variant)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
