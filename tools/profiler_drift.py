#!/usr/bin/env python3
"""How far torch.profiler's device events drift from the host's clock as
a process ages, and whether ``chip_smoke.py``'s served-run check still
holds, on one CUDA card:

    python3 tools/profiler_drift.py [AGE_S ...]     # default: 0 100 190

At each age (seconds since the script started; it waits until then) a
new B1@224 fp32 engine serves ``chip_smoke.serve_trace``'s 12 requests
under one ``torch.profiler`` capture (``chip_smoke.profiled``).  One line
per age: whether ``serve_trace``'s checks held, the offset between the
first served ``cudaMemcpyAsync`` on the host and the first device event,
and the host-to-device copies the capture recorded against the batches
dispatched.  Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    import chip_smoke as cs
    if not torch.cuda.is_available():
        return cs.fail("no CUDA device is available")
    from repro_torch.core.efficientvit import B1, init_efficientvit
    from repro_torch.kernels.build import build
    from repro_torch.kernels.registry import kernel_wrappers
    from repro_torch.serving.vision import VisionEngine, VisionServeConfig

    ages = [float(a) for a in sys.argv[1:]] or [0.0, 100.0, 190.0]
    t_start = time.perf_counter()
    build()
    wrappers = kernel_wrappers()
    expected = dict.fromkeys(wrappers, 0) | {
        "dsconv_fused": 1, "mbconv_fused": 9, "relu_attn_noncausal": 7,
        "supersite_fused": 2}
    gen = torch.Generator().manual_seed(0)
    cs.fresh_cache("drift")
    params = init_efficientvit(gen, B1, "cuda")
    cs.randomize_bn(params, gen)
    images = np.random.default_rng(0).standard_normal(
        (12, 224, 224, 3)).astype(np.float32)
    captures = []
    profiled = cs.profiled

    @contextlib.contextmanager
    def keep(host=True):
        with profiled(host) as prof:
            captures.append(prof)
            yield prof

    cs.profiled = keep
    for age in ages:
        while time.perf_counter() - t_start < age:
            time.sleep(1.0)
        now = time.perf_counter() - t_start
        try:
            cs.serve_trace(lambda: VisionEngine(
                params, B1, VisionServeConfig(microbatch=8)), images,
                wrappers, expected, f"drift {now:.0f} s")
            held = "held"
        except AssertionError as e:
            held = f"FAILED ({str(e)[:60]})"
        events = captures[-1].events()
        dev = sorted((e for e in events if e.device_type == DeviceType.CUDA
                      and not cs.is_range(e.name)),
                     key=lambda e: e.time_range.start)
        host = sorted((e for e in events if e.device_type == DeviceType.CPU
                       and e.name == "cudaMemcpyAsync"),
                      key=lambda e: e.time_range.start)
        htod = sum("Memcpy HtoD" in e.name for e in dev)
        offset = dev[0].time_range.start - host[0].time_range.start
        print(f"[drift] age {now:.1f} s: serve_trace {held}; first device "
              f"event {offset / 1e3:.3f} ms after the first served "
              f"cudaMemcpyAsync; {htod} host-to-device copies recorded",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
