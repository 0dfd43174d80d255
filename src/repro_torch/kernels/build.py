"""Build the port's CUDA kernels and load them with ctypes.

Each source ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, under
``build/repro_torch/`` at the repo root.  The library's file name
carries a hash of the sources and flags, so an edited kernel rebuilds
and a stale library is never loaded.  ``build()`` starts one ``nvcc``
per missing library, all at once.

Nothing here falls back: a failed build raises with the compiler's
output, and a kernel launch that CUDA refuses raises
``KernelLaunchError`` from ``check``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from repro_torch.common.errors import KernelLaunchError

__all__ = ["SOURCES", "BUILD_DIR", "build", "library", "library_path",
           "check", "check_input", "stream_of"]

SOURCES = ("dsconv", "mbconv", "relu_attn", "int8_matmul", "dsconv_int8",
           "mbconv_int8", "group_agg", "supersite", "supersite_int8",
           "relu_attn_causal", "ssd")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (PATH or {cuda_home}/bin); "
                           "the port's kernels need the CUDA toolkit")
    return path


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(f.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, in parallel.  Returns {name: compiler output}
    (``-Xptxas -v``: registers, shared memory and spills per kernel) for
    the libraries built by this call."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, so = _target(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        jobs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, errors = {}, []
    for name, so, tmp, proc in jobs:
        out, _ = proc.communicate()
        if proc.returncode:
            errors.append(f"--- {name} (nvcc exit {proc.returncode})\n{out}")
        else:
            os.replace(tmp, so)
            logs[name] = out
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return logs


def library_path(name: str) -> Path:
    """Where the library ``name`` of the current sources is built."""
    return _target(name)[1]


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_target(name)[1]))
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_cuda_clear_error.argtypes = []
            lib.repro_cuda_clear_error.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, kernel: str) -> None:
    """Raise when a C entry point returned a CUDA error code, after
    clearing the thread's last CUDA error so the next launch does not
    report this one."""
    if status != 0:
        lib.repro_cuda_clear_error()
        msg = lib.repro_cuda_error_string(status).decode()
        raise KernelLaunchError(f"{kernel}: CUDA error {status}: {msg}")


def check_input(t: torch.Tensor, name: str, shape, device,
                dtype=torch.float32) -> None:
    """Validate one kernel input before its pointer reaches C."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a pointer."""
    return torch.cuda.current_stream(t.device).cuda_stream
