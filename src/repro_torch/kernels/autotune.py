"""Block autotuner for the CUDA kernels, with a persistent cache.

Counterpart of ``repro/kernels/autotune.py``.  ``autotune()`` times a
candidate list of block choices on the real kernel and remembers the
winner in an on-disk JSON cache, so the sweep runs once per (kind, key)
per machine and every later process reuses the choice without timing.

Timing is CUDA events on the current stream: one warm-up call, then the
median over a few windows of the mean device time of back-to-back calls,
a sleep kernel queued first so the host's enqueue does not count.  A
sweep never runs while the current stream captures a CUDA graph: the
planner tunes at plan time, before an executor's eager warm-up and its
capture.  ``bench=None`` (off the card) returns the cached choice or
``candidates[0]``, which every tuner of the port makes its deterministic
pick.  A tuner asked not to sweep (a planner's ``autotune=False``)
returns that pick whatever the cache holds, without consulting it; it
still passes ``fault_point``, where every consultation starts.

Cache location: ``$REPRO_TORCH_AUTOTUNE_CACHE`` if set, else
``~/.cache/repro_torch/autotune.json``.  It never shares the JAX
package's file: the same key names other blocks there.  Keys carry the
card (``backend_tag``), so two cards never share a choice.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import time
import warnings
from typing import Callable, Sequence

__all__ = ["autotune", "shape_key", "tile_work", "backend_tag",
           "cache_path", "clear_memory_cache", "set_fault_hook",
           "export_entries", "import_entries", "time_cuda", "on_card",
           "fault_point", "bench_randn", "SWEEP_COUNT",
           "DISQUALIFIED", "SWEEP_LOG", "SWEEP_LAUNCHES", "AUTOTUNE_SCHEMA"]

# On-disk cache schema version.  The file is a flat {key: choice} dict
# plus one reserved ``_SCHEMA_KEY`` row carrying {"version": N}.  A file
# whose version is missing or different is rejected with a warning
# (affected shapes re-tune; the next save rewrites it).  Bump this
# whenever ``shape_key`` fields or a family's block names change.
AUTOTUNE_SCHEMA = 1
_SCHEMA_KEY = "__schema__"

# in-memory cache: {cache_key: choice-dict}; mirrors the on-disk file
_MEM: dict[str, dict] = {}
_DISK_LOADED: set[str] = set()

# failure-injection hook (serving.faults.FaultPlan.install): called as
# hook(kind, key) at the top of every consultation.  None in production.
_FAULT_HOOK: Callable[[str, Sequence], None] | None = None

# timed sweeps this process has run (a warm cache runs none)
SWEEP_COUNT = 0
# candidates whose bench raised (each disqualified from its sweep)
DISQUALIFIED = 0
# one entry per sweep: {"kind", "key", "times": [(candidate, seconds or
# None, error or None)], "choice", "seconds"} (the sweep's wall time)
SWEEP_LOG: list[dict] = []
# kernel launches the sweeps made, by wrapper name (the wrappers count
# them like any launch; a caller counting a path's launches subtracts
# these)
SWEEP_LAUNCHES: dict[str, int] = {}


def set_fault_hook(hook: Callable[[str, Sequence], None] | None) -> None:
    global _FAULT_HOOK
    _FAULT_HOOK = hook


def cache_path() -> str:
    p = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache", "repro_torch",
                        "autotune.json")


def clear_memory_cache() -> None:
    """Drop the in-process cache (the next consultation reloads the
    file)."""
    _MEM.clear()
    _DISK_LOADED.clear()


def backend_tag(device) -> str:
    """The key's backend: ``cuda:<card name>`` on the card, else ``cpu``."""
    import torch
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return "cpu"
    return f"cuda:{torch.cuda.get_device_name(device)}"


def _read_cache_file(path: str) -> dict:
    """Parse the cache file into {key: choice-dict}, tolerating damage:
    a corrupt or truncated file costs a warning and a re-tune, never a
    crash, and malformed entries are dropped one by one."""
    try:
        with open(path) as f:
            raw = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        warnings.warn(
            f"autotune cache {path!r} is corrupt ({e!r}); ignoring it — "
            f"affected shapes will re-tune and the next save rewrites "
            f"the file atomically", RuntimeWarning, stacklevel=3)
        return {}
    if not isinstance(raw, dict):
        warnings.warn(
            f"autotune cache {path!r} holds {type(raw).__name__}, not a "
            f"dict; ignoring it", RuntimeWarning, stacklevel=3)
        return {}
    schema = raw.pop(_SCHEMA_KEY, None)
    version = schema.get("version") if isinstance(schema, dict) else None
    if version != AUTOTUNE_SCHEMA:
        warnings.warn(
            f"autotune cache {path!r} has schema version {version!r} but "
            f"this build expects {AUTOTUNE_SCHEMA}; rejecting the cache — "
            f"affected shapes will re-tune and the next save rewrites the "
            f"file at the current schema", RuntimeWarning, stacklevel=3)
        return {}
    bad = [k for k, v in raw.items() if not isinstance(v, dict)]
    if bad:
        warnings.warn(
            f"autotune cache {path!r}: dropping {len(bad)} malformed "
            f"entries (first: {bad[0]!r})", RuntimeWarning, stacklevel=3)
    return {k: v for k, v in raw.items() if isinstance(v, dict)}


def _load_disk(path: str) -> None:
    if path in _DISK_LOADED:
        return
    _DISK_LOADED.add(path)
    _MEM.update(_read_cache_file(path))


def _save_disk(path: str) -> None:
    """Merge over the file's current state (processes tuning other
    shapes keep their entries) and publish atomically: a private temp
    file, fsynced, renamed over the target."""
    try:
        merged = _read_cache_file(path)
        merged.update(_MEM)
        merged[_SCHEMA_KEY] = {"version": AUTOTUNE_SCHEMA}
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError:
        pass  # read-only file system: keep the in-memory cache only


def _key(kind: str, key: Sequence) -> str:
    return f"{kind}|" + ",".join(str(k) for k in key)


def shape_key(*, batch: int, spatial, dtype: str, backend: str,
              **dims) -> tuple:
    """Canonical cache key of a tuning case: the batch the kernel grids
    over (images for the convs, branches x images x heads for the
    attention), the per-sample extent (H, W) or a token count, labelled
    ``name=value`` dims in sorted order, the dtype and the backend."""
    try:
        spatial = tuple(int(s) for s in spatial)
    except TypeError:
        spatial = (int(spatial),)
    parts = [f"b={int(batch)}", "s=" + "x".join(str(s) for s in spatial)]
    parts += [f"{k}={v}" for k, v in sorted(dims.items())]
    parts += [f"dtype={dtype}", f"backend={backend}"]
    return tuple(parts)


def time_cuda(fn: Callable[[], object], calls: int = 3,
              windows: int = 5) -> float:
    """Seconds of device time of one ``fn()`` on the current stream: a
    warm-up call, then the median over ``windows`` of the mean of
    ``calls`` back-to-back calls between two CUDA events, behind a sleep
    kernel long enough to hide the host's enqueue."""
    import torch
    stream = torch.cuda.current_stream()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2e9 * (1.5 * calls * host_s + 1e-4)))
        start.record(stream)
        for _ in range(calls):
            fn()
        end.record(stream)
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out) / 1e3


def _capturing() -> bool:
    import torch
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def fault_point(kind: str, key: Sequence) -> None:
    """Where every consultation of the tuners starts: calls the
    failure-injection hook, if one is installed, with (kind, key)."""
    if _FAULT_HOOK is not None:
        _FAULT_HOOK(kind, key)


def autotune(kind: str, key: Sequence, candidates: Sequence[dict],
             bench: Callable[[dict], object] | None = None) -> dict:
    """Pick the fastest candidate block choice for (kind, key).

    kind:       kernel family, e.g. "mbconv" / "relu_attn"
    key:        ``shape_key`` tuple identifying the case
    candidates: block dicts, the deterministic pick first
    bench:      callable(candidate) launching the kernel once on the
                card; None -> the cached choice or ``candidates[0]``
                without a sweep.

    A candidate whose bench raises is disqualified (``DISQUALIFIED``
    counts it); if every one raises, ``candidates[0]`` is returned and
    nothing is cached.  Raises ``RuntimeError`` when a sweep would run
    while the current stream captures.
    """
    global SWEEP_COUNT, DISQUALIFIED
    if not candidates:
        raise ValueError("autotune needs at least one candidate")
    fault_point(kind, key)
    path = cache_path()
    _load_disk(path)
    ck = _key(kind, key)
    hit = _MEM.get(ck)
    if hit is not None:
        return dict(hit)
    if bench is None:
        return dict(candidates[0])
    if _capturing():
        raise RuntimeError(f"autotune {ck}: a sweep cannot run while the "
                           f"current stream captures a CUDA graph")

    from repro_torch.kernels.registry import kernel_wrappers
    wrappers = kernel_wrappers()
    before = {n: w.launches for n, w in wrappers.items()}
    SWEEP_COUNT += 1
    t_sweep = time.perf_counter()
    best_t, best_c, times = float("inf"), None, []
    for cand in candidates:
        try:
            t = time_cuda(lambda: bench(cand))
        except Exception as e:
            DISQUALIFIED += 1
            times.append((dict(cand), None, repr(e)))
            continue
        times.append((dict(cand), t, None))
        if t < best_t:
            best_t, best_c = t, dict(cand)
    for n, w in wrappers.items():
        if w.launches != before[n]:
            SWEEP_LAUNCHES[n] = SWEEP_LAUNCHES.get(n, 0) + \
                w.launches - before[n]
    SWEEP_LOG.append({"kind": kind, "key": tuple(key), "times": times,
                      "choice": best_c,
                      "seconds": time.perf_counter() - t_sweep})
    if best_c is None:       # every candidate failed: fall back, no cache
        return dict(candidates[0])
    _MEM[ck] = best_c
    _save_disk(path)
    return dict(best_c)


def export_entries() -> dict:
    """Snapshot the cache as {cache_key: choice-dict}, the file's entries
    included."""
    _load_disk(cache_path())
    return {k: dict(v) for k, v in _MEM.items()}


def import_entries(entries: dict, *, persist: bool = False) -> int:
    """Seed the cache from an exported snapshot; returns the count
    adopted.  Imported choices win over those in memory; with
    ``persist`` the merged cache is also written to disk."""
    good = {k: dict(v) for k, v in entries.items()
            if isinstance(k, str) and isinstance(v, dict)
            and k != _SCHEMA_KEY}
    path = cache_path()
    _load_disk(path)
    _MEM.update(good)
    if persist and good:
        _save_disk(path)
    return len(good)


def tile_work(n: int, block: int) -> float:
    """Relative overcompute (>= 1.0) of covering an ``n``-extent axis
    with ``block``-wide tiles: the ragged tail's padding."""
    n, block = int(n), int(block)
    if n <= 0 or block <= 0:
        raise ValueError(f"tile_work needs positive sizes, got {n}, {block}")
    return math.ceil(n / block) * block / n


TUNE_SEED = 0    # the benches' inputs: random, from this seed


def on_card(device) -> bool:
    """Whether a tuner can time its candidates: ``device`` is a card."""
    import torch
    return device is not None and torch.device(device).type == "cuda"


def bench_randn(device, *shapes, scales=None):
    """Random fp32 tensors of ``shapes`` on ``device`` from a generator
    seeded with ``TUNE_SEED``, each times its scale: a bench times the
    kernel on data like the served maps (a zero map takes other paths,
    e.g. the IEEE division's slow path on zero dividends)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(TUNE_SEED)
    scales = scales or (1.0,) * len(shapes)
    return tuple(torch.randn(s, generator=gen, device=device) * sc
                 for s, sc in zip(shapes, scales))
