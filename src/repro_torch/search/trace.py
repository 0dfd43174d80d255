"""Recorded traffic traces: the workload a schedule is searched against.

Counterpart of ``repro/search/trace.py``, in the same file format.  A
trace is ``[(arrival_seconds, resolution), ...]`` in arrival order; it
names no backend, so the JAX package and the port read each other's
trace files and give them the same fingerprint.  The offline search
(``repro_torch.search.drivers``) replays a trace through ``workload()``,
a deterministic host-side mirror of the serving scheduler's batch
formation, to learn how often each (bucket, resolution) executor would
dispatch; those counts weight the cycle-model objective.

A trace file carries ``TRACE_SCHEMA``, and loading rejects a mismatch
with a typed ``ArtifactError`` rather than reinterpreting old bytes.
"""
from __future__ import annotations

import collections
import hashlib
import json
import os
from typing import List, Mapping, Sequence, Tuple

from repro_torch.common.errors import ArtifactError

__all__ = ["TRACE_SCHEMA", "save_trace", "load_trace",
           "trace_fingerprint", "workload"]

TRACE_SCHEMA = 1


def _canonical(trace) -> List[Tuple[float, int]]:
    out = []
    for at, res in trace:
        at, res = float(at), int(res)
        assert at >= 0 and res > 0, (at, res)
        out.append((at, res))
    return out


def trace_fingerprint(trace) -> str:
    """Stable content hash of a trace (hex, 16 chars): artifacts pin the
    trace they were searched against."""
    payload = json.dumps(_canonical(trace), separators=(",", ":"))
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def save_trace(path: str, trace, *, spec: Mapping | None = None) -> str:
    """Write a trace JSON (schema-stamped, atomic replace); returns the
    fingerprint.  ``spec`` rides along as provenance (the generator's
    knobs); load ignores it."""
    reqs = _canonical(trace)
    doc = {"schema": TRACE_SCHEMA, "fingerprint": trace_fingerprint(reqs),
           "requests": [[at, res] for at, res in reqs]}
    if spec is not None:
        doc["spec"] = {k: v if isinstance(v, (int, float, str, bool))
                       else list(v) for k, v in spec.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return doc["fingerprint"]


def load_trace(path: str) -> List[Tuple[float, int]]:
    """Read a trace JSON; raises ``ArtifactError`` on a schema-version
    mismatch or a structurally invalid file."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise ArtifactError(f"trace {path!r} unreadable: {e}") from e
    if not isinstance(doc, dict) or doc.get("schema") != TRACE_SCHEMA:
        got = doc.get("schema") if isinstance(doc, dict) else None
        raise ArtifactError(
            f"trace {path!r} has schema {got!r}, expected {TRACE_SCHEMA} "
            f"— record it again")
    try:
        return _canonical(doc["requests"])
    except (KeyError, TypeError, ValueError, AssertionError) as e:
        raise ArtifactError(f"trace {path!r} malformed: {e}") from e


def workload(trace, buckets: Sequence[int], *,
             deadline_ms: float | None = None) -> dict:
    """Dispatch counts per (bucket, resolution) under the serving
    runtime's bucketed batch formation: the occupancy weights of the
    search objective.

    One scheduler step per arrival (full largest buckets dispatch at
    once, a deadline-due tail flushes to the smallest covering bucket),
    then the straggler step after the deadline elapses, then the final
    drain.  The batches are formed by the port's own
    ``serving.scheduler.BucketedPolicy.form``, so the model follows what
    serving does."""
    from repro_torch.serving.scheduler import BucketedPolicy

    buckets = tuple(sorted(set(int(b) for b in buckets)))
    assert buckets and buckets[0] >= 1, buckets
    form = BucketedPolicy().form
    queues: dict[int, collections.deque] = {}
    counts: dict[Tuple[int, int], int] = collections.Counter()

    def step(now: float, drain: bool = False) -> None:
        for res, q in queues.items():
            due = drain or (deadline_ms is not None and any(
                now >= at + deadline_ms / 1e3 for at in q))
            for size in form(len(q), buckets, due):
                take = min(size, len(q))
                if take == 0:
                    break
                for _ in range(take):
                    q.popleft()
                counts[(size, res)] += 1

    clock = 0.0
    for at, res in _canonical(trace):
        clock = max(clock, at)
        queues.setdefault(res, collections.deque()).append(at)
        step(clock)
    if deadline_ms is not None:
        clock += deadline_ms / 1e3
    step(clock)
    step(clock, drain=True)
    assert not any(queues.values()), "workload model dropped requests"
    return dict(counts)
