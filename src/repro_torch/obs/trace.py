"""Request tracing: monotonic-clock spans with Chrome/Perfetto export.

Counterpart of ``repro/obs/trace.py``, copied closely: ``Tracer`` is the
timeline of the serving runtime, a span recorder threaded through the
scheduler, the executor cache, the sharding layer and the fault
injector:

    tracer = Tracer()
    root = tracer.begin("request", rid=3, resolution=224)
    with tracer.span("queue", parent=root):
        ...
    tracer.event(root, "retry", attempt=1, error="KernelLaunchError")
    tracer.end(root, status="completed")
    tracer.export("trace.json")        # open in chrome://tracing / Perfetto

Design constraints:

  * **Host clocks only.**  This module imports only the standard
    library, and a span boundary never waits on the card: recording a
    span on the dispatch path costs two host clock reads and a deque
    append.  The device-side window of a batch is the span between
    dispatch and the host's copy of its logits, both host-observed;
    per-site device time lives in ``repro_torch.obs.profile`` (opt-in,
    not the serving path).
  * **Injectable clock.**  The scheduler's ``ManualClock`` plugs in, so
    span timing in tests and trace replays is deterministic.
  * **Bounded memory.**  Finished spans live in a ring buffer
    (``capacity``, default 4096); ``dropped`` counts what the ring
    evicted.

## Trace JSON schema (``export`` / ``to_chrome``)

Chrome trace-event format, the subset Perfetto and ``chrome://tracing``
both load::

    {"schema": TRACE_SCHEMA,          # repo versioning (extra key; both
     "displayTimeUnit": "ms",         #  viewers ignore unknown keys)
     "traceEvents": [
       {"ph": "M", "pid": 1, "tid": 0, "name": "thread_name",
        "args": {"name": "scheduler"}},           # track labels
       {"ph": "X", "pid": 1, "tid": 0, "name": "request",
        "ts": <µs>, "dur": <µs>, "cat": "scheduler",
        "args": {"span_id": 1, "parent_id": null, ...attrs}},
       {"ph": "i", "pid": 1, "tid": 0, "name": "retry", "ts": <µs>,
        "s": "t", "args": {"span_id": 1, ...attrs}},
     ]}

``ph: "X"`` are complete spans (timestamps in microseconds relative to
the tracer's epoch), ``ph: "i"`` are span *events* (instants attached
to their span's track), ``ph: "M"`` metadata rows naming the tracks.
Parent/child structure is carried in ``args`` (``span_id`` /
``parent_id``) and visually by time-nesting within a track.
``validate_chrome_trace`` checks this shape; ``request_chains`` walks
it back into per-request span chains (the CI smoke gate).
"""
from __future__ import annotations

import contextlib
import collections
import dataclasses
import itertools
import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TRACE_SCHEMA", "Span", "Tracer", "validate_chrome_trace",
           "request_chains"]

TRACE_SCHEMA = 1


@dataclasses.dataclass
class Span:
    """One timed operation.  ``end_ts`` is None while the span is open;
    ``events`` are (timestamp, name, attrs) instants attached to it."""
    name: str
    span_id: int
    parent_id: Optional[int]
    start: float
    track: str = "scheduler"
    end_ts: Optional[float] = None
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    events: List[Tuple[float, str, Dict[str, Any]]] = \
        dataclasses.field(default_factory=list)

    @property
    def duration(self) -> Optional[float]:
        return None if self.end_ts is None else self.end_ts - self.start

    @property
    def finished(self) -> bool:
        return self.end_ts is not None

    def event_names(self) -> Tuple[str, ...]:
        return tuple(name for _, name, _ in self.events)


class Tracer:
    """Thread-safe span recorder with a bounded finished-span ring.

    ``clock`` is any zero-arg callable returning seconds (default
    ``time.monotonic``); all span math is relative to the first reading,
    so a ``ManualClock`` starting at 0 and the monotonic clock export
    identically shaped traces.
    """

    def __init__(self, *, clock=None, capacity: int = 4096):
        assert capacity >= 1, capacity
        self.clock = clock if clock is not None else time.monotonic
        self.capacity = int(capacity)
        self._done: collections.deque = collections.deque(maxlen=capacity)
        self._open: Dict[int, Span] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._epoch: Optional[float] = None
        self.dropped = 0

    # -- recording -------------------------------------------------------
    def _now(self) -> float:
        t = float(self.clock())
        if self._epoch is None:
            self._epoch = t
        return t - self._epoch

    def begin(self, name: str, *, parent: Span | None = None,
              track: str | None = None, **attrs) -> Span:
        """Open a span.  ``parent`` links it (and defaults the track)."""
        with self._lock:
            span = Span(name=name, span_id=next(self._ids),
                        parent_id=parent.span_id if parent is not None
                        else None, start=self._now(),
                        track=(track if track is not None else
                               parent.track if parent is not None
                               else "scheduler"),
                        attrs=dict(attrs))
            self._open[span.span_id] = span
            return span

    def end(self, span: Span, **attrs) -> Span:
        """Close a span (idempotent); late ``attrs`` merge in."""
        with self._lock:
            span.attrs.update(attrs)
            if span.end_ts is None:
                span.end_ts = self._now()
                self._open.pop(span.span_id, None)
                if len(self._done) == self.capacity:
                    self.dropped += 1
                self._done.append(span)
            return span

    def event(self, span: Optional[Span], name: str, **attrs) -> None:
        """Attach an instant event to ``span`` (no-op on None, so call
        sites can pass an optional span handle unguarded)."""
        if span is None:
            return
        with self._lock:
            span.events.append((self._now(), name, dict(attrs)))

    @contextlib.contextmanager
    def span(self, name: str, *, parent: Span | None = None,
             track: str | None = None, **attrs):
        s = self.begin(name, parent=parent, track=track, **attrs)
        try:
            yield s
        finally:
            self.end(s)

    # -- introspection ---------------------------------------------------
    def spans(self, name: str | None = None) -> List[Span]:
        """Finished spans, oldest first (optionally filtered by name)."""
        with self._lock:
            return [s for s in self._done
                    if name is None or s.name == name]

    def open_spans(self) -> List[Span]:
        with self._lock:
            return list(self._open.values())

    def __len__(self) -> int:
        return len(self._done)

    # -- export ----------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome trace-event JSON dict (see the module docstring)."""
        with self._lock:
            spans = list(self._done) + list(self._open.values())
        tracks = {}

        def tid(track: str) -> int:
            return tracks.setdefault(track, len(tracks))

        events: List[dict] = []
        for s in sorted(spans, key=lambda s: s.start):
            t = tid(s.track)
            args = {"span_id": s.span_id, "parent_id": s.parent_id}
            args.update(s.attrs)
            end = s.end_ts if s.end_ts is not None else s.start
            events.append({
                "ph": "X", "pid": 1, "tid": t, "name": s.name,
                "cat": s.track, "ts": round(s.start * 1e6, 3),
                "dur": round((end - s.start) * 1e6, 3), "args": args})
            for ts, name, attrs in s.events:
                events.append({
                    "ph": "i", "pid": 1, "tid": t, "name": name,
                    "ts": round(ts * 1e6, 3), "s": "t",
                    "args": dict({"span_id": s.span_id}, **attrs)})
        meta = [{"ph": "M", "pid": 1, "tid": t, "name": "thread_name",
                 "args": {"name": track}}
                for track, t in sorted(tracks.items(), key=lambda kv: kv[1])]
        return {"schema": TRACE_SCHEMA, "displayTimeUnit": "ms",
                "traceEvents": meta + events}

    def export(self, path: str) -> dict:
        """Write the Chrome trace JSON to ``path``; returns the dict."""
        doc = self.to_chrome()
        with open(path, "w") as f:
            json.dump(doc, f, indent=1)
        return doc


# ---------------------------------------------------------------------------
# schema validation + chain reconstruction (tests / CI smoke gates)
# ---------------------------------------------------------------------------

def validate_chrome_trace(doc: dict) -> int:
    """Validate the exported trace shape; returns the number of complete
    (``ph: "X"``) spans.  Raises ``ValueError`` naming the first bad
    record — this is the schema gate the CI obs job runs on the
    serving_bench trace capture."""
    if not isinstance(doc, dict):
        raise ValueError(f"trace document is {type(doc).__name__}, not dict")
    if doc.get("schema") != TRACE_SCHEMA:
        raise ValueError(f"trace schema {doc.get('schema')!r} != "
                         f"{TRACE_SCHEMA}")
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError("traceEvents missing or not a list")
    n_complete = 0
    for i, ev in enumerate(events):
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            raise ValueError(f"traceEvents[{i}]: unknown ph {ph!r}")
        if "name" not in ev or "pid" not in ev or "tid" not in ev:
            raise ValueError(f"traceEvents[{i}]: missing name/pid/tid")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            raise ValueError(f"traceEvents[{i}]: bad ts {ts!r}")
        if "span_id" not in ev.get("args", {}):
            raise ValueError(f"traceEvents[{i}]: args.span_id missing")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"traceEvents[{i}]: bad dur {dur!r}")
            n_complete += 1
    return n_complete


def request_chains(doc: dict) -> Dict[int, dict]:
    """Reconstruct per-request span chains from an exported trace.

    Returns ``{rid: {"request": <event>, "children": {name, ...},
    "events": (name, ...), "member_of": {span name, ...}}}`` where
    ``children`` are the names of spans parented under the request span,
    ``events`` its attached instants, and ``member_of`` the batch-level
    spans (dispatch / device / finalize) whose ``rids`` attr lists this
    request.  A *complete* chain for a completed request is
    ``{"queue"} <= children`` and ``{"dispatch", "device", "finalize"}
    <= member_of`` — the full admit -> queue -> dispatch -> device ->
    finalize path.
    """
    spans = [ev for ev in doc.get("traceEvents", ())
             if ev.get("ph") == "X"]
    instants = [ev for ev in doc.get("traceEvents", ())
                if ev.get("ph") == "i"]
    by_id = {ev["args"]["span_id"]: ev for ev in spans}
    chains: Dict[int, dict] = {}
    for ev in spans:
        if ev["name"] != "request":
            continue
        rid = ev["args"].get("rid")
        if rid is None:
            continue
        sid = ev["args"]["span_id"]
        chains[rid] = {"request": ev, "children": set(), "events": (),
                       "member_of": set(), "span_id": sid}
    for ev in spans:
        parent = ev["args"].get("parent_id")
        if parent is None:
            rids = ev["args"].get("rids") or ()
            for rid in rids:
                if rid in chains:
                    chains[rid]["member_of"].add(ev["name"])
            continue
        root = by_id.get(parent)
        if root is not None and root["name"] == "request":
            rid = root["args"].get("rid")
            if rid in chains:
                chains[rid]["children"].add(ev["name"])
    for rid, chain in chains.items():
        sid = chain["span_id"]
        chain["events"] = tuple(ev["name"] for ev in instants
                                if ev["args"].get("span_id") == sid)
    return chains
