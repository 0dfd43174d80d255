"""Versioned schedule artifacts: the searched plan, shipped as data.

Counterpart of ``repro/search/artifact.py``.  A ``ScheduleArtifact``
freezes, for one (model config, precision, traffic trace):

  * the serving bucket set the search settled on;
  * per-(bucket, resolution) site decisions (routing, precision, block
    sizes) exactly as ``plan_program`` froze them on the search host,
    and the super-site groups of the same plans with their blocks;
  * a snapshot of the autotuner's cache (``kernels.autotune.
    export_entries``), so tune paths the decisions do not cover hit warm;
  * the searched and default objectives (cycle-model latency weighted by
    the trace's dispatch counts).

Consumption (``serving.executors.ExecutorCache(artifact=)``):
``validate_for`` first, which raises a typed ``ArtifactError`` unless
the artifact was searched for this config and plan precision; then
``overrides_for(batch, resolution)`` hands the planner
``core.fusion.SiteOverride`` pins that reproduce the searched plan with
no tuner consulted.  A (batch, resolution) the artifact does not cover
returns ``None`` and the runtime plans normally.

Backends.  The port's blocks are its Hopper kernels' (``block_rows``,
``block_m``, ``split``, ``block_n``), not the Pallas kernels', and the
port's tuner keys name the card; neither means anything to the other
package.  So the port writes ``backend: "torch-cuda"`` and schema 2, and
refuses, with its own ``ArtifactError`` naming both backends, any
document whose ``backend`` is not its own, every JAX artifact (no
``backend`` field, schema 1) among them.  The JAX package accepts only
schema 1 (its ``ScheduleArtifact.from_dict``), so it refuses the port's
artifacts with its own ``ArtifactError``; nothing in it changes for
that.

The port's artifact also stores each plan's groups (``groups``): the
port's fp super-site tuner sweeps on the card where JAX's band pick is
a fixed rule, so a chain's blocks are pinned too, keyed by the group's
name in the overrides (``core.fusion.plan_program``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Mapping, Optional, Tuple

from repro_torch.common.errors import ArtifactError

__all__ = ["ARTIFACT_SCHEMA", "BACKEND", "ScheduleArtifact", "config_hash"]

ARTIFACT_SCHEMA = 2
BACKEND = "torch-cuda"
# what a document without a ``backend`` field was searched for
_UNNAMED_BACKEND = "jax"


def _jsonable(v):
    if isinstance(v, (int, float, str, bool)) or v is None:
        return v
    if isinstance(v, Mapping):
        return {str(k): _jsonable(x) for k, x in sorted(v.items())}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return str(v)   # e.g. a torch dtype: its repr is stable and compares


def config_hash(cfg) -> str:
    """Stable content hash (hex, 16 chars) of a model config dataclass:
    the canonical-JSON dump of its fields, so any field change (widths,
    depths, image size, head geometry, dtype) invalidates every artifact
    searched for the old one.  The port's config hashes differently from
    the JAX package's (its dtype is a torch dtype)."""
    fields = dataclasses.asdict(cfg) if dataclasses.is_dataclass(cfg) \
        else dict(cfg)
    payload = json.dumps(_jsonable(fields), sort_keys=True,
                         separators=(",", ":"))
    return hashlib.blake2b(payload.encode(), digest_size=8).hexdigest()


def _entry_key(batch: int, resolution: int) -> str:
    return f"{int(batch)}x{int(resolution)}"


@dataclasses.dataclass
class ScheduleArtifact:
    config_hash: str
    precision: str                    # the plan-level request it serves
    trace_fingerprint: str
    buckets: Tuple[int, ...]
    resolutions: Tuple[int, ...]
    # "BxR" -> [SiteDecision.to_dict(), ...] in site order
    entries: Mapping[str, list] = dataclasses.field(default_factory=dict)
    # "BxR" -> [GroupDecision.to_dict(), ...] in plan order
    groups: Mapping[str, list] = dataclasses.field(default_factory=dict)
    tuner_cache: Mapping[str, dict] = dataclasses.field(
        default_factory=dict)
    demoted: Tuple[str, ...] = ()     # sites the search demoted
    breaks: Tuple[str, ...] = ()      # group boundaries it split
    objective: float = 0.0            # searched trace-weighted cycles
    default_objective: float = 0.0    # the default schedule's
    seed: int = 0
    config_name: str = ""
    backend: str = BACKEND
    schema: int = ARTIFACT_SCHEMA

    # -- consumption -----------------------------------------------------
    def validate_for(self, cfg, precision: str) -> "ScheduleArtifact":
        """Raises ``ArtifactError`` unless this artifact was searched for
        exactly this config and plan precision."""
        want = config_hash(cfg)
        if self.config_hash != want:
            raise ArtifactError(
                f"schedule artifact was searched for config "
                f"{self.config_name or self.config_hash!r} (hash "
                f"{self.config_hash}) but the engine is serving "
                f"{getattr(cfg, 'name', cfg)!r} (hash {want}) — "
                f"search again for this config")
        if self.precision != precision:
            raise ArtifactError(
                f"schedule artifact was searched at precision "
                f"{self.precision!r}, engine requests {precision!r}")
        return self

    def decisions_for(self, batch: int, resolution: int
                      ) -> Optional[list]:
        return self.entries.get(_entry_key(batch, resolution))

    def groups_for(self, batch: int, resolution: int) -> Optional[list]:
        return self.groups.get(_entry_key(batch, resolution))

    def overrides_for(self, batch: int, resolution: int
                      ) -> Optional[dict]:
        """``plan_program(overrides=...)`` pins reproducing the searched
        plan for one executor shape, or ``None`` when the artifact does
        not cover it (e.g. a sharded executor's local batch).

        Super-site groups are pinned as in JAX's: a stored decision that
        does not continue its predecessor's group gets
        ``group_break=True``, so the grouping pass re-forms exactly the
        searched chains.  Each stored group's blocks are pinned under the
        group's name, so the chain's tuner is not consulted either.
        """
        from repro_torch.core.fusion import SiteOverride
        stored = self.decisions_for(batch, resolution)
        if stored is None:
            return None
        out = {d["name"]: SiteOverride.from_decision(d) for d in stored}
        prev_group = None
        for d in stored:
            if "group" not in d:
                continue
            g = d.get("group") or ""
            if not (g and g == prev_group):
                out[d["name"]] = dataclasses.replace(
                    out[d["name"]], group_break=True)
            prev_group = g
        for g in self.groups_for(batch, resolution) or ():
            out[g["name"]] = SiteOverride(fused=True,
                                          precision=g.get("precision"),
                                          blocks=dict(g.get("blocks") or {}))
        return out

    # -- persistence -----------------------------------------------------
    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        d["resolutions"] = list(self.resolutions)
        d["demoted"] = list(self.demoted)
        d["breaks"] = list(self.breaks)
        return d

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(self.to_dict(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def from_dict(cls, doc: Mapping) -> "ScheduleArtifact":
        if not isinstance(doc, Mapping):
            raise ArtifactError(f"schedule artifact is a "
                                f"{type(doc).__name__}, not a mapping")
        backend = doc.get("backend", _UNNAMED_BACKEND)
        if backend != BACKEND:
            raise ArtifactError(
                f"schedule artifact was searched for backend {backend!r}; "
                f"this package serves {BACKEND!r}, whose blocks and tuner "
                f"entries differ — search again with this package")
        if doc.get("schema") != ARTIFACT_SCHEMA:
            raise ArtifactError(
                f"schedule artifact has schema {doc.get('schema')!r}, "
                f"expected {ARTIFACT_SCHEMA} — search again with this "
                f"build")
        try:
            return cls(
                config_hash=str(doc["config_hash"]),
                precision=str(doc["precision"]),
                trace_fingerprint=str(doc["trace_fingerprint"]),
                buckets=tuple(int(b) for b in doc["buckets"]),
                resolutions=tuple(int(r) for r in doc["resolutions"]),
                entries={str(k): list(v)
                         for k, v in doc.get("entries", {}).items()},
                groups={str(k): list(v)
                        for k, v in doc.get("groups", {}).items()},
                tuner_cache={str(k): dict(v) for k, v in
                             doc.get("tuner_cache", {}).items()},
                demoted=tuple(str(s) for s in doc.get("demoted", ())),
                breaks=tuple(str(s) for s in doc.get("breaks", ())),
                objective=float(doc.get("objective", 0.0)),
                default_objective=float(doc.get("default_objective", 0.0)),
                seed=int(doc.get("seed", 0)),
                config_name=str(doc.get("config_name", "")))
        except (KeyError, TypeError, ValueError) as e:
            raise ArtifactError(f"schedule artifact malformed: {e}") from e

    @classmethod
    def load(cls, path: str) -> "ScheduleArtifact":
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise ArtifactError(
                f"schedule artifact {path!r} unreadable: {e}") from e
        return cls.from_dict(doc)
