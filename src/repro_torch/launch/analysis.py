"""Roofline terms of one step, counterpart of ``repro/launch/analysis.py``
with the H100's constants in place of the TPU v5e's.

``launch/cost.py`` gives a step's per-rank FLOPs, bytes and collective
bytes (counted on the meta device: the port has no compiler to ask);
:class:`RooflineTerms` turns them into the three times and the bound.
JAX's HLO regexes (``collective_bytes``, ``_COLL_RE``) have nothing to
parse here and are not ported.

The collective term uses one bandwidth, NVLink's per direction between
two cards of one host.  An axis that crosses hosts (the 256- and
512-card meshes span 32 and 64 eight-card hosts) runs over InfiniBand,
which is slower: the collective term is a lower bound there (ROADMAP C,
Deviations).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_INT8", "HBM_BW", "NVLINK_BW",
           "HBM_BYTES", "RooflineTerms", "model_flops_train",
           "model_flops_decode"]

# --- H100 SXM constants (per card; NVIDIA data sheet, dense) ---
PEAK_FLOPS_BF16 = 989e12         # FLOP/s, bf16 tensor cores
PEAK_FLOPS_INT8 = 1979e12        # OP/s, int8 tensor cores
HBM_BW = 3.35e12                 # B/s, HBM3
NVLINK_BW = 450e9                # B/s, NVLink 4, one direction
HBM_BYTES = 85_017_493_504       # the H100 80GB HBM3 card, as CUDA reports it


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    model_flops_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> Optional[float]:
        if not self.model_flops_per_device:
            return None
        return self.model_flops_per_device / max(self.flops_per_device, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline the step achieves if every
        term overlapped perfectly: compute_time / bound_time."""
        return self.compute_s / max(self.bound_s, 1e-12)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "roofline_fraction": self.roofline_fraction,
            "useful_flops_fraction": self.useful_flops_fraction,
        }


def model_flops_train(n_params_active: int, n_tokens: int) -> float:
    """6ND — fwd (2ND) + bwd (4ND)."""
    return 6.0 * n_params_active * n_tokens


def model_flops_decode(n_params_active: int, n_tokens: int) -> float:
    """2ND per generated token (matmul params only; attention extra)."""
    return 2.0 * n_params_active * n_tokens
