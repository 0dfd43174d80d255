"""Config registry: ``get_arch(name)`` resolves the ten LM archs,
counterpart of ``repro/configs/__init__.py``."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, SHAPES, ShapeSpec, smoke_variant, supports  # noqa: F401
from repro_torch.configs.gemma3_12b import CONFIG as gemma3_12b
from repro_torch.configs.granite_3_2b import CONFIG as granite_3_2b
from repro_torch.configs.grok_1_314b import CONFIG as grok_1_314b
from repro_torch.configs.internvl2_1b import CONFIG as internvl2_1b
from repro_torch.configs.kimi_k2_1t import CONFIG as kimi_k2_1t
from repro_torch.configs.mamba2_1_3b import CONFIG as mamba2_1_3b
from repro_torch.configs.qwen2_5_32b import CONFIG as qwen2_5_32b
from repro_torch.configs.seamless_m4t_large import CONFIG as seamless_m4t_large
from repro_torch.configs.stablelm_12b import CONFIG as stablelm_12b
from repro_torch.configs.zamba2_1_2b import CONFIG as zamba2_1_2b

ARCHS: dict[str, ArchConfig] = {c.name: c for c in [
    stablelm_12b, granite_3_2b, qwen2_5_32b, gemma3_12b, zamba2_1_2b,
    grok_1_314b, kimi_k2_1t, mamba2_1_3b, internvl2_1b, seamless_m4t_large,
]}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
