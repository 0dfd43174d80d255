"""Model registry, counterpart of ``repro/models/registry.py``: one
interface over the LM families the port has (``models/lm.py``).

``Model.init(generator or seed, device=None)`` draws random params (a
seed makes a generator on ``device``); ``prefill(params, {"tokens": (B,
S)[, "patches": (B, P, D)]})`` -> (last-token logits (B, V), caches),
the KV caches in ``cfg.kv_dtype``; ``decode(params, caches, tokens (B,
1), pos)`` -> (logits (B, V), caches), ``pos`` one int or a (B,) tensor;
``init_caches(batch, max_len, device=None)``: zero caches whose KV
leaves hold ``max_len`` positions (sliding: ``min(max_len, window)``)
in ``cfg.kv_dtype``.  Entry points run on the CUDA card unless
``device="cpu"`` is asked for.

``build_model(cfg, reference=True)`` gives the reference forward: its
prefill runs the two scans' plain versions on any device (softmax and
sliding attention are plain torch either way).  ``loss`` (training) and
``input_specs`` (the dry-run's) are not ported yet (ROADMAP A8f, A8h).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as _lm

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable           # (generator or seed, device=None) -> params
    prefill: Callable        # (params, batch) -> (logits, caches)
    decode: Callable         # (params, caches, tokens, pos) -> (logits,
                             #   caches)
    init_caches: Callable    # (batch, max_len, device=None) -> caches


def _init(cfg: ArchConfig, generator, device=None):
    dev = resolve_device(device)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    return _lm.init_lm(generator, cfg, dev)


def _caches(cfg: ArchConfig, batch: int, max_len: int, device=None):
    dev = (torch.device("meta") if str(device) == "meta"
           else resolve_device(device))
    return _lm.init_lm_caches(cfg, batch, max_len, _kv_dtype(cfg),
                              device=dev)


def _kv_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_dtype)


def build_model(cfg: ArchConfig, *, reference: bool = False) -> Model:
    _lm.check_supported(cfg)
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: _init(cfg, generator, device),
        prefill=lambda p, b: _lm.lm_prefill(
            p, b["tokens"], cfg, patches=b.get("patches"),
            cache_dtype=_kv_dtype(cfg), reference=reference),
        decode=lambda p, c, t, pos: _lm.lm_decode_step(p, c, t, pos, cfg),
        init_caches=lambda batch, max_len, device=None: _caches(
            cfg, batch, max_len, device),
    )
