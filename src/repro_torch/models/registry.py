"""Model registry, counterpart of ``repro/models/registry.py``: one
interface over every LM family (``models/lm.py``) and the
encoder-decoder (``models/encdec.py``).

``Model.init(generator or seed, device=None)`` draws random params (a
seed makes a generator on ``device``; on ``device="meta"`` every leaf
is made with its shape and dtype and nothing is drawn); ``prefill(params, {"tokens": (B,
S)[, "patches": (B, P, D)]})`` -> (last-token logits (B, V), caches),
the KV caches in ``cfg.kv_dtype``; ``decode(params, caches, tokens (B,
1), pos, specs=None)`` -> (logits (B, V), caches), ``pos`` one int or a
(B,) tensor, ``specs`` the caches' spec tree when they are the rank's
blocks (the sharded serve step);
``init_caches(batch, max_len, device=None)``: zero caches whose KV
leaves hold ``max_len`` positions (sliding: ``min(max_len, window)``)
in ``cfg.kv_dtype``.  Entry points run on the CUDA card unless
``device="cpu"`` is asked for.

Enc-dec, as JAX's: ``prefill(params, {"frames": (B, S_enc, D),
"tokens": (B, S)})`` runs the encoder and returns the serve STATE only
(``init_encdec_state``: cross K/V, zero self caches of ``S`` positions,
bf16); ``decode(params, state, tokens, pos)`` -> (logits (B, V),
state); ``init_caches(batch, max_len)`` the zero state, its cross K/V
``ENC_MEMORY_LEN`` positions long, bf16.

``loss(params, batch)`` -> the scalar fp32 training loss (JAX's
``lm_loss`` / ``encdec_loss``: batch ``{"tokens", "targets"[, "mask"]}``,
vlm with ``"patches"``, enc-dec with ``"frames"``), differentiable with
``torch.autograd``; ``loss_terms(params, batch)`` -> its terms (the
cross-entropy sum, the token weight sum, the aux loss), which a sharded
step normalizes over the global batch.

``build_model(cfg, reference=True)`` gives the reference forward: its
prefill and loss run the two scans' plain versions on any device
(softmax and sliding attention are plain torch either way).
``input_specs(cfg, shape)`` (and ``train_input_specs``,
``prefill_input_specs``, ``decode_input_specs``) gives the dry-run's
inputs as meta tensors with the shapes and dtypes of JAX's
``ShapeDtypeStruct``s: int32 tokens and targets; enc-dec ``frames`` and
vlm ``patches`` in bf16 (vlm: ``S - P`` text tokens); decode one token
a row, a 0-dim int32 ``pos`` and zero caches of ``seq_len`` positions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch.overrides import TorchFunctionMode

from repro_torch.common.device import resolve_device
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.models import encdec as _ed
from repro_torch.models import lm as _lm

__all__ = ["Model", "build_model", "ENC_MEMORY_LEN", "input_specs",
           "train_input_specs", "prefill_input_specs",
           "decode_input_specs"]

# encoder memory length of the enc-dec serve state's cross K/V (JAX's:
# precomputed frontend frames, ~100 s of audio at a 40 ms hop)
ENC_MEMORY_LEN = 4096


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable           # (generator or seed, device=None) -> params
    loss: Callable           # (params, batch) -> scalar fp32
    loss_terms: Callable     # (params, batch) -> (CE sum, weight sum, aux)
    prefill: Callable        # (params, batch, specs=None)
                             #   -> (logits, caches)
    decode: Callable         # (params, caches, tokens, pos, specs=None)
                             #   -> (logits, caches)
    init_caches: Callable    # (batch, max_len, device=None) -> caches


class _DrawNothing(TorchFunctionMode):
    """Every call given a ``generator`` makes its tensor on meta instead
    (its shape and dtype, no values): the init functions draw on the
    generator's device, and there is no meta generator."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if kwargs.pop("generator", None) is not None:
            kwargs["device"] = torch.device("meta")
        return func(*args, **kwargs)


def _init(cfg: ArchConfig, generator, device=None):
    dev = resolve_device(device)
    if dev.type == "meta":
        init = _ed.init_encdec if cfg.family == "encdec" else _lm.init_lm
        with _DrawNothing():
            return init(torch.Generator(), cfg, dev)
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator(device=dev).manual_seed(int(generator))
    if cfg.family == "encdec":
        return _ed.init_encdec(generator, cfg, dev)
    return _lm.init_lm(generator, cfg, dev)


def _cache_device(device):
    return (torch.device("meta") if str(device) == "meta"
            else resolve_device(device))


def _caches(cfg: ArchConfig, batch: int, max_len: int, device=None):
    return _lm.init_lm_caches(cfg, batch, max_len, _kv_dtype(cfg),
                              device=_cache_device(device))


def _encdec_cache_zeros(cfg: ArchConfig, batch: int, max_len: int,
                        device=None):
    """The zero enc-dec serve state: cross K/V of ``ENC_MEMORY_LEN``
    positions and self caches of ``max_len``, bf16."""
    acfg = _lm.attn_cfg(cfg, "softmax")
    dev = _cache_device(device)
    L = cfg.dec_layers
    kvshape = (L, batch, ENC_MEMORY_LEN, acfg.n_kv, acfg.head_dim)
    self_kv = (L, batch, max_len, acfg.n_kv, acfg.head_dim)

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.bfloat16, device=dev)

    return {"cross": {"ck": zeros(kvshape), "cv": zeros(kvshape)},
            "self": {"k": zeros(self_kv), "v": zeros(self_kv)}}


def _kv_dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.kv_dtype)


def build_model(cfg: ArchConfig, *, reference: bool = False) -> Model:
    _lm.check_supported(cfg, _lm.FAMILIES + ("encdec",))
    if cfg.family == "encdec":
        return Model(
            cfg=cfg,
            init=lambda generator, device=None: _init(cfg, generator,
                                                      device),
            loss=lambda p, b: _ed.encdec_loss(p, b, cfg),
            loss_terms=lambda p, b: _ed.encdec_loss_terms(p, b, cfg),
            prefill=lambda p, b, specs=None: _ed.init_encdec_state(
                p, b["frames"], cfg, b["tokens"].shape[1], specs=specs),
            decode=lambda p, st, t, pos, specs=None: _ed.encdec_decode_step(
                p, st, t, pos, cfg, specs),
            init_caches=lambda batch, max_len, device=None:
                _encdec_cache_zeros(cfg, batch, max_len, device),
        )
    return Model(
        cfg=cfg,
        init=lambda generator, device=None: _init(cfg, generator, device),
        loss=lambda p, b: _lm.lm_loss(p, b, cfg, reference=reference),
        loss_terms=lambda p, b: _lm.lm_loss_terms(p, b, cfg,
                                                  reference=reference),
        prefill=lambda p, b, specs=None: _lm.lm_prefill(
            p, b["tokens"], cfg, patches=b.get("patches"),
            cache_dtype=_kv_dtype(cfg), reference=reference, specs=specs),
        decode=lambda p, c, t, pos, specs=None: _lm.lm_decode_step(
            p, c, t, pos, cfg, specs),
        init_caches=lambda batch, max_len, device=None: _caches(
            cfg, batch, max_len, device),
    )


# ---------------------------------------------------------------------------
# input specs: meta stand-ins for the dry-run (JAX's ShapeDtypeStructs)
# ---------------------------------------------------------------------------

def _spec(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        return {"frames": _spec((B, S, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S), i32), "targets": _spec((B, S), i32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        return {"patches": _spec((B, P, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S - P), i32),
                "targets": _spec((B, S - P), i32)}
    return {"tokens": _spec((B, S), i32), "targets": _spec((B, S), i32)}


def prefill_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if cfg.family == "encdec":
        return {"frames": _spec((B, S, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S), i32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        return {"patches": _spec((B, P, cfg.d_model), torch.bfloat16),
                "tokens": _spec((B, S - P), i32)}
    return {"tokens": _spec((B, S), i32)}


def decode_input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """One decode step against caches ``seq_len`` positions deep (one new
    token a row)."""
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": _spec((B, 1), torch.int32),
            "pos": _spec((), torch.int32),
            "caches": build_model(cfg).init_caches(B, S, "meta")}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    return {"train": train_input_specs,
            "prefill": prefill_input_specs,
            "decode": decode_input_specs}[shape.kind](cfg, shape)
