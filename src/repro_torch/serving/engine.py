"""Batched LM serving engine with continuous batching, counterpart of
``repro/serving/engine.py``.

A fixed array of slots (the decode batch) over a registry ``Model``:
each request is admitted into a free slot, prefilled (its batch-1 cache
written into the slot), and all slots decode together each step, each
at its own position: the port's decode takes a (slots,) position
tensor, where JAX ``vmap``s a scalar position over the slots.  A
finished sequence (EOS or budget) frees its slot at once.

Which axis of each cache leaf is the batch axis is found by
construction: ``init_caches`` at batch 2 and 3 on the ``meta`` device
(nothing allocated), and the axis whose size differs.
``ServeConfig.max_len`` sizes the KV caches (softmax: ``max_len``
positions, sliding: a ring of ``min(max_len, window)``), and ``admit``
refuses a request whose prompt plus ``max_tokens`` exceeds it.  A
prefill's KV leaves are zero-padded to the engine's lengths
(``_pad_seq_dims``, as JAX's) before they are written into the slot, so
no key of the slot's previous request survives past the prompt.

On the card the prefill of a Mamba-2 layer launches ``ssd_chunked`` and
a relu_linear attention layer ``relu_attn_causal``; softmax and sliding
attention are plain torch ops; decode launches no kernel of the port.
An MoE layer's decode routes each slot's token as a group of its own
(the capacity of one token), as JAX's ``vmap`` over batch-1 slots does:
no slot's token is dropped for what the other slots hold.
Decode does not write its input caches: each step makes new ones (a
copy of every KV leaf per step).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device, tree_to
from repro_torch.configs.base import ArchConfig
from repro_torch.common.tree import tree_map
from repro_torch.models.registry import Model, build_model
from repro_torch.serving.sampler import SamplerConfig, sample
from repro_torch.serving.telemetry import Telemetry

__all__ = ["ServeConfig", "Request", "ServingEngine"]

GREEDY = SamplerConfig()      # a prompt's first token is its argmax


@dataclasses.dataclass
class ServeConfig:
    max_slots: int = 8
    max_len: int = 512            # KV positions, prompt + max_tokens
    eos_token: int = -1           # -1: never; else stop token
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int
    max_tokens: int = 32
    out_tokens: Optional[list] = None


def _batch_axes(model: Model, max_len: int):
    """Tree of ints: which axis of each cache leaf is the batch axis."""
    s2 = model.init_caches(2, max_len, device="meta")
    s3 = model.init_caches(3, max_len, device="meta")

    def diff(a, b):
        for i, (x, y) in enumerate(zip(a.shape, b.shape)):
            if x != y:
                return i
        raise ValueError(f"no batch axis in cache leaf {tuple(a.shape)}")

    return tree_map(diff, s2, s3)


class ServingEngine:
    """``device`` defaults to the CUDA card (``params`` are moved there);
    without a card, and without ``device="cpu"``, the constructor
    raises, as it does for an enc-dec arch."""

    def __init__(self, arch: ArchConfig, params, cfg: ServeConfig, *,
                 telemetry: Telemetry | None = None, device=None):
        if arch.family == "encdec":
            raise ValueError(
                f"{arch.name}: the ServingEngine serves decoder-only LMs; "
                f"an enc-dec prefill returns its serve state, not (logits, "
                f"caches) (JAX's engine fails inside admit): prefill and "
                f"decode it through models.registry.build_model")
        self.arch = arch
        self.cfg = cfg
        self.device = resolve_device(device)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.model: Model = build_model(arch)
        self.params = tree_to(params, self.device)
        B = cfg.max_slots
        self.caches = self.model.init_caches(B, cfg.max_len, self.device)
        self.axes = _batch_axes(self.model, cfg.max_len)
        self.slot_req: list = [None] * B
        self.slot_pos = np.zeros(B, np.int64)      # position of next token
        self.slot_budget = np.zeros(B, np.int64)
        self.last_token = np.zeros(B, np.int64)
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed)
        self.finished: list = []

    # -- admission -----------------------------------------------------
    def _free_slots(self):
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admit(self, req: Request) -> bool:
        if len(req.prompt) + req.max_tokens > self.cfg.max_len:
            raise ValueError(
                f"request {req.rid}: a prompt of {len(req.prompt)} tokens "
                f"and max_tokens {req.max_tokens} exceed max_len "
                f"{self.cfg.max_len}")
        free = self._free_slots()
        if not free:
            return False
        slot = free[0]
        toks = torch.as_tensor(np.asarray(req.prompt, np.int64),
                               device=self.device)[None, :]
        with torch.no_grad():
            logits, cache1 = self.model.prefill(self.params,
                                                {"tokens": toks})
            cache1 = _pad_seq_dims(cache1, self.caches, self.axes)
            tree_map(lambda big, one, ax: _write_slot(big, one, ax, slot),
                      self.caches, cache1, self.axes)
        first = int(sample(logits, self.generator, GREEDY)[0])
        req.out_tokens = [first]
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
        self.slot_budget[slot] = req.max_tokens - 1
        self.last_token[slot] = first
        self.telemetry.count("admitted")
        return True

    # -- decode ---------------------------------------------------------
    def active(self) -> int:
        return sum(r is not None for r in self.slot_req)

    def step(self):
        """One synchronous decode step over every slot (inactive slots
        compute garbage into their soon-to-be-overwritten caches)."""
        if self.active() == 0:
            return None
        self.telemetry.count("decode_steps")
        self.telemetry.observe("slot_occupancy",
                               self.active() / self.cfg.max_slots)
        tokens = torch.as_tensor(self.last_token,
                                 device=self.device)[:, None]     # (B, 1)
        pos = torch.as_tensor(self.slot_pos, device=self.device)  # (B,)
        with torch.no_grad():
            logits, self.caches = self.model.decode(
                self.params, self.caches, tokens, pos)
            nxt = sample(logits, self.generator,
                         self.cfg.sampler).cpu().numpy()
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            self.slot_pos[i] += 1
            self.slot_budget[i] -= 1
            self.last_token[i] = tok
            if tok == self.cfg.eos_token or self.slot_budget[i] <= 0:
                self.finished.append(req)
                self.slot_req[i] = None
                self.telemetry.count("finished")
        return nxt

    def run(self, requests: list, *, max_steps: int = 10_000) -> list:
        """Serve a request list to completion; returns finished Requests."""
        pending = list(requests)
        steps = 0
        while (pending or self.active()) and steps < max_steps:
            while pending and self._free_slots():
                self.admit(pending.pop(0))
            self.step()
            steps += 1
        return self.finished


# -- cache slot surgery ------------------------------------------------

def _write_slot(big, one, ax: int, slot: int):
    """Write a batch-1 cache leaf into batch slot ``slot`` along ``ax``,
    in place, cast to the engine cache's dtype."""
    big.narrow(ax, slot, 1).copy_(one.to(big.dtype))
    return big


def _pad_seq_dims(one, template, axes):
    """Zero-pad a prefill cache's sequence axes (every axis but the batch
    axis whose size differs from the engine cache's) up to the engine's;
    a leaf longer than the engine's raises."""
    def pad(a, t, ax: int):
        shape = list(a.shape)
        for i, (sa, st) in enumerate(zip(a.shape, t.shape)):
            if i == ax or sa == st:
                continue
            if sa > st:
                raise ValueError(f"cache leaf exceeds max_len: "
                                 f"{tuple(a.shape)} vs {tuple(t.shape)}")
            shape[i] = st
        if shape == list(a.shape):
            return a
        out = a.new_zeros(shape)
        region = out
        for i, n in enumerate(a.shape):
            region = region.narrow(i, 0, n)
        region.copy_(a)
        return out

    return tree_map(pad, one, template, axes)
