"""Synthetic LM data with deterministic host sharding, counterpart of
``repro/data/pipeline.py``.

Sequences are drawn from a fixed random first-order Markov chain
(temperature-sharpened, so it has low entropy): a model that trains on
it shows a real, decreasing loss.  As in JAX:
  * the GLOBAL batch of step ``t`` is a pure function of (seed, t), so
    any host can compute any shard and no coordinator is needed;
  * ``host_shard`` slices the global batch for (host_id, n_hosts);
  * ``make_batch_specs`` gives each leaf's ``NamedSharding`` under a
    sharding context (``dp`` on the batch dim), whose ``shard`` is the
    rank's slice: every rank draws the same global batch and keeps its
    own rows; ``microbatch_shard`` is the rank's rows of each global
    microbatch (the sharded step with ``grad_accum > 1``).

The bits are torch's, not ``jax.random``'s (the port cannot reproduce
those without JAX): the (V, V) fp32 transition logits come from a
``torch.Generator`` seeded with ``seed``, a step's batch from one seeded
with (seed, step), both on the dataset's device (the logits are 4.1 GB
at V = 32000).  A CUDA generator and a CPU one draw different tokens
from the same seed.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.distributed.ctx import NamedSharding
from repro_torch.distributed.partition import local_block

__all__ = ["DataConfig", "SyntheticLMDataset", "host_shard",
           "make_batch_specs", "microbatch_shard"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    sharpness: float = 3.0     # Markov transition temperature (higher = easier)


def _step_seed(seed: int, step: int) -> int:
    """A generator seed for (seed, step), distinct for every pair with
    0 <= step < 2^32."""
    return ((seed + 1) << 32) + step


class SyntheticLMDataset:
    """Deterministic Markov-chain LM data, shardable by (step, host), on
    ``device`` (default: the CUDA card)."""

    def __init__(self, cfg: DataConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        g = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self._trans_logits = torch.randn(
            (cfg.vocab, cfg.vocab), generator=g, device=self.device
        ) * cfg.sharpness

    def global_batch(self, step: int) -> dict:
        """The full (global_batch, seq_len) batch of one step:
        {"tokens", "targets"} int64, the targets the tokens shifted by
        one.  Each next token is a Gumbel-max draw from its row of the
        transition logits."""
        cfg = self.cfg
        g = torch.Generator(device=self.device).manual_seed(
            _step_seed(cfg.seed, step))
        B = cfg.global_batch
        tok = torch.randint(0, cfg.vocab, (B,), generator=g,
                            device=self.device)
        seq = torch.empty((B, cfg.seq_len + 1), dtype=torch.int64,
                          device=self.device)
        seq[:, 0] = tok
        noise = torch.empty((B, cfg.vocab), device=self.device)
        for t in range(cfg.seq_len):
            noise.exponential_(generator=g)
            tok = torch.argmax(self._trans_logits[tok] - noise.log(), dim=-1)
            seq[:, t + 1] = tok
        return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}

    def host_batch(self, step: int, host_id: int, n_hosts: int) -> dict:
        return host_shard(self.global_batch(step), host_id, n_hosts)

    def optimal_loss_estimate(self) -> float:
        """The mean entropy of the chain's rows: the loss floor a perfect
        model converges to."""
        probs = torch.softmax(self._trans_logits, dim=-1)
        ent = -torch.sum(probs * torch.log(torch.clamp(probs, min=1e-30)),
                         dim=-1)
        return float(ent.mean())


def host_shard(batch: dict, host_id: int, n_hosts: int) -> dict:
    """Every leaf's leading (batch) dim sliced for one host."""
    def slc(x):
        b = x.shape[0]
        if b % n_hosts:
            raise ValueError(f"batch {b} does not split over {n_hosts} "
                             f"hosts")
        per = b // n_hosts
        return x[host_id * per:(host_id + 1) * per]

    return tree_map(slc, batch)


def make_batch_specs(batch: dict, ctx, *logical) -> dict:
    """Each leaf's ``NamedSharding`` under ``ctx``: ``logical`` names its
    leading dims (``"dp"``: the batch), the rest unsplit."""
    def spec(x):
        axes = list(logical) + [None] * (x.ndim - len(logical))
        return NamedSharding(ctx.mesh, ctx.resolve(axes[: x.ndim]))

    return tree_map(spec, batch)


def microbatch_shard(batch: dict, ctx, grad_accum: int) -> dict:
    """The rank's rows of each of ``grad_accum`` global microbatches, in
    microbatch order: global microbatch i is rows [i B / ga, (i + 1) B /
    ga) of the batch (JAX's reshape of the global batch), and the rank
    keeps its ``dp`` share of each -> (B / dp, ...) leaves, which the
    sharded step splits back into ``grad_accum`` microbatches.  With
    ``grad_accum=1`` it is ``make_batch_specs``'s ``shard``."""
    def cut(x):
        mb = x.reshape((grad_accum, x.shape[0] // grad_accum)
                       + tuple(x.shape[1:]))
        spec = ctx.resolve([None, "dp"] + [None] * (x.ndim - 1))
        return local_block(mb, spec, ctx.mesh).reshape(
            (-1,) + tuple(x.shape[1:]))

    return tree_map(cut, batch)
