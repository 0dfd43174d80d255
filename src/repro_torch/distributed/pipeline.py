"""Pipeline parallelism over the pod axis (GPipe), counterpart of
``repro/distributed/pipeline.py``, in explicit SPMD.

The default multi-pod layout runs pure DP across pods: every pod holds
all layers and the gradient reduction crosses the (slow) inter-pod
links.  Pipeline parallelism is the alternative when params-per-pod is
the constraint: each pod holds 1/P of the layers, and only activations
(mb x S x D per microbatch) cross pods.

Mechanics (P stages on ``pipe_axis``, M microbatches), as JAX's:

  * each rank holds its stage's slice of the stacked block params
    (``split_stages``, then the rank's block over ``pipe_axis``);
  * M + P - 1 ticks: at each, every stage applies its layers to its
    in-flight activation and ``ppermute``s the result to the next stage
    (bubble fraction (P - 1) / (M + P - 1)); stage 0 takes microbatch t
    at tick t, the last stage keeps its outputs of ticks >= P - 1;
  * the last stage's outputs are broadcast to the other stages;
  * autograd through ``ppermute`` (its backward is the reverse
    permutation) is the backward pipeline.

Data parallelism inside a stage: ``x_micro`` is the rank's slice of the
microbatches (split over ``data`` by the caller) and the caller sums the
stage gradients over ``data``.  The output is replicated over
``pipe_axis`` and so is its gradient (every stage's loss the same
function of it): only the last stage's own gradient enters the
backward pipeline, once.  The input's gradient reaches stage 0 only.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_map
from repro_torch.distributed import collectives

__all__ = ["pipelined_apply", "split_stages"]


class _FromLast(torch.autograd.Function):
    """Broadcast from the group's last rank.  Its gradient is none: the
    last stage's own loss reaches its outputs directly (see
    ``pipelined_apply``)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.broadcast(y, src=dist.get_global_rank(
            group, dist.get_world_size(group) - 1), group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return torch.zeros_like(g), None


def pipelined_apply(stage_fn: Callable, stage_params, x_micro, *, mesh,
                    pipe_axis: str = "pod"):
    """Run ``stage_fn`` as a P-stage pipeline over ``pipe_axis``.

    stage_fn(local_params, h) -> h'   (one stage's layers)
    stage_params: this rank's stage, every leaf with a leading dim of 1
    x_micro: (M, mb, S, D) microbatches (the rank's slice of mb)
    -> (M, mb, S, D), the last stage's outputs, on every stage.

    Every stage runs the same graph, JAX's ``where``s included (a stage
    selects with a mask, not a branch), so every ``ppermute`` has its
    backward on every rank, in the same order."""
    n = collectives.axis_size(pipe_axis, mesh)
    sid = collectives.axis_index(pipe_axis, mesh)
    M = x_micro.shape[0]
    params = tree_map(lambda a: a[0], stage_params)
    first = torch.tensor(sid == 0, device=x_micro.device)
    last = torch.tensor(sid == n - 1, device=x_micro.device)
    fwd_perm = [(i, i + 1) for i in range(n - 1)]
    h = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(M + n - 1):
        h_out = stage_fn(params, torch.where(first, x_micro[min(t, M - 1)],
                                             h))
        if t >= n - 1:
            outs.append(h_out)
        if n > 1:
            h = collectives.ppermute(h_out, pipe_axis, fwd_perm, mesh=mesh)
    outs = torch.stack(outs)
    if n == 1:
        return outs
    return torch.where(last, outs,
                       _FromLast.apply(outs, mesh.get_group(pipe_axis)))


def split_stages(stacked_params, n_stages: int):
    """(L, ...) stacked block params -> (n_stages, L / P, ...)."""
    def resh(a):
        L = a.shape[0]
        if L % n_stages:
            raise ValueError(f"{L} layers do not split into {n_stages} "
                             f"stages")
        return a.reshape((n_stages, L // n_stages) + tuple(a.shape[1:]))

    return tree_map(resh, stacked_params)
