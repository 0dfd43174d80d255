"""The step functions of the trainer and the server, counterpart of
``repro/launch/steps.py``.

``make_train_step``: loss -> gradients (``torch.autograd``) -> the AdamW
update, as one function; ``make_serve_step`` / ``make_prefill_step``:
the model's decode and prefill.  Each is a plain function of trees of
tensors (params and state in, new params and state out), as JAX's.

With a ``ShardingCtx`` the train step is JAX's GSPMD step in explicit
SPMD, one process per rank: params and AdamW state are the rank's
blocks of their specs; the batch is the rank's ``dp`` slice.  The step
gathers each dense param over its data axes only (``_gather_dense``:
the ``fsdp`` dim; a dim split over ``model`` stays the rank's block,
and the layers compute on it, ``distributed/tp.py``; the expert weights
stay the rank's blocks whole: the MoE layers move them inside,
``layers/moe.py``), runs the loss under ``use_sharding``, and weights
the rank's objective so that the sum over every rank is the global
loss: the cross-entropy sum over the GLOBAL token count (a masked batch
too), which every ``model`` rank holds once its vocab-parallel terms
are summed (1/ep each), and the (replicated) aux loss shared by every
rank.  The collectives' backward is the gradient of that sum.  So a
gathered leaf's gradient summed over the ranks that hold the same
gathered tensor (every axis but the ``model`` axes that split it) is
the global one and is cut to the rank's block along the gathered dims;
an expert block's comes back from the collectives summed over the
ranks that split it, and is summed over the axes that hold it
replicated.  The clip's norm sums each element's square once (a
block's over its replicas, 1/replicas each), and AdamW updates the
blocks.  ``sharded_value_and_grad`` is the step's gradient alone.
With ``grad_accum > 1`` the batch is the rank's rows of each global
microbatch (``data/pipeline.py::microbatch_shard``, JAX's microbatches
being consecutive rows of the global batch): the layout, not an
all-to-all in the step, gives each rank its share of every microbatch.

With a ``ShardingCtx`` the prefill and serve steps are JAX's prefill
and decode cells in explicit SPMD: the rank's param blocks (the dense
ones gathered over their data axes, as the train step's), its ``dp``
rows and its ``CACHE_RULES`` cache blocks; each returns the rank's
block of the logits under (``dp``, ``vocab``), which the vocab-parallel
head computes.
"""
from __future__ import annotations

import torch

from repro_torch.common.device import scalar
from repro_torch.common.tree import map_with_path, tree_leaves, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed.ctx import (
    PartitionSpec, ShardingCtx, mesh_axes, use_sharding)
from repro_torch.distributed.partition import (
    gather_leaf, local_block, replication)
from repro_torch.distributed.tp import DATA_AXES
from repro_torch.layers.moe import EXPERT_LEAF
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["default_opt_cfg", "value_and_grad", "sharded_value_and_grad",
           "data_spec",
           "make_train_step",
           "make_serve_step", "make_prefill_step", "init_train_state"]


def default_opt_cfg(cfg: ArchConfig) -> AdamWConfig:
    """JAX's recipe: bf16 moments and no master copy for the big archs
    (64+ experts, or d_model x layers past 4096 x 64), else moments in
    the params' dtype and an fp32 master."""
    big = cfg.n_experts >= 64 or cfg.d_model * cfg.n_layers > 4096 * 64
    return AdamWConfig(state_dtype="bfloat16" if big else None,
                       master_dtype=None if big else "float32")


def value_and_grad(loss_fn):
    """``loss_fn(params, batch)`` -> ``fn(params, batch)`` -> (loss,
    grads), the gradient of every leaf of ``params`` as a tree of its
    own, each leaf in its param's dtype.  The params are not written:
    the loss runs on detached views of them."""
    def fn(params, batch):
        views = []

        def view(p):
            views.append(p.detach().requires_grad_())
            return views[-1]

        tree = tree_map(view, params)
        with torch.enable_grad():
            loss = loss_fn(tree, batch)
        grads = iter(torch.autograd.grad(loss, views))
        return loss.detach(), tree_map(lambda _: next(grads), params)

    return fn


def make_train_step(model: Model, opt_cfg: AdamWConfig, *,
                    grad_accum: int = 1, ctx: ShardingCtx = None,
                    specs=None):
    """-> ``train_step(params, opt_state, batch, lr_scale=1.0)`` ->
    (new params, new state, fp32 loss).  ``grad_accum > 1`` splits the
    batch's leading axis into that many microbatches and sums their
    gradients in fp32 (JAX's scan; the peak activation bytes traded for
    passes), then averages them back to each param's dtype.  With
    ``ctx`` the step is the sharded one (see the module docstring):
    ``specs`` is the params' spec tree, the loss is the global one, and
    with ``grad_accum > 1`` the batch is the rank's rows of each global
    microbatch (``data/pipeline.py::microbatch_shard``)."""
    if ctx is not None:
        if specs is None:
            raise ValueError("a sharded step needs the params' specs")
        return _sharded_train_step(model, opt_cfg, ctx, specs, grad_accum)
    vg = value_and_grad(model.loss)

    if grad_accum <= 1:
        def train_step(params, opt_state, batch, lr_scale=1.0):
            loss, grads = vg(params, batch)
            new_params, new_opt = adamw_update(grads, opt_state, params,
                                               opt_cfg, lr_scale)
            return new_params, new_opt, loss.float()

        return train_step

    def train_step(params, opt_state, batch, lr_scale=1.0):
        micro = _microbatches(batch, grad_accum)
        loss_sum, gsum = 0.0, None
        for i in range(grad_accum):
            loss, grads = vg(params, tree_map(lambda x: x[i], micro))
            grads = tree_map(lambda g: g.float(), grads)
            gsum = grads if gsum is None else tree_map(torch.add, gsum,
                                                       grads)
            loss_sum = loss_sum + loss.float()
        n = scalar(grad_accum, loss_sum.device)
        grads = tree_map(lambda g, p: (g / n).to(p.dtype), gsum, params)
        new_params, new_opt = adamw_update(grads, opt_state, params, opt_cfg,
                                           lr_scale)
        return new_params, new_opt, loss_sum / n

    return train_step


def _microbatches(batch, grad_accum: int):
    """Every leaf (B, ...) -> (grad_accum, B / grad_accum, ...)."""
    return tree_map(lambda x: x.reshape(
        (grad_accum, x.shape[0] // grad_accum) + tuple(x.shape[1:])), batch)


def data_spec(spec: PartitionSpec) -> PartitionSpec:
    """``spec`` with only its data axes (``tp.DATA_AXES``): the split
    that ``_gather_dense`` undoes."""
    def keep(d):
        axes = tuple(a for a in spec.axes(d) if a in DATA_AXES)
        if axes and len(axes) != len(spec.axes(d)):
            raise ValueError(f"dim {d} of {spec} mixes data and other "
                             f"axes")
        return axes[0] if len(axes) == 1 else (axes or None)

    return PartitionSpec(*(keep(d) for d in range(len(spec))))


def _gather_dense(params, specs, local, mesh):
    """Each dense param gathered over its data axes (``data_spec``), a
    dim split over ``model`` kept as the rank's block; the expert blocks
    (``local``) kept as they are (the MoE layers move them inside)."""
    with torch.no_grad():
        return tree_map(lambda x, s, keep: x if keep else
                        gather_leaf(x, data_spec(s), mesh), params, specs,
                        local)


def sharded_value_and_grad(model: Model, ctx: ShardingCtx, specs,
                           grad_accum: int = 1):
    """The sharded step's gradient (see the module docstring):
    ``fn(params, batch)`` on the rank's param blocks and ``dp`` slice ->
    (the global loss, the gradient's blocks in the params' dtypes, the
    global gradient norm, fp32).  ``grad_accum > 1``: ``batch`` is the
    rank's rows of each global microbatch (``microbatch_shard``); the
    dense params are gathered once, each microbatch's loss is normalized
    by its own global token count, the partial gradients are summed in
    fp32 and reduced once, then averaged back to each param's dtype (the
    loss is the microbatches' mean), as the single-device step."""
    mesh = ctx.mesh
    sizes = mesh_axes(mesh)
    every = tuple(sizes)
    split = tuple(a for a in every if sizes[a] > 1)   # axes that split
    dp_axes = tuple(a for a in ("pod", "data") if a in sizes)
    ep = sizes.get("model", 1)
    world = collectives.axis_size(every, mesh)
    reps = tree_map(lambda s: replication(s, mesh), specs)
    local = map_with_path(lambda p, _: bool(EXPERT_LEAF.search(p)), specs)

    def objective(params, batch):
        tot, cnt, aux = model.loss_terms(params, batch)
        total = torch.clamp(collectives.psum(cnt.detach(), dp_axes, mesh),
                            min=1.0)
        return tot / (total * ep) + aux / world

    vg = value_and_grad(objective)

    @torch.no_grad()
    def reduce(g, s, keep):
        """A leaf's gradient summed over the ranks that hold the same
        tensor (an expert block: every axis that does not split it; a
        gathered leaf: every axis but its ``model`` split) and cut to
        the rank's block along the gathered dims."""
        held = {a for d in range(len(s)) for a in s.axes(d)}
        if not keep:
            held -= set(DATA_AXES)
        axes = tuple(a for a in split if a not in held)
        if axes:
            g = collectives.psum(g.float(), axes, mesh).to(g.dtype)
        if keep:
            return g
        return local_block(g, data_spec(s), mesh)

    def norm(grads):
        sq = sum(torch.sum(torch.square(g.float())) / r
                 for g, r in zip(tree_leaves(grads), tree_leaves(reps)))
        return torch.sqrt(collectives.psum(sq, every, mesh))

    def fn(params, batch):
        full = _gather_dense(params, specs, local, mesh)
        if grad_accum <= 1:
            with use_sharding(ctx):
                share, grads = vg(full, batch)
            del full
            grads = tree_map(reduce, grads, specs, local)
            return collectives.psum(share, every, mesh), grads, norm(grads)
        micro = _microbatches(batch, grad_accum)
        share, gsum = 0.0, None
        for i in range(grad_accum):
            with use_sharding(ctx):
                s_i, g_i = vg(full, tree_map(lambda x: x[i], micro))
            g_i = tree_map(lambda g: g.float(), g_i)
            gsum = g_i if gsum is None else tree_map(torch.add, gsum, g_i)
            share = share + s_i.float()
            del g_i
        del full
        n = scalar(grad_accum, share.device)
        grads = tree_map(lambda g, s, keep, p: (reduce(g, s, keep) / n).to(
            p.dtype), gsum, specs, local, params)
        return collectives.psum(share, every, mesh) / n, grads, norm(grads)

    return fn


def _sharded_train_step(model: Model, opt_cfg: AdamWConfig,
                        ctx: ShardingCtx, specs, grad_accum: int = 1):
    grad_fn = sharded_value_and_grad(model, ctx, specs, grad_accum)

    def train_step(params, opt_state, batch, lr_scale=1.0):
        loss, grads, gnorm = grad_fn(params, batch)
        new_params, new_opt = adamw_update(grads, opt_state, params,
                                           opt_cfg, lr_scale, gnorm=gnorm)
        return new_params, new_opt, loss.float()

    return train_step


def make_prefill_step(model: Model, *, ctx: ShardingCtx = None, specs=None,
                      cache_specs=None):
    """-> ``prefill_step(params, batch)`` = ``model.prefill``.  With
    ``ctx`` it is JAX's prefill cell in explicit SPMD: ``params`` are the
    rank's ``LM_RULES`` blocks (``specs``), ``batch`` the rank's ``dp``
    rows.  The dense params are gathered over their data axes (the
    expert weights stay blocks), the prefill runs under ``use_sharding``
    with ``cache_specs`` (``CACHE_RULES`` on the global cache tree), and
    it returns the rank's block of the logits under (``dp``, ``vocab``)
    and of each cache leaf: a layer computes its heads' caches under the
    split and cuts only what is still whole (``distributed/tp.py``).
    Enc-dec prefill returns the state alone, the same way."""
    if ctx is None:
        def prefill_step(params, batch):
            return model.prefill(params, batch)

        return prefill_step
    if specs is None or cache_specs is None:
        raise ValueError("a sharded prefill needs specs and cache_specs")
    local = map_with_path(lambda p, _: bool(EXPERT_LEAF.search(p)), specs)

    @torch.no_grad()
    def prefill_step(params, batch):
        full = _gather_dense(params, specs, local, ctx.mesh)
        with use_sharding(ctx):
            out = model.prefill(full, batch, specs=cache_specs)
        del full
        return out

    return prefill_step


def make_serve_step(model: Model, *, ctx: ShardingCtx = None, specs=None,
                    cache_specs=None):
    """-> ``serve_step(params, caches, tokens, pos)`` = one
    ``model.decode`` step.  With ``ctx`` it is JAX's decode cell in
    explicit SPMD: the rank's ``LM_RULES`` param blocks (``specs``; the
    dense params gathered over their data axes), the rank's ``dp`` rows
    of a global batch of
    ``batch`` rows (``pos`` one position or the rank's rows'), and each
    cache the rank's ``CACHE_RULES`` block (``cache_specs``), updated in
    place of the whole: a sequence-split KV cache's softmax is combined
    over the blocks, a head-split state updates the rank's heads
    (``layers/attention.py``, ``layers/mamba2.py``).  Returns the rank's
    block of the logits under (``dp``, ``vocab``) and the caches'
    blocks."""
    if ctx is None:
        def serve_step(params, caches, tokens, pos):
            return model.decode(params, caches, tokens, pos)

        return serve_step
    if specs is None or cache_specs is None:
        raise ValueError("a sharded decode needs specs and cache_specs")
    local = map_with_path(lambda p, _: bool(EXPERT_LEAF.search(p)), specs)

    @torch.no_grad()
    def serve_step(params, caches, tokens, pos):
        full = _gather_dense(params, specs, local, ctx.mesh)
        with use_sharding(ctx):
            logits, caches = model.decode(full, caches, tokens, pos,
                                          specs=cache_specs)
        del full
        return logits, caches

    return serve_step


def init_train_state(model: Model, opt_cfg: AdamWConfig, key, device=None):
    """Random params from ``key`` (a seed or a ``torch.Generator``) on
    ``device`` (default: the CUDA card) and their fresh AdamW state."""
    params = model.init(key, device)
    return params, adamw_init(params, opt_cfg)
