"""The step functions of the trainer and the server, counterpart of
``repro/launch/steps.py``.

``make_train_step``: loss -> gradients (``torch.autograd``) -> the AdamW
update, as one function; ``make_serve_step`` / ``make_prefill_step``:
the model's decode and prefill.  Each is a plain function of trees of
tensors (params and state in, new params and state out), as JAX's.

With a ``ShardingCtx`` the train step is JAX's GSPMD step in explicit
SPMD, one process per rank: params and AdamW state are the rank's
blocks of their specs; the batch is the rank's ``dp`` slice.  The step
gathers the dense params (the expert weights stay the rank's blocks:
the MoE layers move them inside, ``layers/moe.py``), runs the loss
under ``use_sharding``, and weights the rank's objective so that the
sum over every rank is the global loss: the cross-entropy sum over the
GLOBAL token count (a masked batch too), shared by the ``model`` ranks
that computed it (1/ep each), and the (replicated) aux loss shared by
every rank.  The collectives' backward is the gradient of that sum.  So
a gathered leaf's gradient summed over the mesh is the global one (for
the dense layers: summed over ``dp``, one ``model`` rank's) and is cut
to the rank's block; an expert block's comes back from the collectives
summed over the ranks that split it, and is summed over the axes that
hold it replicated.  The clip's norm sums each element's square once (a
block's over its replicas, 1/replicas each), and AdamW updates the
blocks.  ``sharded_value_and_grad`` is the step's gradient alone.
With ``grad_accum > 1`` the batch is the rank's rows of each global
microbatch (``data/pipeline.py::microbatch_shard``, JAX's microbatches
being consecutive rows of the global batch): the layout, not an
all-to-all in the step, gives each rank its share of every microbatch.

With a ``ShardingCtx`` the prefill and serve steps are JAX's prefill
and decode cells in explicit SPMD: the rank's param blocks (the dense
ones gathered), its ``dp`` rows and its ``CACHE_RULES`` cache blocks;
each returns the rank's block of the logits under (``dp``, ``vocab``).
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
    gather_leaf, local_block, replication, resolve_param_spec)
from repro_torch.layers.moe import EXPERT_LEAF
from repro_torch.models.registry import Model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

__all__ = ["default_opt_cfg", "value_and_grad", "sharded_value_and_grad",
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


def _gather_dense(params, specs, local, mesh):
    """The params whole, the expert blocks (``local``) kept as they are
    (the MoE layers move them inside)."""
    with torch.no_grad():
        return tree_map(lambda x, s, keep: x if keep else
                        gather_leaf(x, s, mesh), params, specs, local)


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
        if keep:    # a block already: summed over the ranks holding it
            axes = tuple(a for a in split
                         if all(a not in s.axes(d) for d in range(len(s))))
            return (collectives.psum(g.float(), axes, mesh).to(g.dtype)
                    if axes else g)
        if not split:
            return g
        return local_block(collectives.psum(g.float(), split, mesh), s,
                           mesh).to(g.dtype)

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


def _rows_local(spec, dp_axes) -> PartitionSpec:
    """``spec`` with the data-parallel axes taken out: a tensor computed
    on the rank's rows is already cut along them."""
    return PartitionSpec(*(None if set(spec.axes(d)) & set(dp_axes)
                           else spec[d] for d in range(len(spec))))


def _blocks(tree, specs, ctx: ShardingCtx):
    """Each leaf of ``tree`` (computed on the rank's rows) cut to the
    rank's block under its spec (a copy where it is cut, so the whole
    leaf can be freed)."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh_axes(ctx.mesh))

    def cut(x, s):
        b = local_block(x, _rows_local(s, dp_axes), ctx.mesh)
        return b if b.numel() == x.numel() else b.clone()

    return tree_map(cut, tree, specs)


def _logits_block(logits, ctx: ShardingCtx):
    """The rank's block of its rows' logits under JAX's out sharding,
    (``dp``, ``vocab``): the vocab dim cut where ``vocab``'s axes divide
    it."""
    return _blocks(logits, resolve_param_spec(ctx, ("dp", "vocab"),
                                              tuple(logits.shape)), ctx)


def make_prefill_step(model: Model, *, ctx: ShardingCtx = None, specs=None,
                      cache_specs=None):
    """-> ``prefill_step(params, batch)`` = ``model.prefill``.  With
    ``ctx`` it is JAX's prefill cell in explicit SPMD: ``params`` are the
    rank's ``LM_RULES`` blocks (``specs``), ``batch`` the rank's ``dp``
    rows.  The dense params are gathered (the expert weights stay
    blocks), the prefill runs under
    ``use_sharding``, and it returns the rank's block of the logits
    under (``dp``, ``vocab``) and each cache leaf cut to the rank's block
    under ``cache_specs`` (``CACHE_RULES`` on the global cache tree; the
    whole caches of the rank's rows are computed first: the dense layers
    are replicated over ``model``, ROADMAP C).  Enc-dec prefill returns
    the state alone, cut the same way."""
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
            out = model.prefill(full, batch)
        del full
        if model.cfg.family == "encdec":
            return _blocks(out, cache_specs, ctx)
        logits, caches = out
        return _logits_block(logits, ctx), _blocks(caches, cache_specs, ctx)

    return prefill_step


def make_serve_step(model: Model, *, ctx: ShardingCtx = None, specs=None,
                    cache_specs=None):
    """-> ``serve_step(params, caches, tokens, pos)`` = one
    ``model.decode`` step.  With ``ctx`` it is JAX's decode cell in
    explicit SPMD: the rank's ``LM_RULES`` param blocks (``specs``; the
    dense params gathered), the rank's ``dp`` rows of a global batch of
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
        return _logits_block(logits, ctx), caches

    return serve_step


def init_train_state(model: Model, opt_cfg: AdamWConfig, key, device=None):
    """Random params from ``key`` (a seed or a ``torch.Generator``) on
    ``device`` (default: the CUDA card) and their fresh AdamW state."""
    params = model.init(key, device)
    return params, adamw_init(params, opt_cfg)
