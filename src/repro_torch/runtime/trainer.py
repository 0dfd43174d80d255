"""The fault-tolerant training loop, counterpart of
``repro/runtime/trainer.py``.

One class ties the pieces together: the step function of
``launch/steps.py`` with the LR schedule's multiplier; async checkpoints
with auto-resume from the newest complete one; a failure (injected by
``failure_hook`` in tests and in ``chip_smoke.py``) restores from the
last checkpoint, up to ``max_restarts`` times; the straggler monitor
takes each step's time.  All fault handling happens at step
granularity.

With a process group (``torch.distributed``) the trainer runs on a mesh,
as JAX's: ``mesh=`` (default: ``(world, 1)`` over ``("data",
"model")``) is installed with ``make_ctx``, params and AdamW state are
sharded by ``LM_RULES`` (each rank holds its blocks), every rank draws
the same global batch and keeps its ``dp`` slice, and the step is
``make_train_step(ctx=)``'s.  Checkpoints go through the checkpoint
module's sharded API: ``save_async(shardings=)`` gathers the state and
the mesh's first rank writes it; a resume restores each rank's blocks
(``restore(shardings=)``).  Without a process group it is the
single-device trainer.  The elastic re-mesh is ``runtime/elastic.py``.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable, Optional

import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import (
    CheckpointManager, latest_step, restore)
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import param_count, tree_map
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import (
    DataConfig, SyntheticLMDataset, make_batch_specs)
from repro_torch.distributed.ctx import P
from repro_torch.distributed.partition import (
    make_ctx, match_partition_rules, named_shardings, shard_tree)
from repro_torch.distributed.rules import LM_RULES
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import default_opt_cfg, make_train_step
from repro_torch.models.registry import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.optim.schedule import ScheduleConfig, lr_scale
from repro_torch.runtime.straggler import StragglerMonitor

__all__ = ["TrainerConfig", "Trainer", "make_failure_hook"]

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ckpt_keep: int = 3
    log_every: int = 10
    seed: int = 0
    max_restarts: int = 3
    schedule: ScheduleConfig = dataclasses.field(
        default_factory=lambda: ScheduleConfig(warmup_steps=10,
                                               total_steps=100))


class Trainer:
    """Trains ``arch`` on ``SyntheticLMDataset(data_cfg)`` on ``device``
    (default: the CUDA card, ``cuda:$LOCAL_RANK`` in a process group).
    ``run()`` -> {"params", "opt", "final_loss", "losses"} (on a mesh
    the rank's blocks; ``state_specs`` their specs); ``losses``
    holds every step run, a step redone after a restart once more;
    ``step_seconds`` each step's host time (ending in the loss's copy to
    the host)."""

    def __init__(self, arch: ArchConfig, data_cfg: DataConfig,
                 cfg: TrainerConfig, *, device=None, mesh=None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.arch = arch
        self.cfg = cfg
        if device is None and dist.is_initialized():
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
        self.device = resolve_device(device)
        self.data = SyntheticLMDataset(data_cfg, self.device)
        self.model = build_model(arch)
        self.opt_cfg = opt_cfg or default_opt_cfg(arch)
        self.failure_hook = failure_hook
        self.monitor = StragglerMonitor()
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.ckpt_keep)
        self.losses: list = []
        self.step_seconds: list = []
        self._train_step = make_train_step(self.model, self.opt_cfg)
        self.mesh = self.ctx = self.state_specs = self._shardings = None
        if mesh is None and dist.is_initialized():
            mesh = make_mesh((dist.get_world_size(), 1), ("data", "model"),
                             device=self.device)
        if mesh is not None:
            self._install_mesh(mesh)

    # -- mesh / sharding -------------------------------------------------
    def _install_mesh(self, mesh):
        self.mesh = mesh
        self.ctx = make_ctx(mesh)

    def _state_specs(self, params, opt_state):
        """The state's specs under ``LM_RULES`` (``state_specs``); the
        step is built for them."""
        specs = match_partition_rules(LM_RULES, params, self.ctx)
        opt_specs = {"step": P(), "m": specs, "v": specs}
        if "master" in opt_state:
            opt_specs["master"] = specs
        self.state_specs = {"params": specs, "opt": opt_specs}
        self._shardings = named_shardings(self.state_specs, self.mesh)
        self._train_step = make_train_step(self.model, self.opt_cfg,
                                           ctx=self.ctx, specs=specs)

    def _shard_state(self, params, opt_state):
        """Full state -> the rank's blocks under ``state_specs``."""
        return (shard_tree(params, self.state_specs["params"], self.mesh),
                shard_tree(opt_state, self.state_specs["opt"], self.mesh))

    def _step_fn(self, params, opt_state, batch, step: int):
        return self._train_step(params, opt_state, batch,
                                lr_scale(self.cfg.schedule, step))

    # -- init / resume ---------------------------------------------------
    def _fresh_state(self):
        params = self.model.init(self.cfg.seed, self.device)
        opt_state = adamw_init(params, self.opt_cfg)
        log.info("init %s: %.1fM params", self.arch.name,
                 param_count(params) / 1e6)
        return params, opt_state

    def _try_resume(self, params_tmpl, opt_tmpl):
        step = latest_step(self.cfg.ckpt_dir)
        if step is None:
            return None
        state, step, _ = restore(self.cfg.ckpt_dir,
                                 {"params": params_tmpl, "opt": opt_tmpl},
                                 step=step, device=self.device,
                                 shardings=self._shardings)
        log.info("resumed from step %d", step)
        return state["params"], state["opt"], step

    # -- main loop ---------------------------------------------------------
    def run(self) -> dict:
        restarts = 0
        start_step = 0
        params = opt_state = None
        while True:
            try:
                if params is None:
                    params, opt_state = self._fresh_state()
                    if self.mesh is not None:
                        self._state_specs(params, opt_state)
                    resumed = self._try_resume(params, opt_state)
                    if resumed is not None:
                        params, opt_state, start_step = resumed
                    elif self.mesh is not None:
                        params, opt_state = self._shard_state(params,
                                                              opt_state)
                return self._run_from(params, opt_state, start_step)
            except _SimulatedFailure as e:
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                log.warning("failure at step %d (%s); restart %d", e.step,
                            e, restarts)
                self.ckpt.wait()
                params = opt_state = None
                start_step = 0   # re-derived from the checkpoint

    def _run_from(self, params, opt_state, start_step: int) -> dict:
        cfg = self.cfg
        for step in range(start_step, cfg.total_steps):
            if self.failure_hook is not None:
                self.failure_hook(step)   # may raise _SimulatedFailure
            batch = self.data.host_batch(step, 0, 1)
            if self.mesh is not None:
                batch = tree_map(lambda x, s: s.shard(x), batch,
                                 make_batch_specs(batch, self.ctx, "dp"))
            t0 = time.perf_counter()
            params, opt_state, loss = self._step_fn(params, opt_state,
                                                    batch, step)
            loss = float(loss)
            dt = time.perf_counter() - t0
            self.monitor.record("host0", dt)
            self.step_seconds.append(dt)
            self.losses.append(loss)
            if step % cfg.log_every == 0:
                log.info("step %d loss %.4f (%.0f ms)", step, loss, dt * 1e3)
            if (step + 1) % cfg.ckpt_every == 0:
                self.ckpt.save_async(step + 1,
                                     {"params": params, "opt": opt_state},
                                     extra={"loss": loss},
                                     shardings=self._shardings)
        self.ckpt.wait()
        return {"params": params, "opt": opt_state,
                "final_loss": self.losses[-1] if self.losses else None,
                "losses": self.losses}


class _SimulatedFailure(RuntimeError):
    """Raised by failure hooks to emulate a node loss."""

    def __init__(self, step: int, msg: str = "simulated node failure"):
        super().__init__(msg)
        self.step = step


def make_failure_hook(fail_at_steps):
    """Fail exactly once at each listed step (then pass)."""
    remaining = set(fail_at_steps)

    def hook(step: int):
        if step in remaining:
            remaining.discard(step)
            raise _SimulatedFailure(step)

    return hook
