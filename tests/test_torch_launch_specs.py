"""The port's dry-run inputs and sharding policy against the JAX package.

  * ``models/registry.py::input_specs`` (meta tensors) equals JAX's
    ``input_specs`` (``ShapeDtypeStruct``s) leaf for leaf, shape and
    dtype, for the 10 archs x 4 shapes, the decode caches included.
  * ``launch/dryrun.py --list`` prints JAX's ``--list`` line for line,
    the same RUN / SKIP and reasons.
  * ``ctx_overrides``, ``long_ctx_variant``, ``active_params`` and
    ``parse_variant`` equal JAX's.
  * Each rank's param and AdamW-state bytes in every train cell, and its
    cache bytes in every decode cell, on the (16, 16) and (2, 16, 16)
    meshes: the port's ``build_cell`` (the rank's blocks, on meta, under
    a fake process group of 256 or 512 ranks) against the bytes of JAX's
    leaves cut by JAX's specs (resolved on a stub of the mesh: no 512
    fake JAX devices).
"""
import contextlib
import importlib
import io
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.common.tree import flatten_with_paths as jflat
from repro.configs import ARCHS as JARCHS
from repro.configs import SHAPES as JSHAPES
from repro.distributed import partition as jpart
from repro.distributed.rules import CACHE_RULES as JCACHE_RULES
from repro.distributed.rules import LM_RULES as JLM_RULES
from repro.models.registry import build_model as jbuild
from repro.models.registry import input_specs as jinput_specs
from repro_torch.common.tree import flatten_with_paths
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.launch import dryrun
from repro_torch.models.registry import input_specs

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_dryrun():
    """JAX's ``launch/dryrun.py``, imported without keeping the 512-device
    ``XLA_FLAGS`` it sets at import (this process's JAX stays as it is)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


class _StubMesh:
    """What resolution reads of a mesh: axis names, a devices shape."""

    def __init__(self, shape, names):
        self.axis_names = tuple(names)
        self.devices = np.empty(shape, dtype=object)


def _leaves(tree, jax_side: bool):
    if jax_side:
        return {p: (tuple(x.shape), str(x.dtype)) for p, x in jflat(tree)}
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in flatten_with_paths(tree)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_jax(arch, shape):
    want = _leaves(jinput_specs(JARCHS[arch], JSHAPES[shape]), True)
    got = input_specs(ARCHS[arch], SHAPES[shape])
    assert all(t.device.type == "meta"
               for _, t in flatten_with_paths(got))
    assert _leaves(got, False) == want


def test_list_matches_jax():
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    run = subprocess.run([sys.executable, "-m", "repro.launch.dryrun",
                          "--list"], env=env, capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0, run.stderr[-2000:]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        dryrun.main(["--list"])
    assert out.getvalue().splitlines() == run.stdout.splitlines()
    assert len(run.stdout.splitlines()) == 40


def test_policy_functions_match_jax():
    jd = _jax_dryrun()
    for arch in ARCHS:
        for shape in SHAPES:
            cfg, jcfg = ARCHS[arch], JARCHS[arch]
            s, js = SHAPES[shape], JSHAPES[shape]
            assert dryrun.ctx_overrides(s, cfg) == jd.ctx_overrides(js, jcfg)
            assert (dryrun.long_ctx_variant(cfg, s).attn_backend
                    == jd.long_ctx_variant(jcfg, js).attn_backend)
            assert (dryrun.long_ctx_variant(cfg, s) == cfg) == \
                (jd.long_ctx_variant(jcfg, js) == jcfg)
        for n in (10 ** 9, 123456789):
            assert dryrun.active_params(ARCHS[arch], n) == \
                jd.active_params(JARCHS[arch], n)
    for spec in ("", "flash_vjp=True,q_chunk=512", "w8=False,lr=0.5,x=abc",
                 "capacity_factor=1.5,remat=True"):
        assert dryrun.parse_variant(spec) == jd.parse_variant(spec)


def _jax_bytes(tree, specs, sizes) -> int:
    """Per-rank bytes of JAX's ``tree`` (ShapeDtypeStructs) cut by
    ``specs``."""
    total = 0
    for (p, x), (_, s) in zip(jflat(tree), jflat(specs)):
        n = 1
        for d, dim in enumerate(x.shape):
            e = s[d] if d < len(s) else None
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= dim // math.prod(sizes[a] for a in axes)
        total += n * np.dtype(x.dtype).itemsize
    return total


def _jax_cell_bytes(arch, shape, mesh):
    """JAX's per-rank (params, AdamW state) bytes of a train cell, or
    (cache bytes,) of a decode cell, from its dry-run's specs."""
    jd = _jax_dryrun()
    from repro.launch.steps import default_opt_cfg
    from repro.optim.adamw import adamw_init
    cfg = jd.long_ctx_variant(JARCHS[arch], JSHAPES[shape])
    stub = _StubMesh(*MESHES[mesh])
    sizes = dict(zip(stub.axis_names, stub.devices.shape))
    ctx = jpart.make_ctx(stub, jd.ctx_overrides(JSHAPES[shape], cfg))
    if JSHAPES[shape].kind == "decode":
        caches = jinput_specs(cfg, JSHAPES[shape])["caches"]
        specs = jpart.match_partition_rules(JCACHE_RULES, caches, ctx)
        return (_jax_bytes(caches, specs, sizes),)
    params = jax.eval_shape(jbuild(cfg).init, jax.random.PRNGKey(0))
    specs = jpart.match_partition_rules(JLM_RULES, params, ctx)
    opt = jax.eval_shape(lambda p: adamw_init(p, default_opt_cfg(cfg)),
                         params)
    o_specs = {"step": jax.sharding.PartitionSpec(), "m": specs,
               "v": specs}
    if "master" in opt:
        o_specs["master"] = specs
    return (_jax_bytes(params, specs, sizes),
            _jax_bytes(opt, o_specs, sizes))


def _port_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in flatten_with_paths(tree))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_per_rank_bytes_match_jax_specs(arch, mesh):
    """The rank's blocks that the port's dry-run builds hold exactly the
    bytes JAX's specs give each device."""
    multi = mesh == "multi"
    with dryrun.fake_world(math.prod(MESHES[mesh][0])):
        m = dryrun.production_mesh(multi)
        for shape in ("train_4k", "decode_32k"):
            _, args, _, _ = dryrun.build_cell(ARCHS[arch], SHAPES[shape], m)
            assert all(t.device.type == "meta" for t in
                       [t for a in args for _, t in flatten_with_paths(a)
                        if isinstance(t, torch.Tensor)])
            want = _jax_cell_bytes(arch, shape, mesh)
            got = ((_port_bytes(args[0]), _port_bytes(args[1]))
                   if shape == "train_4k" else (_port_bytes(args[1]),))
            assert got == want, (shape, got, want)
