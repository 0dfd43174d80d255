"""The port's dry-run (``launch/dryrun.py``, ``launch/dryrun_pp.py``,
``launch/profile_cell.py``) on fake process groups, every tensor on the
meta device:

  * ``run_cell`` on the smoke variant of the 10 archs x 4 shapes, at
    small sequence lengths and batches, on fake (2, 2) and (2, 2, 2)
    meshes: status ``ok`` or JAX's ``skipped`` (the same reason as
    ``supports``), the record's keys as documented, no argument and no
    op output off the meta device, a record written per cell, and
    ``summarize`` counting them;
  * one published-width cell, granite-3-2b x decode_32k x single (256
    ranks): the KV cache's sequence split over ``model``, so the rank
    holds 1/256 of the cache;
  * ``dryrun_pp`` on granite's smoke variant on (2, 2, 2): activations
    cross the pod axis (``ppermute`` + the broadcast);
  * ``profile_cell.collect`` sums rows per (op, call site, shape).
"""
import json
import os

import pytest

from repro_torch.configs import ARCHS, SHAPES, get_arch, supports
from repro_torch.configs.base import ShapeSpec, smoke_variant
from repro_torch.launch import dryrun, dryrun_pp, profile_cell

# each shape at a length and batch the CPU runs in well under a second
SMALL = {"train_4k": (64, 8), "prefill_32k": (64, 4),
         "decode_32k": (64, 4), "long_500k": (128, 1)}
MESHES = {"single": (2, 2), "multi": (2, 2, 2)}
KEYS = {"arch", "shape", "mesh", "tag", "status", "seconds", "devices",
        "n_params", "n_active_params", "memory", "fits_hbm",
        "peak_bytes_per_device", "collectives", "collectives_by_axis",
        "cost", "roofline"}


def _small(shape_name):
    s = SHAPES[shape_name]
    return ShapeSpec(s.name, *SMALL[shape_name], s.kind)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_smoke_cell(arch, mesh, tmp_path):
    cfg = smoke_variant(get_arch(arch))
    for shape in SHAPES:
        rec = dryrun.run_cell(arch, shape, mesh == "multi",
                              out_dir=str(tmp_path), cfg=cfg,
                              shape=_small(shape), mesh_shape=MESHES[mesh])
        ok, why = supports(cfg, SHAPES[shape])
        if not ok:
            assert rec["status"] == "skipped" and rec["reason"] == why
            continue
        assert rec["status"] == "ok", rec.get("trace")
        assert set(rec) == KEYS
        assert set(rec["memory"]) == {"temp_size_in_bytes",
                                      "argument_size_in_bytes"}
        assert set(rec["cost"]) == {"flops", "bytes", "dot_flops",
                                    "collective_bytes", "kernels",
                                    "off_meta_ops"}
        assert rec["cost"]["off_meta_ops"] == 0
        assert rec["devices"] == (8 if mesh == "multi" else 4)
        assert rec["peak_bytes_per_device"] == sum(rec["memory"].values())
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "memory",
                                               "collective")
        if SHAPES[shape].kind == "train":   # the gradient's reduction
            assert rec["collectives"]["all-reduce"] > 0
        path = tmp_path / f"{arch}__{shape}__{mesh}.json"
        assert json.loads(path.read_text())["status"] == "ok"
    summary = dryrun.summarize(str(tmp_path))
    assert summary["status"]["error"] == 0
    assert sum(summary["status"].values()) == len(SHAPES)
    assert summary["over_hbm"] == []          # smoke widths fit a card


def test_published_width_decode_cell(tmp_path):
    rec = dryrun.run_cell("granite-3-2b", "decode_32k", False,
                          out_dir=str(tmp_path))
    assert rec["status"] == "ok", rec.get("trace")
    cfg = ARCHS["granite-3-2b"]
    # K and V of 40 layers, 128 rows x 32768 positions x 8 kv heads x 64,
    # bf16, the rows over 16 data ranks and the positions over 16 model
    # ranks: each rank holds 1/256 of the cache
    cache = 2 * cfg.n_layers * 128 * 32768 * cfg.n_kv * cfg.head_dim * 2
    assert rec["devices"] == 256
    assert rec["memory"]["argument_size_in_bytes"] >= cache // 256
    assert rec["n_params"] == rec["n_active_params"]
    # the softmax combine over the sequence blocks: pmax and two psums a
    # layer over model, the gathers of the dense params
    assert rec["collectives_by_axis"]["model"] > 0
    assert rec["collectives"]["all-gather"] > 0
    assert rec["cost"]["off_meta_ops"] == 0


def test_pipeline_dry_run(tmp_path):
    cfg = smoke_variant(get_arch("granite-3-2b"))
    rec = dryrun_pp.run_pp("granite-3-2b", 2, out_dir=str(tmp_path),
                           cfg=cfg, mesh_shape=(2, 2, 2),
                           shape=_small("train_4k"))
    assert rec["status"] == "ok" and rec["tag"] == "pp2"
    assert rec["collectives"]["collective-permute"] > 0
    assert rec["collectives"]["broadcast"] > 0
    assert dryrun_pp.pod_bytes(rec) > 0
    assert rec["cost"]["off_meta_ops"] == 0
    assert os.path.exists(tmp_path / "granite-3-2b__train_4k__multi_pp2.json")


def test_profile_collect_sums_rows():
    rows = [("bytes", "aten.mm", "a.py:1 f", "(2, 2)", 8.0),
            ("bytes", "aten.mm", "a.py:1 f", "(2, 2)", 4.0),
            ("bytes", "aten.add", "a.py:2 f", "(2, 2)", 20.0),
            ("flops", "aten.mm", "a.py:1 f", "(2, 2)", 16.0)]
    assert profile_cell.collect(rows, "bytes") == [
        (20.0, "aten.add", "a.py:2 f", "(2, 2)"),
        (12.0, "aten.mm", "a.py:1 f", "(2, 2)")]
    assert profile_cell.collect(rows, "flops") == [
        (16.0, "aten.mm", "a.py:1 f", "(2, 2)")]
