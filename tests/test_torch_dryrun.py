"""The port's dry run (``repro_torch.launch.dryrun``, ``roofline``,
``report``) against the reference's.

* ``applicable``, ``variant_config`` and ``probe_cfg`` equal the
  reference's for all 40 (arch x shape) pairs;
* a rank's argument bytes equal the reference's spec-derived count (each
  leaf's shard under the reference's specs) for every applicable pair on
  pod16x16 and pod2x16x16 (stand-in meshes: the rules read only axis names
  and sizes), and 98,384,900 for gemma2-2b x train_4k x pod16x16: the
  ``memory.argument_bytes`` of the reference's compiled artifact
  ``artifacts/dryrun/gemma2-2b__train_4k__pod16x16.json``;
* ``extrapolate`` and ``analytic_model_flops`` equal the reference's on the
  same inputs (the time terms each with its own chip's constants);
* one dry run of a reduced pair in a process of its own (a fake process
  group of 256 ranks) writes a well-formed record, and ``report`` renders
  it; one of the reduced gemma2-2b x long_500k decode pair runs the
  sharded serve step: the attention merge's all-gathers are counted, and
  the rank's peak stays below one global layer's whole K cache.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import dryrun as RD
from repro.launch import mesh as RM
from repro.launch import roofline as RR
from repro.launch import steps as RST
from repro.sharding import specs as RS
from repro_torch.configs import INPUT_SHAPES, get_config, list_archs
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch import report
from repro_torch.launch import roofline as R
from repro_torch.sharding import specs as S

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"pod16x16": (("data", "model"), (16, 16)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}
ARTIFACT = ROOT / "artifacts" / "dryrun" / "gemma2-2b__train_4k__pod16x16.json"


def ref_mesh(name):
    names, shape = MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def _ref_bytes(structs, specs, mesh):
    import jax
    total = 0
    for s, sp in zip(jax.tree_util.tree_leaves(structs),
                     jax.tree_util.tree_leaves(
                         specs, is_leaf=lambda x: isinstance(x,
                                                             PartitionSpec))):
        n = 1
        for dim, entry in zip(s.shape, tuple(sp) + (None,) * len(s.shape)):
            n *= dim // RS._axis_size(mesh, entry)
        total += n * s.dtype.itemsize
    return total


def ref_argument_bytes(cfg, shape_name, mesh):
    """The reference's arguments of ``lower_one``, summed shard by shard
    under its own specs."""
    shp = REF_SHAPES[shape_name]
    batch = RST.batch_struct(cfg, shape_name)
    if shp.kind == "train":
        _, p, o, ps, os_ = RST.build_train_step(cfg, mesh, optimizer="adam",
                                                param_dtype=jnp.float32)
        return (_ref_bytes(p, ps, mesh) + _ref_bytes(o, os_, mesh)
                + _ref_bytes(batch, RS.lm_input_specs(batch, mesh), mesh))
    dt = jnp.dtype(cfg.dtype)
    if shp.kind == "prefill":
        _, p, ps = RST.build_prefill_step(cfg, mesh, param_dtype=dt)
        return (_ref_bytes(p, ps, mesh)
                + _ref_bytes(batch, RS.lm_input_specs(batch, mesh), mesh))
    _, p, s, ps, ss = RST.build_serve_step(cfg, mesh, shape_name,
                                           param_dtype=dt)
    B = shp.global_batch
    dps = RD._dp_size(mesh)
    tok = PartitionSpec(RS.batch_axes(mesh)) if B % dps == 0 else \
        PartitionSpec()
    return (_ref_bytes(p, ps, mesh) + _ref_bytes(s, ss, mesh)
            + _ref_bytes(batch, {"tokens": tok}, mesh))


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", list_archs())
def test_pairs_and_argument_bytes_match_reference(arch):
    for shape in INPUT_SHAPES:
        runs = D.applicable(arch, shape)
        assert runs == RD.applicable(arch, shape), (arch, shape)
        if not runs[0]:
            continue
        cfg = D.variant_config(get_config(arch), runs[1])
        rcfg = RD.variant_config(ref_config(arch), runs[1])
        assert _fields(cfg) == _fields(rcfg)
        for reps in (1, 2):
            assert _fields(D.probe_cfg(cfg, reps)) == \
                _fields(RD.probe_cfg(rcfg, reps))
        for m in MESHES:
            got = D.argument_bytes(cfg, shape, S.MeshShape(*MESHES[m]))
            assert got == ref_argument_bytes(rcfg, shape, ref_mesh(m)), \
                (arch, shape, m)


def test_gemma2_train_4k_argument_bytes_equal_compiled_artifact():
    want = json.loads(ARTIFACT.read_text())["memory"]["argument_bytes"]
    assert want == 98_384_900
    got = D.argument_bytes(get_config("gemma2-2b"), "train_4k",
                           S.MeshShape(*MESHES["pod16x16"]))
    assert got == want


def test_extrapolate_and_model_flops_match_reference():
    rng = np.random.default_rng(0)
    for arch in list_archs():
        for shape in INPUT_SHAPES:
            cfg, rcfg = get_config(arch), ref_config(arch)
            assert R.analytic_model_flops(cfg, INPUT_SHAPES[shape]) == \
                RR.analytic_model_flops(rcfg, REF_SHAPES[shape])
    for _ in range(20):
        c1 = {"flops": float(rng.uniform(1e12, 1e14)),
              "bytes accessed": float(rng.uniform(1e9, 1e12))}
        c2 = {k: v * float(rng.uniform(1.0, 2.5)) for k, v in c1.items()}
        k1 = {"total": int(rng.integers(0, 1 << 32))}
        k2 = {"total": k1["total"] + int(rng.integers(-1 << 20, 1 << 30))}
        args = (int(rng.integers(1, 40)), int(rng.integers(0, 3)),
                int(rng.integers(1, 8)), 256, float(rng.uniform(1e15, 1e17)))
        got = R.extrapolate(c1, c2, k1, k2, *args, M.collective_link(16))
        want = RR.extrapolate(c1, c2, k1, k2, *args)
        for k in ("flops", "hbm_bytes", "coll_bytes", "chips",
                  "model_flops", "useful_flops_ratio"):
            assert getattr(got, k) == getattr(want, k), k
        assert got.t_compute == want.flops / 989e12
        assert got.t_memory == want.hbm_bytes / 3.35e12
        assert got.t_collective == want.coll_bytes / 50e9
        assert want.t_compute == want.flops / RM.PEAK_FLOPS_BF16
    assert M.collective_link(8) == ("nvlink", 450e9)
    assert M.collective_link(16) == ("infiniband", 50e9)


def test_reduced_dry_run_writes_record_and_report_renders_it(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen3-moe-30b-a3b", "--shape", "train_4k", "--reduced", "--out",
         str(tmp_path)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(
        (tmp_path / "qwen3-moe-30b-a3b__train_4k__pod16x16.json").read_text())
    assert rec["status"] == "ok" and rec["reduced"] is True
    mem = rec["memory"]
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    assert mem["argument_bytes"] == D.argument_bytes(
        cfg, "train_4k", S.MeshShape(*MESHES["pod16x16"]))
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] > 0 and mem["fits_80GB"] is True
    assert rec["microbatches"] == 1
    assert rec["chip"]["peak_flops_bf16"] == 989e12
    t = rec["roofline"]
    assert t["chips"] == 256 and t["collective_link"] == "infiniband"
    assert t["flops"] > 0 and t["hbm_bytes"] > 0
    assert all(math.isfinite(t[k]) for k in ("t_compute_s", "t_memory_s",
                                              "t_collective_s"))
    assert rec["collectives_full"]["all-gather"] > 0
    assert set(rec["probe_cost"]) == {"p1", "p2", "coll1", "coll2"}

    import contextlib
    import io
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        report.main(["--dir", str(tmp_path)])
    text = out.getvalue()
    assert "| qwen3-moe-30b-a3b | train_4k | pod16x16 | ok | 1 |" in text
    assert "989 TFLOP/s" in text and "v5e" not in text
    assert text.count("| qwen3-moe-30b-a3b | train_4k |") == 2


def test_reduced_decode_dry_run_runs_the_sharded_serve_step(tmp_path):
    """gemma2-2b x long_500k (batch 1) on pod16x16: the cache's 524,288
    slots split over ("data", "model"), 2,048 a rank; the rank's step
    gathers weights and merges its attention with the other 255 pieces."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gemma2-2b", "--shape", "long_500k", "--reduced", "--no-probes",
         "--out", str(tmp_path)], env=env, cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    rec = json.loads(
        (tmp_path / "gemma2-2b__long_500k__pod16x16.json").read_text())
    assert rec["status"] == "ok"
    cfg = get_config("gemma2-2b").reduced()
    mesh = S.MeshShape(*MESHES["pod16x16"])
    assert rec["memory"]["argument_bytes"] == D.argument_bytes(
        cfg, "long_500k", mesh)
    calls = rec["collectives_full"]["calls"]
    # the weights of both layers over both axes, and each layer's merge
    # over both axes (its cache's slots split over ("data", "model"))
    assert calls["all-gather"] >= 2 * 2 * 2
    assert rec["collectives_full"]["all-gather"] > 0
    whole_k = (INPUT_SHAPES["long_500k"].seq_len * cfg.num_kv_heads
               * cfg.head_dim * 4)                    # f32, batch 1
    assert 0 < rec["memory"]["temp_bytes"] < whole_k
