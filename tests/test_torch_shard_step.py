"""The port's sharded train step (``launch.steps.shard_train_step``) on a
(2, 4) ("data", "model") mesh of 8 gloo ranks against the single-process
step, and the activation policy on a DTensor.

* reduced gemma2-2b, qwen3-moe-30b-a3b and qwen2-moe-a2.7b (a shared
  expert beside the routed ones), one SGD step at f32 with 2
  microbatches: the gathered parameters, the gradients (their difference
  over the rate) and the loss within 1e-5 of their largest.  The MoE's aux
  weight is 0 here: on an expert-parallel mesh its aux loss is the mean of
  the ranks' (the reference's ``shard_map`` takes the same ``pmean``), not
  the whole batch's, so it differs from the single-process aux by design;
  ``tests/test_torch_moe_ep.py`` holds it against the reference;
* the reduced qwen2-moe-a2.7b with 6 experts, which do not divide over
  "model": the layer falls back to the dense one over the global batch,
  at a capacity factor where the global capacity drops assignments and
  with its aux loss, which is then the whole batch's: the same limits;
* ``sharding.ctx.constrain`` redistributes a DTensor to its spec's
  placements and leaves a plain tensor as it is.

The ranks are spawned processes, each starting its group from a
``FileStore`` under the test's temporary directory and ending it.
"""
import dataclasses
import os
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.sharding import specs as S
from repro_torch.tree import leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
HOST = S.MeshShape(("data", "model"), (1, 1))
SEQ = 32


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


FALLBACK = "qwen2-moe-a2.7b fallback"
SHARD_ARCHS = ("gemma2-2b", "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b",
               FALLBACK)
# a rate at which the parameters' change resolves the gradient: at 1.0 a
# norm scale's change of ~5e-3 reads through f32's rounding near 1.0
# (6e-8), ~1.2e-5 of the gradient, beyond the 1e-5 limit; at 1024 ~1e-7
LR = 1024.0


def _shard_cfg(arch):
    if arch == FALLBACK:
        cfg = get_config("qwen2-moe-a2.7b").reduced()
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=6, capacity_factor=0.5))
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, router_aux_weight=0.0))
    return cfg


def _expert_parallel(cfg):
    return cfg.moe is not None and cfg.moe.num_experts % 4 == 0


def _inputs(cfg):
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (8, SEQ), dtype=np.int32))
    return params, {"tokens": toks}


def _shard_rank(rank, store, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.sharding import collectives as coll

    dist.init_process_group("gloo", store=dist.FileStore(store, 8),
                            rank=rank, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4),
                                mesh_dim_names=("data", "model"))
        res = {}
        for arch in SHARD_ARCHS:
            cfg = _shard_cfg(arch)
            fn, _, _, p_sp, o_sp = ST.build_train_step(
                cfg, mesh, optimizer="sgd", lr=LR, bf16_forward=False,
                microbatches=2)
            params, batch = _inputs(cfg)
            b_sp = S.lm_input_specs(batch, mesh)
            opt = get_optimizer("sgd", LR).init(params)
            step = ST.shard_train_step(fn, mesh, p_sp, o_sp, b_sp)
            coll.reset_counts()
            lp, _, met = step(S.shard_tree(params, p_sp, mesh),
                              S.shard_tree(opt, o_sp, mesh),
                              S.shard_tree(batch, b_sp, mesh))
            counts = coll.counts()
            with torch.no_grad():
                whole = tree_map(lambda t, s: coll.gather(t, s, mesh), lp,
                                 p_sp)
            res[arch] = (whole, {k: float(v) for k, v in met.items()},
                         counts)
        # the activation policy on a DTensor: redistributed to its spec
        from torch.distributed.tensor import Replicate, distribute_tensor

        from repro_torch.sharding.ctx import activation_sharding, constrain
        full = torch.arange(8 * 6 * 8, dtype=torch.float32).reshape(8, 6, 8)
        dt = distribute_tensor(full, mesh, [Replicate(), Replicate()])
        with activation_sharding(mesh):
            out = constrain(dt, "logits")
            plain = constrain(full, "logits")
        res["constrain"] = ([repr(q) for q in out.placements],
                            out.full_tensor(), tuple(out.to_local().shape),
                            plain is full)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "sharded.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("shard_step")
    mp.spawn(_shard_rank, args=(str(tmp / "store"), str(tmp)), nprocs=8)
    return torch.load(tmp / "sharded.pt")


@pytest.mark.parametrize("arch", SHARD_ARCHS)
def test_shard_train_step_matches_single_process(sharded, arch):
    cfg = _shard_cfg(arch)
    fn, _, _, _, _ = ST.build_train_step(cfg, HOST, optimizer="sgd", lr=LR,
                                         bf16_forward=False, microbatches=2)
    params, batch = _inputs(cfg)
    before = [t.clone() for t in leaves(params)]
    opt = get_optimizer("sgd", LR).init(params)
    after, _, met = fn(params, opt, batch)
    whole, s_met, counts = sharded[arch]
    for k in ("loss", "nll"):
        assert abs(s_met[k] - float(met[k])) <= 1e-5 * abs(float(met[k]))
    if arch == FALLBACK:                 # the whole batch's aux loss
        assert float(met["aux"]) > 0
        assert abs(s_met["aux"] - float(met["aux"])) <= \
            1e-5 * float(met["aux"])
    for p0, want, got in zip(before, leaves(after), leaves(whole)):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-5
        assert _rel(p0 - got, p0 - want) <= 1e-5     # the gradients
    assert counts["all-gather"] > 0 and counts["reduce-scatter"] > 0
    assert (counts["all-to-all"] > 0) == _expert_parallel(cfg)


def test_constrain_redistributes_a_dtensor(sharded):
    """A plain tensor is returned as it is; a replicated DTensor of logits
    (8, 6, 8) goes to P("data", None, "model"): Shard(0), Shard(2)."""
    placements, whole, local, plain_same = sharded["constrain"]
    assert plain_same
    want = S.to_placements(S.P(("data",), None, "model"),
                           types.SimpleNamespace(
                               mesh_dim_names=("data", "model")))
    assert placements == [repr(q) for q in want]
    assert local == (4, 6, 2)
    assert torch.equal(whole, torch.arange(384, dtype=torch.float32)
                       .reshape(8, 6, 8))
