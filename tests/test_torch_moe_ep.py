"""The port's expert-parallel MoE (``models.moe.apply_moe_shard_map``) on 8
gloo ranks of a (2, 4) ("data", "model") mesh against the reference's
``shard_map`` run on 8 forced host devices (as ``tests/test_moe_ep.py``
runs it), on that test's inputs: the reduced qwen3-moe-30b-a3b.

Held: the output within 1e-5 of its largest and the aux loss within 1e-6
of the reference's, at the default capacity and at one where the per-rank
C_loc drops assignments; the dense ``apply_moe`` at a capacity that
drops assignments, against the reference's; where nothing drops, the output within 1e-4 of
the port's dense ``apply_moe``; the gradients through the all-to-all (the
tokens', the local experts', the router's) equal the dense layer's
gradients within 1e-5 of their largest; the two fallbacks (E not dividing
over "model", T not over "data") are taken where the reference takes them,
and equal it.  The first, with the batch sharded over "data", also at a
capacity and at a capacity factor where the global batch's capacity
drops assignments (the reference's SPMD layer keeps the global stable
sort's first C of each expert; the ranks must keep the same ones), and
its gradients, the aux loss's among them, equal the dense layer's there.
Each rank runs in a spawned process with a ``FileStore``
under the test's temporary directory, and ends its process group.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
DROP_CAPACITY = 3          # C_loc of 16 tokens x 2 assignments over 4 experts
DENSE_CAPACITY = 40        # C of 128 tokens x 2 assignments over 4 experts
FALLBACK_CAPACITY = 20     # C of 128 tokens x 2 assignments over 6 experts
FALLBACK_FACTOR = 0.5      # a capacity factor that drops there

REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import moe as M
mesh = jax.make_mesh((2, 4), ("data", "model"))
cfg = get_config("qwen3-moe-30b-a3b").reduced()
m = cfg.moe
m6 = dataclasses.replace(m, num_experts=6)
m6cf = dataclasses.replace(m6, capacity_factor=%(factor)r)
p = M.init_moe(jax.random.PRNGKey(0), cfg.d_model, m)
p6 = M.init_moe(jax.random.PRNGKey(2), cfg.d_model, m6)
x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, cfg.d_model))
x1 = jax.random.normal(jax.random.PRNGKey(3), (1, 15, cfg.d_model))
pol = {"mesh": mesh, "dp": ("data",), "dp_size": 2, "tp_size": 4,
       "moe_ep": True}
dense = M.apply_moe
calls = []

def counted(*a, **k):
    calls.append(1)
    return dense(*a, **k)

M.apply_moe = counted
out = {"x": x, "x1": x1}
out["capacity_out"], out["capacity_aux"] = M.apply_moe(p, x, m, %(dense_cap)d)
for name, (pp, mm, xx, cap) in {"default": (p, m, x, None),
                                "drop": (p, m, x, %(cap)d),
                                "fallback_e": (p6, m6, x, None),
                                "fallback_e_drop": (p6, m6, x, %(fcap)d),
                                "fallback_e_cf": (p6, m6cf, x, None),
                                "fallback_t": (p, m, x1, None)}.items():
    calls.clear()
    with mesh:
        o, a = jax.jit(lambda p, x: M.apply_moe_shard_map(p, x, mm, pol,
                                                           cap))(pp, xx)
    out[name + "_out"], out[name + "_aux"] = o, a
    out[name + "_fallback"] = bool(calls)
for pre, tree in (("p", p), ("p6", p6)):
    for k, v in tree.items():
        if isinstance(v, dict):
            for k2, v2 in v.items():
                out[f"{pre}__{k}__{k2}"] = v2
        else:
            out[f"{pre}__{k}"] = v
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in out.items()})
print("REF-OK")
""" % {"cap": DROP_CAPACITY, "dense_cap": DENSE_CAPACITY,
       "fcap": FALLBACK_CAPACITY, "factor": FALLBACK_FACTOR}


def _tree(d, pre):
    out = {}
    for k in getattr(d, "files", d):
        parts = k.split("__")
        if parts[0] != pre:
            continue
        node = out
        for q in parts[1:-1]:
            node = node.setdefault(q, {})
        node[parts[-1]] = torch.tensor(d[k])
    return out


def _leaves(p):
    """A copy of the layer's tree whose leaves require their gradients."""
    return {k: _leaves(v) if isinstance(v, dict)
            else v.detach().requires_grad_(True) for k, v in p.items()}


def _flat(p, pre=""):
    for k, v in p.items():
        if isinstance(v, dict):
            yield from _flat(v, pre + k + "/")
        else:
            yield pre + k, v


def _rank(rank, store, data, out_dir):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding.ctx import activation_sharding

    dist.init_process_group("gloo", store=dist.FileStore(store, 8),
                            rank=rank, world_size=8)
    try:
        mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data",
                                                               "model"))
        d = np.load(data)
        m = get_config("qwen3-moe-30b-a3b").reduced().moe
        m6 = dataclasses.replace(m, num_experts=6)
        p, p6 = _tree(d, "p"), _tree(d, "p6")
        x, x1, w = (torch.tensor(d[k]) for k in ("x", "x1", "w"))
        di, mi = mesh.get_local_rank("data"), mesh.get_local_rank("model")
        xs, ws = x[di * 4:(di + 1) * 4], w[di * 4:(di + 1) * 4]
        # the rank's expert (E/tp = 1 of 4), as the train step holds it
        local = dict(p, **{n: p[n][mi:mi + 1] for n in
                           ("w_gate", "w_up", "w_down")})
        res = {}
        with activation_sharding(mesh) as pol:
            for name, cap in (("default", None), ("drop", DROP_CAPACITY)):
                coll.reset_counts()
                o, a = M.apply_moe_shard_map(local, xs, m, pol, cap)
                res[name] = (o, a, coll.counts()["calls"]["all-to-all"])
            m6cf = dataclasses.replace(m6, capacity_factor=FALLBACK_FACTOR)
            for name, mm, cap in (("fallback_e", m6, None),
                                  ("fallback_e_drop", m6, FALLBACK_CAPACITY),
                                  ("fallback_e_cf", m6cf, None)):
                coll.reset_counts()
                o, a = M.apply_moe_auto(p6, xs, mm, cap)
                res[name] = (o, a, coll.counts()["calls"]["all-to-all"])

            # the fallback's gradients where the global capacity drops:
            # the ranks' losses sum to the dense layer's sum(out * w) + aux
            leaf = _leaves(p6)
            xg = xs.detach().requires_grad_(True)
            o, a = M.apply_moe_auto(leaf, xg, m6, FALLBACK_CAPACITY)
            ((o * ws).sum() / 4 + a / 8).backward()
            with torch.no_grad():
                gx = coll.all_reduce(xg.grad, mesh, "model")
                g = {k: coll.all_reduce(v.grad, mesh, ("data", "model"))
                     for k, v in _flat(leaf)}
            res["fallback_grads"] = (gx, g)

            # gradients: the ranks' losses sum to the dense layer's
            # sum(out * w) (model ranks hold the same tokens)
            leaf = _leaves(local)
            xg = xs.detach().requires_grad_(True)
            o, _ = M.apply_moe_shard_map(leaf, xg, m, pol)
            ((o * ws).sum() / 4).backward()
            with torch.no_grad():
                gx = coll.all_reduce(xg.grad, mesh, "model")
                g = {k: coll.all_reduce(
                    v.grad, mesh, "data" if k in ("w_gate", "w_up", "w_down")
                    else ("data", "model"))
                    for k, v in _flat(leaf)}
            res["grads"] = (gx, g)
        with activation_sharding(mesh, batch_sharded=False) as pol:
            coll.reset_counts()
            o, a = M.apply_moe_shard_map(p, x1, m, pol)
            res["fallback_t"] = (o, a, coll.counts()["calls"]["all-to-all"])
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's run and the 8 ranks' results -> (reference arrays,
    per-rank results, the dense layer's parameters and inputs)."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    data = tmp / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REF, str(data)], env=env,
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert "REF-OK" in r.stdout, r.stdout + r.stderr
    d = dict(np.load(data))
    rng = np.random.default_rng(0)
    d["w"] = rng.standard_normal(d["x"].shape).astype(np.float32)
    np.savez(data, **d)
    mp.spawn(_rank, args=(str(tmp / "store"), str(data), str(tmp)),
             nprocs=8)
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(8)]
    return d, ranks, _tree(np.load(data), "p")


def _assembled(ranks, name):
    """The ranks' data shards stacked (model ranks must agree)."""
    for i in range(8):
        assert torch.equal(ranks[i][name][0], ranks[i - i % 4][name][0])
    return torch.cat([ranks[0][name][0], ranks[4][name][0]])


def _moe_cfg():
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    return get_config("qwen3-moe-30b-a3b").reduced().moe


@pytest.mark.parametrize("name", ["default", "drop"])
def test_expert_parallel_matches_reference_shard_map(runs, name):
    d, ranks, _ = runs
    assert _rel(_assembled(ranks, name), d[f"{name}_out"]) <= 1e-5
    for rk in ranks:
        assert abs(float(rk[name][1]) - float(d[f"{name}_aux"])) <= 1e-6
        assert rk[name][2] == 2          # the exchange and its return
    # the small capacity drops assignments
    assert _rel(_assembled(ranks, "drop"), d["default_out"]) > 1e-3


def test_expert_parallel_without_drops_matches_dense_layer(runs):
    from repro_torch.models import moe as M
    d, ranks, p = runs
    dense, _ = M.apply_moe(p, torch.tensor(d["x"]), _moe_cfg())
    assert _rel(_assembled(ranks, "default"), dense.detach()) <= 1e-4


def test_gradients_through_the_all_to_all_match_dense_layer(runs):
    from repro_torch.models import moe as M
    d, ranks, p = runs
    leaf = _leaves(p)
    xg = torch.tensor(d["x"]).requires_grad_(True)
    o, _ = M.apply_moe(leaf, xg, _moe_cfg())
    (o * torch.tensor(d["w"])).sum().backward()
    gx = torch.cat([ranks[0]["grads"][0], ranks[4]["grads"][0]])
    assert _rel(gx, xg.grad) <= 1e-5
    grads = dict(_flat(leaf))
    assert sorted(grads) == sorted(ranks[0]["grads"][1])
    for k, v in grads.items():
        if k in ("w_gate", "w_up", "w_down"):   # a model rank's expert
            got = torch.cat([ranks[i]["grads"][1][k] for i in range(4)])
        else:
            got = ranks[0]["grads"][1][k]
        assert _rel(got, v.grad) <= 1e-5, k


@pytest.mark.parametrize("name", ["fallback_e", "fallback_e_drop",
                                  "fallback_e_cf", "fallback_t"])
def test_fallbacks_taken_where_the_reference_takes_them(runs, name):
    d, ranks, _ = runs
    assert bool(d[f"{name}_fallback"])
    assert not bool(d["default_fallback"]) and not bool(d["drop_fallback"])
    for rk in ranks:                     # no exchange: the dense layer
        assert rk[name][2] == 0
        assert abs(float(rk[name][1]) - float(d[f"{name}_aux"])) <= 1e-6
    if name != "fallback_t":             # the batch sharded over "data"
        out = _assembled(ranks, name)
    else:                                # every rank the whole batch
        out = ranks[0][name][0]
        assert all(torch.equal(rk[name][0], out) for rk in ranks)
    assert _rel(out, d[f"{name}_out"]) <= 1e-5
    if name in ("fallback_e_drop", "fallback_e_cf"):   # the capacity drops
        assert _rel(out, d["fallback_e_out"]) > 1e-3


def test_fallback_gradients_at_a_dropping_capacity_match_dense_layer(runs):
    import dataclasses

    from repro_torch.models import moe as M
    d, ranks, _ = runs
    m6 = dataclasses.replace(_moe_cfg(), num_experts=6)
    leaf = _leaves(_tree(d, "p6"))
    xg = torch.tensor(d["x"]).requires_grad_(True)
    o, a = M.apply_moe(leaf, xg, m6, capacity=FALLBACK_CAPACITY)
    ((o * torch.tensor(d["w"])).sum() + a).backward()
    gx = torch.cat([ranks[0]["fallback_grads"][0],
                    ranks[4]["fallback_grads"][0]])
    assert _rel(gx, xg.grad) <= 1e-5
    grads = dict(_flat(leaf))
    assert sorted(grads) == sorted(ranks[0]["fallback_grads"][1])
    for k, v in grads.items():
        for rk in ranks:
            assert _rel(rk["fallback_grads"][1][k], v.grad) <= 1e-5, k


def test_dense_layer_at_a_dropping_capacity_matches_reference(runs):
    from repro_torch.models import moe as M
    d, _, p = runs
    m = _moe_cfg()
    out, aux = M.apply_moe(p, torch.tensor(d["x"]), m,
                           capacity=DENSE_CAPACITY)
    assert _rel(out, d["capacity_out"]) <= 1e-5
    assert abs(float(aux) - float(d["capacity_aux"])) <= 1e-6
    full, _ = M.apply_moe(p, torch.tensor(d["x"]), m)     # nothing drops
    assert _rel(out, full) > 1e-3
