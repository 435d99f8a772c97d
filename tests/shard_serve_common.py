"""Shared runner of the sharded serve and prefill tests
(``tests/test_torch_shard_serve*.py``): 8 gloo ranks on a (2, 4)
("data", "model") mesh, spawned once a module, each starting its group
from a ``FileStore`` under the test's temporary directory and ending it.

The weights are the reference's ``init_model``'s (through
``tree.params_from_jax``), written once by the test process and read by
every rank.  The reference's side runs in the test process: its jitted
``build_serve_step`` and ``build_prefill_step`` on one device.
"""
import os
import sys
import types
from pathlib import Path

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
MESH = (("data", "model"), (2, 4))
MAX_LEN = 128          # the global layers' cache; the local ring is 64
STEPS = 80             # past the ring's wrap
PREFILL = (8, 32)      # batch, tokens


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


INT8 = "+int8"          # an arch's reduced config with an int8 KV cache


def _reduced(get_config, arch):
    import dataclasses
    cfg = get_config(arch.removesuffix(INT8)).reduced()
    if arch.endswith(INT8):
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    return cfg


def ref_cfg(arch):
    from repro.configs import get_config
    return _reduced(get_config, arch)


def port_cfg(arch):
    from repro_torch.configs import get_config
    return _reduced(get_config, arch)


def ref_mesh():
    names, shape = MESH
    return types.SimpleNamespace(axis_names=names,
                                 devices=np.empty(shape, dtype=object))


def ref_params(arch):
    import jax

    from repro.models import transformer as RT
    return RT.init_model(ref_cfg(arch), jax.random.PRNGKey(0))


def serve_tokens(arch, B):
    return np.random.default_rng(B).integers(
        0, port_cfg(arch).vocab_size, (STEPS, B), dtype=np.int32)


def prefill_tokens(arch):
    return np.random.default_rng(1).integers(
        0, port_cfg(arch).vocab_size, PREFILL, dtype=np.int32)


def _serve(arch, B, params, mesh):
    """``STEPS`` teacher-forced steps of the rank's sharded serve step ->
    (the gathered logits of every step, the gathered state after the last,
    ok: every state leaf has its spec's local shape, every cache leaf is
    smaller than whole, and the ranks that replicate a batch row computed
    the same logits bit for bit)."""
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import specs as S
    from repro_torch.tree import tree_map, tree_map_with_path

    cfg = port_cfg(arch)
    fn, _, _, p_sp, _ = ST.build_serve_step(cfg, mesh, "decode_32k")
    state = T.init_decode_state(cfg, B, MAX_LEN, torch.float32, "cpu")
    s_sp = S.decode_state_specs(state, cfg, mesh, B)
    step = ST.shard_serve_step(fn, mesh, p_sp, s_sp)
    whole_of, spec_of = {}, {}
    tree_map_with_path(lambda path, w: whole_of.__setitem__(path, w), state)
    tree_map_with_path(lambda path, s: spec_of.__setitem__(path, s), s_sp)

    def leaf_of(path):
        return whole_of[path], spec_of[path]
    lp = S.shard_tree(params, p_sp, mesh)
    ls = S.shard_tree(state, s_sp, mesh)
    sizes, coords = S.axis_sizes(mesh), S.mesh_coords(mesh)
    tok_sp = S.P(S.batch_axes(mesh)) if B % sizes["data"] == 0 else S.P()
    lg_sp = S.logits_spec(mesh, (B, cfg.vocab_size))
    toks = torch.from_numpy(serve_tokens(arch, B))
    logits, same = [], True
    with torch.no_grad():
        for pos in range(STEPS):
            lg, ls = step(lp, ls, S.local_shard(toks[pos], tok_sp, sizes,
                                                coords), pos)
            logits.append(coll.gather(lg, lg_sp, mesh))
            if not S.axes_of(lg_sp[0]):      # rows every data rank holds
                rep = coll.all_gather(lg[None], 0, mesh, "data")
                same &= all(torch.equal(rep[0], r) for r in rep[1:])
        whole = tree_map(lambda t, s: coll.gather(t, s, mesh), ls, s_sp)
    shapes = []

    def check(path, t, w, s):
        shapes.append(tuple(t.shape) == S.local_shape(w.shape, s, mesh))
        if path[-1] in ("k", "v"):           # no rank holds a whole cache
            shapes.append(t.numel() < w.numel())
    tree_map_with_path(lambda path, t: check(path, t, *leaf_of(path)), ls)
    return torch.stack(logits), whole, all(shapes) and same


def _prefill(arch, params, mesh):
    """The rank's sharded prefill -> (its logits' shape, the gathered
    logits)."""
    from repro_torch.launch import steps as ST
    from repro_torch.sharding import collectives as coll
    from repro_torch.sharding import specs as S

    cfg = port_cfg(arch)
    fn, _, p_sp = ST.build_prefill_step(cfg, mesh)
    batch = {"tokens": torch.from_numpy(prefill_tokens(arch))}
    b_sp = S.lm_input_specs(batch, mesh)
    step = ST.shard_prefill_step(fn, mesh, p_sp, b_sp)
    with torch.no_grad():
        lg = step(S.shard_tree(params, p_sp, mesh),
                  S.shard_tree(batch, b_sp, mesh))
        whole = coll.gather(lg, S.logits_spec(
            mesh, PREFILL + (cfg.vocab_size,)), mesh)
    return tuple(lg.shape), whole


def _rank(rank, store, tmp, serve, prefill):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, str(ROOT / "src"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 8),
                            rank=rank, world_size=8)
    try:
        mesh = init_device_mesh("cpu", MESH[1], mesh_dim_names=MESH[0])
        params = torch.load(os.path.join(tmp, "params.pt"))
        res = {}
        for arch, B in serve:
            res[("serve", arch, B)] = _serve(arch, B, params[arch], mesh)
        for arch in prefill:
            res[("prefill", arch)] = _prefill(arch, params[arch], mesh)
        # every rank's checks: ok where they hold on all ranks
        keys = sorted(k for k in res if k[0] == "serve")
        ok = torch.tensor([int(res[k][2]) for k in keys], dtype=torch.int32)
        if keys:
            dist.all_reduce(ok, op=dist.ReduceOp.MIN)
        for k, v in zip(keys, ok.tolist()):
            res[k] = res[k][:2] + (bool(v),)
        if rank == 0:
            torch.save(res, os.path.join(tmp, "sharded.pt"))
    finally:
        dist.destroy_process_group()


def run_ranks(tmp, serve=(), prefill=()):
    """Spawn the 8 ranks over ``serve`` ((arch, batch) pairs) and
    ``prefill`` (archs) -> {key: result} as rank 0 saw it; a serve
    result's ok holds on every rank."""
    from repro_torch.tree import params_from_jax

    archs = sorted({a for a, _ in serve} | set(prefill))
    torch.save({a: params_from_jax(ref_params(a), "cpu") for a in archs},
               os.path.join(tmp, "params.pt"))
    mp.spawn(_rank, args=(os.path.join(tmp, "store"), str(tmp),
                          tuple(serve), tuple(prefill)), nprocs=8)
    return torch.load(os.path.join(tmp, "sharded.pt"))


def ref_serve(arch, B):
    """The reference's jitted ``build_serve_step`` over the same tokens ->
    (logits of every step, the final state as torch tensors)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as RST
    from repro.models import transformer as RT
    from repro_torch.tree import params_from_jax, tree_map

    cfg = ref_cfg(arch)
    fn = jax.jit(RST.build_serve_step(cfg, ref_mesh(), "decode_32k")[0])
    params = ref_params(arch)
    state = RT.init_decode_state(cfg, B, MAX_LEN, jnp.float32)
    toks = serve_tokens(arch, B)
    out = []
    for pos in range(STEPS):
        lg, state = fn(params, state, jnp.asarray(toks[pos]), jnp.int32(pos))
        out.append(np.asarray(lg))
    state = tree_map(lambda a: np.asarray(a, dtype=np.float32), state)
    return torch.from_numpy(np.stack(out)), params_from_jax(state, "cpu")


def check_serve(result, arch, B):
    """A serve result against ``ref_serve``: the logits within 2e-5 of
    the reference's at every step, each state leaf (the reference's as
    f32) within 1e-5 of its largest entry, and every rank's checks."""
    from repro_torch.tree import leaves

    logits, state, ok = result
    want, want_state = ref_serve(arch, B)
    assert ok
    assert logits.shape == want.shape
    for step in range(STEPS):
        assert rel(logits[step], want[step]) <= 2e-5, step
    got, ref = leaves(state), leaves(want_state)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):           # int8 caches, bf16 scales: as f32
        assert a.shape == b.shape
        assert rel(a.float(), b) <= 1e-5


def ref_prefill(arch):
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as RST
    fn = jax.jit(RST.build_prefill_step(ref_cfg(arch), ref_mesh())[0])
    lg = fn(ref_params(arch), {"tokens": jnp.asarray(prefill_tokens(arch))})
    return torch.from_numpy(np.array(lg))
