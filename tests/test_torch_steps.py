"""The port's step builders (``repro_torch.launch.steps``) against the
reference's jitted ones (``tests/test_torch_shard_step.py`` holds the
sharded train step on 8 gloo ranks).

* prefill and serve steps, ``reduced()`` gemma2-2b, recurrentgemma-2b,
  qwen3-moe-30b-a3b and xlstm-1.3b in f32: logits within 2e-5 of their
  largest (16 serve steps);
* ``build_train_step`` with Adam at f32, microbatches 1 and 2: ``loss``,
  ``nll``, ``aux`` within 1e-5 relative, the gradients within 1e-4 of their
  largest, leaf by leaf, read as Adam's first moment (0.1 of the gradient
  after one step, before its update amplifies sign noise in tiny
  gradients); with ``bf16_forward`` the repo's bf16 limit, 3e-2 of the
  largest, for both (bf16 products and casts in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import steps as RST
from repro.launch.mesh import make_host_mesh as ref_host_mesh
from repro.models import transformer as RT
from repro.optim.optimizers import get_optimizer as ref_optimizer
from repro_torch.configs import get_config
from repro_torch.launch import steps as ST
from repro_torch.models import transformer as T
from repro_torch.optim.optimizers import get_optimizer
from repro_torch.sharding import specs as S
from repro_torch.tree import leaves, params_from_jax

HOST = S.MeshShape(("data", "model"), (1, 1))
B, SEQ = 4, 32


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _setup(arch):
    cfg, rcfg = get_config(arch).reduced(), ref_config(arch).reduced()
    rp = RT.init_model(rcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, SEQ),
                                             dtype=np.int32)
    return cfg, rcfg, rp, toks


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b",
                                  "qwen3-moe-30b-a3b", "xlstm-1.3b"])
def test_prefill_and_serve_steps_match_reference(arch):
    cfg, rcfg, rp, toks = _setup(arch)
    mesh = ref_host_mesh()
    rfn, _, _ = RST.build_prefill_step(rcfg, mesh)
    fn, _, p_sp = ST.build_prefill_step(cfg, HOST)
    params = params_from_jax(rp, "cpu")
    want = jax.jit(rfn)(rp, {"tokens": jnp.asarray(toks)})
    got = fn(params, {"tokens": torch.from_numpy(toks)})
    assert _rel(got.detach(), want) <= 2e-5
    assert len(leaves(p_sp)) == len(leaves(params))

    rserve, _, _, _, _ = RST.build_serve_step(rcfg, mesh, "decode_32k")
    serve, _, s_st, _, s_sp = ST.build_serve_step(cfg, HOST, "decode_32k")
    assert len(leaves(s_sp)) == len(leaves(s_st))
    rstate = RT.init_decode_state(rcfg, B, SEQ, jnp.float32)
    state = T.init_decode_state(cfg, B, SEQ, torch.float32, "cpu")
    rstep = jax.jit(rserve)
    with torch.no_grad():
        for i in range(16):
            want, rstate = rstep(rp, rstate, jnp.asarray(toks[:, i]),
                                 jnp.int32(i))
            got, state = serve(params, state, torch.from_numpy(toks[:, i]), i)
            assert _rel(got, want) <= 2e-5, i


@pytest.mark.parametrize("arch,microbatches,bf16", [
    ("gemma2-2b", 1, False), ("gemma2-2b", 2, False),
    ("qwen3-moe-30b-a3b", 2, False), ("gemma2-2b", 2, True)])
def test_train_step_matches_reference(arch, microbatches, bf16):
    cfg, rcfg, rp, toks = _setup(arch)
    rfn, _, _, _, _ = RST.build_train_step(
        rcfg, ref_host_mesh(), optimizer="adam", bf16_forward=bf16,
        microbatches=microbatches)
    fn, p_st, _, p_sp, o_sp = ST.build_train_step(
        cfg, HOST, optimizer="adam", bf16_forward=bf16,
        microbatches=microbatches)
    assert [tuple(t.shape) for t in leaves(p_st)] == \
        [tuple(a.shape) for a in jax.tree_util.tree_leaves(rp)]
    _, r_opt, r_met = jax.jit(rfn)(
        rp, ref_optimizer("adam", 3e-4).init(rp), {"tokens": jnp.asarray(toks)})
    params = params_from_jax(rp, "cpu")
    _, opt, met = fn(params, get_optimizer("adam", 3e-4).init(params),
                     {"tokens": torch.from_numpy(toks)})
    loss_tol, grad_tol = (1e-2, 3e-2) if bf16 else (1e-5, 1e-4)
    for k in ("loss", "nll"):
        assert abs(float(met[k]) - float(r_met[k])) <= \
            loss_tol * abs(float(r_met[k])), k
    assert abs(float(met["aux"]) - float(r_met["aux"])) <= \
        loss_tol * max(abs(float(r_met["aux"])), 1e-30)
    if cfg.moe is not None:
        assert float(met["aux"]) > 0
    assert int(opt["t"]) == 1
    for got, want in zip(leaves(opt["m"]), jax.tree_util.tree_leaves(
            r_opt["m"])):
        assert _rel(got, want) <= grad_tol
