"""The Qwen/Phi families in the port (QKV biases, the MoE layer kind) on
the CPU against the JAX reference, at their ``reduced()`` configs.

Archs: qwen2-7b and qwen2.5-14b (dense, QKV biases), phi3-medium-14b
(dense, no bias), qwen2-moe-a2.7b (MoE with a shared expert, QKV biases)
and qwen3-moe-30b-a3b (MoE, GQA 4:2 here, no bias).  Weights come from the
reference's ``init_model`` through ``params_from_jax``, with the QKV biases
drawn from numpy (the reference starts them at zero, which would not test
them); tokens from numpy with a seed; everything is f32.

Tolerances: logits and decode logits 2e-5 of the largest (f32 sums in
another order); the aux loss 1e-6 relative (its router products are f32
sums in another order, so it differs from the reference's in the last
bits); ``lm_loss`` 1e-5 relative; each gradient leaf 1e-4 of its largest
entry.  ``serve()``'s greedy completions are identical, and ``train()``'s
losses agree within 1e-4 with the policy fields equal, as
``tests/test_torch_train.py`` holds them for RecurrentGemma.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.launch import train as ref_train
from repro.models import transformer as RT
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, params_from_jax, unflatten

from test_torch_train import (RUN, _two_threads,  # noqa: F401  (fixture)
                              assert_losses_close, assert_policy_identical)

ARCHS = ["qwen2-7b", "qwen2.5-14b", "phi3-medium-14b", "qwen2-moe-a2.7b",
         "qwen3-moe-30b-a3b"]
TOL = 2e-5
# the reference's totals (ModelConfig.param_counts at full width)
PARAMS = {"qwen2-moe-a2.7b": 14_315_732_992,
          "qwen3-moe-30b-a3b": 30_532_108_288,
          "qwen2-7b": 7_615_612_928, "qwen2.5-14b": 14_770_028_544,
          "phi3-medium-14b": 14_659_502_080}


def _configs(arch, **changes):
    return (dataclasses.replace(ref_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _params(cfg_ref, seed=0):
    """The reference's tree (numpy leaves), QKV biases drawn from numpy,
    and the port's copy of it."""
    tree = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for stage in list(tree["stages"]) + list(tree["rest"]):
        for name in ("bq", "bk", "bv"):
            if name in stage["attn"]:
                a = stage["attn"][name]
                stage["attn"][name] = (rng.normal(size=a.shape) * 0.5
                                       ).astype(np.float32)
    return tree, params_from_jax(tree, "cpu")


def _close_to_largest(got, want, tol, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err, tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_equals_the_reference(arch):
    ref, port = ref_config(arch), get_config(arch)
    assert arch in list_archs()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert port.param_counts() == ref.param_counts()
    assert port.param_counts()["total"] == PARAMS[arch]
    assert port.active_param_count() == ref.active_param_count()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_layout_matches_the_reference(arch):
    cfg_ref, cfg = _configs(arch)
    want = [tuple(a.shape) for a in jax.tree.leaves(jax.eval_shape(
        lambda: RT.init_model(cfg_ref, jax.random.PRNGKey(0))))]
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in leaves(params)] == want
    if cfg.qkv_bias:      # zero, as the reference starts them
        assert not params["stages"][0]["attn"]["bq"].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_aux_match_the_reference(arch):
    cfg_ref, cfg = _configs(arch)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    want, want_aux = RT.forward(tree, {"tokens": jnp.asarray(toks)}, cfg_ref)
    got, aux = T.forward(params, {"tokens": torch.tensor(toks)}, cfg)
    assert got.shape == (2, 64, cfg.vocab_size)
    _close_to_largest(got, want, TOL)
    if cfg.moe is None:
        assert float(aux) == float(want_aux) == 0.0
    else:
        assert float(want_aux) > 0
        assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_the_reference(arch):
    cfg_ref, cfg = _configs(arch)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48))
    (want, (want_ce, want_aux)), want_g = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, {"tokens": jnp.asarray(toks)}, cfg_ref,
                             use_flash=False), has_aux=True))(tree)
    live = [t.requires_grad_(True) for t in leaves(params)]
    got, (got_ce, aux) = T.lm_loss(unflatten(params, live),
                                   {"tokens": torch.tensor(toks)}, cfg)
    got.backward()
    for g, w in ((got, want), (got_ce, want_ce)):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w))
    assert abs(aux.item() - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(live)
    for t, w in zip(live, want_leaves):
        assert t.grad is not None and t.grad.shape == w.shape
        _close_to_largest(t.grad, w, 1e-4, t.shape)


DECODE = {arch: (arch, {}) for arch in ARCHS}
# int8 KV: the reference's per-(token, head) scale and rounding
DECODE["phi3-int8"] = ("phi3-medium-14b", {"kv_cache_dtype": "int8"})


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_step_matches_the_reference(name):
    """16 teacher-forced ``decode_step``s (f32 state, as ``serve`` holds
    it): logits within 2e-5 of the largest at every step, and every cache
    leaf after the last within 2e-5 of its largest.  phi3's int8 KV cache
    against the reference's int8 decode: the int8 keys and values and
    their bf16 scales equal exactly (the same round-half-to-even of keys
    and values that agree to f32 rounding; none of these sits within an
    ulp of a rounding boundary), so the attention reads the same
    dequantized cache and the logits keep the f32 limit of 2e-5."""
    arch, changes = DECODE[name]
    cfg_ref, cfg = _configs(arch, **changes)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    rstate = RT.init_decode_state(cfg_ref, 2, 16, jnp.float32)
    state = T.init_decode_state(cfg, 2, 16, torch.float32, "cpu")
    step = jax.jit(lambda p, s, t, i: RT.decode_step(p, s, t, i, cfg_ref))
    for i in range(16):
        want, rstate = step(tree, rstate, jnp.asarray(toks[:, i]),
                            jnp.int32(i))
        got, state = T.decode_step(params, state, torch.tensor(toks[:, i]), i,
                                   cfg)
        _close_to_largest(got, want, TOL, i)
    for g, w in zip(leaves(state), jax.tree.leaves(rstate)):
        if "int8" in name and g.dtype != torch.float32:   # values, scales
            assert g.dtype in (torch.int8, torch.bfloat16)
            np.testing.assert_array_equal(g.float().numpy(),
                                          np.asarray(w, np.float32))
        else:
            _close_to_largest(g, w, TOL)


def _remat_grads(params, toks, cfg, remat):
    live = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    loss, (_, aux) = T.lm_loss(unflatten(params, live), {"tokens": toks}, cfg,
                               remat=remat)
    loss.backward()
    return loss.detach(), aux.detach(), [t.grad for t in live]


@pytest.mark.parametrize("layers", [4, 20])
def test_remat_carries_the_moe_aux_loss(layers):
    """An MoE stack recomputed by repetition (4 layers: one level) and in
    groups (20 layers: G = 4 groups of 5) gives the loss, the aux loss and
    every gradient (the router's aux term among them) of the run that
    keeps every activation, and the reference's remat loss."""
    cfg_ref, cfg = _configs("qwen2-moe-a2.7b", num_layers=layers, d_model=64,
                            num_heads=2, num_kv_heads=2, head_dim=32,
                            vocab_size=128)
    assert T._remat_groups(layers) == (1 if layers == 4 else 4)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 24))
    l0, a0, g0 = _remat_grads(params, torch.tensor(toks), cfg, False)
    l1, a1, g1 = _remat_grads(params, torch.tensor(toks), cfg, True)
    assert float(a0) > 0 and torch.equal(a0, a1) and torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    want, _ = RT.lm_loss(tree, {"tokens": jnp.asarray(toks)}, cfg_ref,
                         remat=True)
    assert abs(float(l1) - float(want)) <= 1e-5 * abs(float(want))


def test_serve_greedy_completions_equal_the_reference():
    """qwen2-moe: four requests of 4..12 tokens, two batches of two, the
    decode path's MoE at capacity T (lossless), as the reference's."""
    cfg_ref, cfg = _configs("qwen2-moe-a2.7b")
    reqs = ref_serve.make_requests(4, 12, cfg.vocab_size, seed=0)
    want, wstats = ref_serve.serve(cfg_ref, reqs, batch=2, gen=8, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, RT.init_model(
        cfg_ref, jax.random.PRNGKey(0))), "cpu")
    got, stats = port_serve.serve(cfg, reqs, batch=2, gen=8, seed=0,
                                  params=params, device="cpu")
    assert got == want
    for key in ("tokens", "steps", "refills"):
        assert stats[key] == wstats[key]


def test_train_matches_the_reference():
    """qwen2-moe in ``cpr-mfu`` over 6 steps with 2 failures: the loss the
    step logs (cross-entropy + the MoE aux) within 1e-4 of the
    reference's, policy fields and events equal."""
    cfg_ref, cfg = _configs("qwen2-moe-a2.7b")
    _, ref = ref_train.train(cfg_ref, mode="cpr-mfu", **RUN)
    init = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(0)))
    _, port = port_train.train(cfg, mode="cpr-mfu", device="cpu",
                               params=init, **RUN)
    assert_policy_identical(ref["report"], port["report"])
    assert_losses_close(ref, port)
    assert [e[:2] for e in port["events"]] == [e[:2] for e in ref["events"]]
