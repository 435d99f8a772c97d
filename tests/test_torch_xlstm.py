"""xLSTM in the port (the mLSTM's chunkwise and recurrent forms, the
sLSTM's loop over time, the xlstm-1.3b config) on the CPU against the JAX
reference.

Weights come from the reference's initializers through
``params_from_jax``; inputs and tokens from numpy with a seed.

Tolerances, each against the largest entry of what is compared: the
blocks' outputs and carried decode states 2e-5 in f32 (sums in another
order); the chunkwise form against the port's own recurrent form 1e-5;
bf16 blocks 3e-2 (``tests/test_torch_lm_kernels.py``'s bf16 limit: the
projections' bf16 roundings may differ by an ulp); gradients 1e-4 of each
leaf's largest.  The whole model: logits 2e-5, ``lm_loss`` 1e-5 relative
with remat on and off, gradients 1e-4, greedy ``serve()`` completions
identical, ``train()``'s losses 1e-4 with policy fields and events equal.
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
from repro.models import xlstm as RX
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.models import transformer as T
from repro_torch.models import xlstm as X
from repro_torch.tree import leaves, params_from_jax, unflatten

from test_torch_train import (RUN, _two_threads,  # noqa: F401  (fixture)
                              assert_losses_close, assert_policy_identical)

ARCH = "xlstm-1.3b"
D, HEADS = 256, 4
TOL = 2e-5
BF16_TOL = 3e-2
# the reference's tree at full width: 42 mLSTM and 6 sLSTM layers, the
# token embedding and the untied head (``param_counts()``'s estimate,
# 1,213,464,576, leaves out the sLSTM's block-diagonal recurrent weights
# and counts the biases otherwise)
FULL_PARAMS = 1_238_681_936


def _close_to_largest(got, want, tol, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err, tol)


def _block(kind, seed=0):
    """The reference's block parameters (numpy) and the port's copy."""
    init = RX.init_mlstm if kind == "mlstm" else RX.init_slstm
    tree = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), D, HEADS))
    return tree, params_from_jax(tree, "cpu")


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _dtypes(dtype):
    return getattr(jnp, dtype), getattr(torch, dtype)


# ---------------------------------------------------------------- config --
def test_config_copy_equals_the_reference():
    ref, port = ref_config(ARCH), get_config(ARCH)
    assert ARCH in list_archs()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert port.param_counts() == ref.param_counts()
    assert port.layer_kinds == ref.layer_kinds
    assert port.layer_kinds.count("mlstm") == 42
    assert port.layer_kinds.count("slstm") == 6
    full = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        jax.eval_shape(lambda: RT.init_model(ref, jax.random.PRNGKey(0)))))
    assert full == FULL_PARAMS
    d, hd, H = 2048, 512, HEADS
    mlstm = 5 * d * d + 2 * d * H + 2 * H + d          # and its norm
    slstm = 5 * d * d + 4 * H * hd * hd + 4 * d + d
    assert 42 * mlstm + 6 * slstm + 2 * 50304 * d + d == full


@pytest.mark.parametrize("layers", [2, 4])
def test_init_model_layout_matches_the_reference(layers):
    cfg_ref, cfg = _configs(num_layers=layers)
    want = [tuple(a.shape) for a in jax.tree.leaves(jax.eval_shape(
        lambda: RT.init_model(cfg_ref, jax.random.PRNGKey(0))))]
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in leaves(params)] == want
    for stage in params["stages"]:
        if "mlstm" in stage:
            assert (stage["mlstm"]["bf"] == 3.0).all()
        else:
            p = stage["slstm"]
            assert (p["bf"] == 2.0).all() and not p["bz"].any()
            # dense_init over fan-in hd, times 0.1
            assert p["rz"].abs().max() <= 0.1 / np.sqrt(D // HEADS)


# ---------------------------------------------------------------- blocks --
@pytest.mark.parametrize("dtype,chunk", [("float32", 16), ("float32", 64),
                                         ("bfloat16", 16)])
def test_mlstm_forward_matches_the_reference(dtype, chunk):
    """S = 64 in four chunks of 16 or one of 64."""
    jdt, tdt = _dtypes(dtype)
    tree, p = _block("mlstm")
    x = _x((2, 64, D))
    want = RX.mlstm_forward(tree, jnp.asarray(x, jdt), HEADS, chunk=chunk)
    got = X.mlstm_forward(p, torch.tensor(x).to(tdt), HEADS, chunk=chunk)
    assert got.dtype == tdt and got.shape == (2, 64, D)
    _close_to_largest(got, np.asarray(want.astype(jnp.float32)),
                      TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_matches_the_reference(dtype):
    jdt, tdt = _dtypes(dtype)
    tree, p = _block("slstm")
    x = _x((2, 48, D))
    want = RX.slstm_forward(tree, jnp.asarray(x, jdt), HEADS)
    got = X.slstm_forward(p, torch.tensor(x).to(tdt), HEADS)
    assert got.dtype == tdt and got.shape == (2, 48, D)
    _close_to_largest(got, np.asarray(want.astype(jnp.float32)),
                      TOL if dtype == "float32" else BF16_TOL)


def test_mlstm_chunkwise_form_equals_the_recurrent_form():
    """The port's chunkwise forward (4 chunks) against its own
    ``mlstm_decode`` run step by step from ``init_mlstm_state``."""
    _, p = _block("mlstm")
    x = torch.tensor(_x((2, 64, D), seed=2))
    want = X.mlstm_forward(p, x, HEADS, chunk=16)
    state = X.init_mlstm_state(D, HEADS, 2)
    for t in range(64):
        y, state = X.mlstm_decode(p, x[:, t:t + 1], state, HEADS)
        _close_to_largest(y[:, 0], want[:, t].numpy(), 1e-5, t)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_decode_matches_the_reference(kind):
    """8 decode steps carried from the initial state: outputs and every
    state leaf after each step."""
    tree, p = _block(kind)
    x = _x((2, 8, D), seed=3)
    if kind == "mlstm":
        rstate, state = RX.init_mlstm_state(D, HEADS, 2), \
            X.init_mlstm_state(D, HEADS, 2)
        rstep, step = RX.mlstm_decode, X.mlstm_decode
    else:
        rstate, state = RX.init_slstm_state(D, HEADS, 2), \
            X.init_slstm_state(D, HEADS, 2)
        rstep, step = RX.slstm_decode, X.slstm_decode
    for t in range(8):
        want, rstate = rstep(tree, jnp.asarray(x[:, t:t + 1]), rstate, HEADS)
        got, state = step(p, torch.tensor(x[:, t:t + 1]), state, HEADS)
        _close_to_largest(got, want, TOL, t)
        assert sorted(state) == sorted(rstate)
        for name in state:
            assert state[name].dtype == torch.float32
            _close_to_largest(state[name], rstate[name], TOL, (t, name))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_gradients_match_jax_grad(kind):
    """The input's and every parameter's gradient of <block(x), w> (the
    mLSTM over two chunks, each recomputed in the backward)."""
    tree, p = _block(kind)
    x, w = _x((2, 32, D), seed=4), _x((2, 32, D), seed=5)
    if kind == "mlstm":
        rfn = lambda q, a: RX.mlstm_forward(q, a, HEADS, chunk=16)  # noqa
        fn = lambda q, a: X.mlstm_forward(q, a, HEADS, chunk=16)    # noqa
    else:
        rfn = lambda q, a: RX.slstm_forward(q, a, HEADS)            # noqa
        fn = lambda q, a: X.slstm_forward(q, a, HEADS)              # noqa
    want_p, want_x = jax.grad(
        lambda q, a: jnp.sum(rfn(q, a) * w), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    live = [t.detach().requires_grad_(True) for t in leaves(p)]
    xt = torch.tensor(x, requires_grad=True)
    (fn(unflatten(p, live), xt) * torch.tensor(w)).sum().backward()
    _close_to_largest(xt.grad, want_x, 1e-4, "x")
    want_leaves = jax.tree.leaves(want_p)
    assert len(want_leaves) == len(live)
    for t, g in zip(live, want_leaves):
        assert bool(t.grad.abs().max() > 0)
        _close_to_largest(t.grad, g, 1e-4, t.shape)


# ----------------------------------------------------------------- model --
def _configs(**changes):
    return (dataclasses.replace(ref_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def _params(cfg_ref, seed=0):
    tree = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(seed)))
    return tree, params_from_jax(tree, "cpu")


# the reduced (mlstm, slstm) stack, and 4 layers: each stage stacked R = 2
LAYERS = [2, 4]


@pytest.mark.parametrize("layers", LAYERS)
def test_forward_matches_the_reference(layers):
    cfg_ref, cfg = _configs(num_layers=layers)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64))
    want, want_aux = RT.forward(tree, {"tokens": jnp.asarray(toks)}, cfg_ref)
    got, aux = T.forward(params, {"tokens": torch.tensor(toks)}, cfg)
    assert got.shape == (2, 64, cfg.vocab_size)
    assert float(aux) == float(want_aux) == 0.0
    _close_to_largest(got, want, TOL)


@pytest.mark.parametrize("layers", LAYERS)
def test_lm_loss_and_gradients_match_the_reference(layers):
    """S = 48 (one mLSTM chunk); the loss with remat off and on, every
    gradient leaf with remat off."""
    cfg_ref, cfg = _configs(num_layers=layers)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 48))
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, {"tokens": jnp.asarray(toks)}, cfg_ref),
        has_aux=True))(tree)
    want_remat, _ = RT.lm_loss(tree, {"tokens": jnp.asarray(toks)}, cfg_ref,
                               remat=True)
    for remat in (False, True):
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        got, _ = T.lm_loss(unflatten(params, live),
                           {"tokens": torch.tensor(toks)}, cfg, remat=remat)
        w = float(want_remat if remat else want)
        assert abs(got.item() - w) <= 1e-5 * abs(w), (remat, got.item(), w)
        if not remat:
            got.backward()
            want_leaves = jax.tree.leaves(want_g)
            assert len(want_leaves) == len(live)
            for t, g in zip(live, want_leaves):
                assert t.grad is not None and t.grad.shape == g.shape
                _close_to_largest(t.grad, g, 1e-4, t.shape)


@pytest.mark.parametrize("layers", LAYERS)
def test_decode_starts_from_each_layers_initial_state(layers):
    """16 ``decode_step``s against the reference's and against the port's
    own prefill: logits within 2e-5 of the largest.  The stacked decode
    state must hold each layer's initial values (the mLSTM's m = -1e30,
    the sLSTM's n = 1); zeros in their place put the logits ~0.6 off."""
    cfg_ref, cfg = _configs(num_layers=layers)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16))
    state = T.init_decode_state(cfg, 2, 16, torch.float32, "cpu")
    R = layers // 2
    assert (state["stages"][0]["m"] == -1e30).all()
    assert (state["stages"][1]["n"] == 1.0).all()
    assert state["stages"][0]["C"].shape == (R, 2, HEADS, 64, 64)
    rstate = RT.init_decode_state(cfg_ref, 2, 16, jnp.float32)
    step = jax.jit(lambda p, s, t, i: RT.decode_step(p, s, t, i, cfg_ref))
    full, _ = T.forward(params, {"tokens": torch.tensor(toks)}, cfg)
    for i in range(16):
        want, rstate = step(tree, rstate, jnp.asarray(toks[:, i]),
                            jnp.int32(i))
        got, state = T.decode_step(params, state, torch.tensor(toks[:, i]), i,
                                   cfg)
        _close_to_largest(got, want, TOL, i)
        _close_to_largest(got, full[:, i].numpy(), TOL, i)
    for g, w in zip(leaves(state), jax.tree.leaves(rstate)):
        _close_to_largest(g, w, TOL)


def test_serve_greedy_completions_equal_the_reference():
    cfg_ref, cfg = _configs()
    reqs = ref_serve.make_requests(4, 12, cfg.vocab_size, seed=0)
    want, wstats = ref_serve.serve(cfg_ref, reqs, batch=2, gen=8, seed=0)
    _, params = _params(cfg_ref)
    got, stats = port_serve.serve(cfg, reqs, batch=2, gen=8, seed=0,
                                  params=params, device="cpu")
    assert got == want
    for key in ("tokens", "steps", "refills"):
        assert stats[key] == wstats[key]


@pytest.mark.parametrize("mode", ["cpr-mfu", "cpr-ssu"])
def test_train_matches_the_reference(mode):
    """6 steps (S = 64: one mLSTM chunk) with 2 failures: the losses
    within 1e-4 of the reference's, policy fields and events equal."""
    cfg_ref, cfg = _configs()
    _, ref = ref_train.train(cfg_ref, mode=mode, **RUN)
    init = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(0)))
    _, port = port_train.train(cfg, mode=mode, device="cpu", params=init,
                               **RUN)
    assert_policy_identical(ref["report"], port["report"])
    assert port["report"]["n_failures"] == 2
    assert_losses_close(ref, port)
    assert [e[:2] for e in port["events"]] == [e[:2] for e in ref["events"]]
