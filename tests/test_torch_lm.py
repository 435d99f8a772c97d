"""The port's LM serving path (configs, prefill ``forward``, ``decode_step``,
``serve``) on the CPU against the JAX reference.

Weights come from the reference's ``init_model`` through
``params_from_jax``; tokens from numpy with a seed.  Everything runs in
f32 (``reduced()`` configs are f32).  Tolerances: logits and decode states
2e-5 absolute and relative (f32 summation order; logits reach ~7); int8
KV caches exactly; greedy completions identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import transformer as RT
from repro_torch.configs import base as port_base
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as port_serve
from repro_torch.models import transformer as T
from repro_torch.tree import leaves

TOL = 2e-5
R, LOC = port_base.RECURRENT, port_base.LOCAL_ATTN


def _variant(arch, **changes):
    """The reduced config of ``arch`` with ``changes``, in both packages."""
    ref = dataclasses.replace(ref_config(arch).reduced(), **changes)
    port = dataclasses.replace(get_config(arch).reduced(), **changes)
    return ref, port


VARIANTS = {
    # MQA (4 query heads, 1 KV head), window 64 below S = 128
    "recurrentgemma": ("recurrentgemma-2b", {}),
    # pattern (R, R, L) over 5 layers: one scanned stage and a 2-layer rest
    "recurrentgemma-5l": ("recurrentgemma-2b",
                          {"num_layers": 5, "block_pattern": (R, R, LOC)}),
    # softcaps, local + global attention, GQA 4:2 (reduced() keeps 4:4)
    "gemma2-gqa": ("gemma2-2b", {"num_kv_heads": 2}),
}


def _params(cfg_ref, seed=0):
    tree = RT.init_model(cfg_ref, jax.random.PRNGKey(seed))
    return tree, T.params_from_jax(jax.tree.map(np.asarray, tree),
                                   device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "gemma2-2b"])
def test_config_copies_equal_the_reference(arch):
    from repro.configs import base as ref_base
    ref, port = ref_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert port.layer_kinds == ref.layer_kinds
    assert port.param_counts() == ref.param_counts()
    assert port.subquadratic == ref.subquadratic
    assert {k: dataclasses.asdict(v) for k, v in
            port_base.INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_base.INPUT_SHAPES.items()}
    assert set(list_archs()) == {"recurrentgemma-2b", "gemma2-2b",
                                 "qwen2-7b", "qwen2.5-14b", "phi3-medium-14b",
                                 "qwen2-moe-a2.7b", "qwen3-moe-30b-a3b",
                                 "qwen2-vl-72b", "hubert-xlarge",
                                 "xlstm-1.3b"}


# ---------------------------------------------------------------- prefill --
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_both_reference_branches(name):
    """``forward`` logits against the reference with ``use_flash=False``
    (its masked / chunked softmax) and ``use_flash=True`` (its Pallas
    kernel, interpret mode), at S = 128."""
    arch, changes = VARIANTS[name]
    cfg_ref, cfg = _variant(arch, **changes)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 128))
    got, aux = T.forward(params, {"tokens": torch.tensor(toks)}, cfg)
    assert got.shape == (2, 128, cfg.vocab_size) and float(aux) == 0.0
    for use_flash in (False, True):
        want, _ = RT.forward(tree, {"tokens": jnp.asarray(toks)}, cfg_ref,
                             use_flash=use_flash)
        _close(got, want)


def test_forward_hidden_and_positions():
    cfg_ref, cfg = _variant("recurrentgemma-2b")
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 32))
    want, _ = RT.forward_hidden(tree, {"tokens": jnp.asarray(toks)}, cfg_ref)
    batch = {"tokens": torch.tensor(toks),
             "positions": torch.arange(32)[None].expand(2, 32)}
    got, _ = T.forward_hidden(params, batch, cfg)
    _close(got, want)
    # other positions rotate by their values, the mask by index: the
    # reference's kernel branch
    batch["positions"] = batch["positions"] + 1
    want, _ = RT.forward_hidden(tree, {"tokens": jnp.asarray(toks),
                                       "positions": jnp.asarray(
                                           batch["positions"].numpy())},
                                cfg_ref, use_flash=True)
    got, _ = T.forward_hidden(params, batch, cfg)
    _close(got, want)


def test_later_slices_raise():
    """No layer kind raises any more (the xLSTM slice was the last): a
    one-kind model of every kind, and M-RoPE, bidirectional attention, the
    front ends and QKV biases, build at ``reduced()`` and run one forward
    to finite logits of the right shape."""
    base = get_config("gemma2-2b").reduced()
    cfgs = [dataclasses.replace(base, block_pattern=(kind,))
            for kind in T.KINDS if kind != port_base.MOE]
    cfgs += [dataclasses.replace(base, **changes) for changes in (
        {"mrope": True}, {"causal": False}, {"modality_frontend": "vision"},
        {"qkv_bias": True})]
    cfgs += [get_config(a).reduced() for a in ("hubert-xlarge",
                                               "qwen2-moe-a2.7b",
                                               "xlstm-1.3b")]
    assert {k for c in cfgs for k in c.layer_kinds} == set(T.KINDS)
    rng = np.random.default_rng(0)
    for cfg in cfgs:
        params = T.init_model(cfg, device="cpu")
        if cfg.modality_frontend == "audio":
            batch = {"embeds": torch.tensor(rng.normal(
                size=(2, 16, cfg.d_model)).astype(np.float32))}
        else:
            batch = {"tokens": torch.tensor(rng.integers(
                0, cfg.vocab_size, (2, 16)))}
        logits, _ = T.forward(params, batch, cfg)
        assert logits.shape == (2, 16, cfg.vocab_size), cfg.layer_kinds
        assert bool(torch.isfinite(logits).all()), cfg.layer_kinds


def test_init_model_layout_matches_the_reference():
    """The port's own ``init_model`` builds the reference's tree: the same
    leaves with the same shapes, in the same order."""
    cfg_ref, cfg = _variant("recurrentgemma-2b", num_layers=5,
                            block_pattern=(R, R, LOC))
    want = [tuple(a.shape) for a in jax.tree.leaves(jax.eval_shape(
        lambda: RT.init_model(cfg_ref, jax.random.PRNGKey(0))))]
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert [tuple(t.shape) for t in leaves(params)] == want
    assert T.param_count(params) == sum(int(np.prod(s)) for s in want)


# ----------------------------------------------------------------- decode --
DECODE = {
    # window 8 over 16 steps: the local layers' ring buffer wraps
    "recurrentgemma-ring": ("recurrentgemma-2b", {"sliding_window": 8}),
    "recurrentgemma-int8": ("recurrentgemma-2b", {"kv_cache_dtype": "int8"}),
    "gemma2-gqa": ("gemma2-2b", {"num_kv_heads": 2}),
}


@pytest.mark.parametrize("name", list(DECODE))
def test_decode_step_matches_the_reference(name):
    """16 teacher-forced ``decode_step``s: logits and every state leaf after
    each step (f32 state, as ``serve`` holds it)."""
    arch, changes = DECODE[name]
    cfg_ref, cfg = _variant(arch, **changes)
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
        _close(got, want)
        for g, w in zip(leaves(state), jax.tree.leaves(rstate)):
            w = np.asarray(w)
            g = g.numpy() if g.dtype == torch.int8 else g.float().numpy()
            if w.dtype == np.int8:
                np.testing.assert_array_equal(g, w)
            else:
                np.testing.assert_allclose(np.asarray(g, np.float32),
                                           w.astype(np.float32), rtol=TOL,
                                           atol=TOL)


def test_decode_matches_prefill():
    """The port's own decode path against its prefill path (the
    reference's ``test_reduced_decode_matches_prefill``, at its
    tolerance)."""
    cfg_ref, cfg = _variant("recurrentgemma-2b")
    _, params = _params(cfg_ref)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 16)))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, 2, 16, torch.float32, "cpu")
    for i in range(16):
        logits, state = T.decode_step(params, state, toks[:, i], i, cfg)
        np.testing.assert_allclose(logits.numpy(), full[:, i].numpy(),
                                   rtol=2e-2, atol=2e-3)


# ------------------------------------------------------------------ serve --
def test_serve_greedy_completions_equal_the_reference():
    """Four requests of 4..12 tokens, two batches of two: the reference's
    ``serve`` (its own ``init_model`` from the seed) and the port's with
    the same weights carried across."""
    cfg_ref, cfg = _variant("recurrentgemma-2b")
    reqs = ref_serve.make_requests(4, 12, cfg.vocab_size, seed=0)
    assert all((a == b).all() for a, b in zip(
        reqs, port_serve.make_requests(4, 12, cfg.vocab_size, seed=0)))
    want, wstats = ref_serve.serve(cfg_ref, reqs, batch=2, gen=8, seed=0)
    _, params = _params(cfg_ref, seed=0)
    got, stats = port_serve.serve(cfg, reqs, batch=2, gen=8, seed=0,
                                  params=params, device="cpu")
    assert got == want
    assert all(len(c) == 8 for c in got.values())
    for key in ("tokens", "steps", "refills"):
        assert stats[key] == wstats[key]
    assert set(stats) == set(wstats)


def test_serve_samples_with_its_own_generator():
    cfg = get_config("recurrentgemma-2b").reduced()
    reqs = port_serve.make_requests(3, 6, cfg.vocab_size, seed=1)
    a, _ = port_serve.serve(cfg, reqs, batch=2, gen=4, greedy=False, seed=5,
                            device="cpu")
    b, _ = port_serve.serve(cfg, reqs, batch=2, gen=4, greedy=False, seed=5,
                            device="cpu")
    assert a == b and sorted(a) == [0, 1, 2]
    assert all(0 <= t < cfg.vocab_size for c in a.values() for t in c)
