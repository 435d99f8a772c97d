"""Qwen2-VL in the port (M-RoPE, the patch-embedding front end, positions
other than ``arange(S)``) on the CPU against the JAX reference, and plain
RoPE at shifted positions.

The config is the reference's ``qwen2-vl-72b`` at ``reduced()`` (d 256, 4
heads of 64, M-RoPE sections (8, 12, 12)).  Weights come from the
reference's ``init_model`` through ``params_from_jax``, the QKV biases
drawn from numpy (the reference starts them at zero, which would not test
them); tokens, patch embeddings and positions from numpy with a seed;
everything is f32.

The image layout is Qwen2-VL's: text before the image has t = h = w =
its index; the image's patches (a grid of rows x columns after the 2 x 2
merge) take t = the image's start and h, w = start + row, start + column;
text after it resumes at the largest position + 1.  Where positions are
not ``arange(S)`` the port masks by index (query i sees key j <= i), as
the reference's kernel branch (``use_flash=True``) and Qwen2-VL do, so it
is held against that branch there; the reference's jnp branch masks by
the t stream.

Tolerances (``PERF.md`` section 2): logits 2e-5 of the largest, rotated
values 1e-5, ``lm_loss`` 1e-5 relative, each gradient leaf 1e-4 of its
largest entry; greedy completions identical.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import layers as RL
from repro.models import transformer as RT
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as port_serve
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, params_from_jax, unflatten

from test_torch_cuda import image_positions

ARCH = "qwen2-vl-72b"
TOL = 2e-5
S = 128
IMAGE = (16, 8, 8)          # start, grid rows, grid columns (64 patches)


def _configs(arch=ARCH, **changes):
    return (dataclasses.replace(ref_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


def _params(cfg_ref, seed=0):
    """The reference's tree (numpy leaves), QKV biases drawn from numpy,
    and the port's copy of it."""
    tree = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    for layer in list(tree["stages"]) + list(tree["rest"]):
        for name in ("bq", "bk", "bv"):
            a = layer["attn"][name]
            layer["attn"][name] = (rng.normal(size=a.shape) * 0.5
                                   ).astype(np.float32)
    return tree, params_from_jax(tree, "cpu")


def image_batch(cfg, seed, B=2):
    """Tokens, one image's patch embeddings scattered at its place, and
    the image-layout positions (numpy)."""
    rng = np.random.default_rng(seed)
    start, rows, cols = IMAGE
    n = rows * cols
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
            "patch_embeds": rng.normal(size=(B, n, cfg.d_model)
                                       ).astype(np.float32),
            "patch_positions": np.broadcast_to(start + np.arange(n),
                                               (B, n)).copy(),
            "positions": np.broadcast_to(image_positions(S, *IMAGE),
                                         (B, 3, S)).transpose(1, 0, 2).copy()}


def _close_to_largest(got, want, tol, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err, tol)


def test_config_copy_equals_the_reference():
    ref, port = ref_config(ARCH), get_config(ARCH)
    assert ARCH in list_archs()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(
        ref.reduced())
    assert port.param_counts() == ref.param_counts()
    # the card's cell: full width, 4 of 80 layers
    cut = dataclasses.replace(port, num_layers=4)
    assert cut.param_counts()["total"] == 6_002_155_520


@pytest.mark.parametrize("hd", [16, 64, 80, 128, 256])
def test_mrope_sections_match_the_reference(hd):
    assert L.mrope_sections(hd) == RL.mrope_sections(hd)
    assert sum(L.mrope_sections(hd)) == hd // 2


@pytest.mark.parametrize("hd,layout", [(64, "random"), (128, "random"),
                                       (128, "image")])
def test_apply_mrope_matches_the_reference(hd, layout):
    """Random (3, B, S) streams up to 10,000, and the image layout."""
    rng = np.random.default_rng(hd)
    x = rng.normal(size=(2, S, 4, hd)).astype(np.float32)
    if layout == "random":
        pos = rng.integers(0, 10_000, (3, 2, S))
    else:
        pos = np.broadcast_to(image_positions(S, *IMAGE)[:, None], (3, 2, S))
    sections = L.mrope_sections(hd)
    got = L.apply_mrope(torch.tensor(x), torch.tensor(pos), 1e6, sections)
    want = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_with_an_image_matches_the_reference_kernel_branch():
    """Patch embeddings scattered into the tokens, image-layout positions:
    logits within 2e-5 of the largest of the reference's
    ``use_flash=True`` (its Pallas kernel, interpret mode)."""
    cfg_ref, cfg = _configs()
    tree, params = _params(cfg_ref)
    batch = image_batch(cfg, seed=1)
    got, aux = T.forward(params, {k: torch.tensor(v)
                                  for k, v in batch.items()}, cfg)
    assert got.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    want, _ = RT.forward(jax.tree.map(jnp.asarray, tree),
                         jax.tree.map(jnp.asarray, batch), cfg_ref,
                         use_flash=True)
    _close_to_largest(got, want, TOL)
    # the patches and the positions both reach the output
    text, _ = T.forward(params, {"tokens": torch.tensor(batch["tokens"])},
                        cfg)
    assert float((text - got).abs().max()) > 1e-3


@pytest.mark.parametrize("use_flash", [False, True], ids=["jnp", "pallas"])
def test_forward_on_text_matches_both_reference_branches(use_flash):
    """No positions given: ``arange(S)`` on all three streams (M-RoPE is
    then plain RoPE), where both branches mask alike."""
    cfg_ref, cfg = _configs()
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, S))
    got, _ = T.forward(params, {"tokens": torch.tensor(toks)}, cfg)
    want, _ = RT.forward(tree, {"tokens": jnp.asarray(toks)}, cfg_ref,
                         use_flash=use_flash)
    _close_to_largest(got, want, TOL)


def test_decode_step_matches_the_reference():
    """16 teacher-forced ``decode_step``s (M-RoPE at the broadcast
    position, f32 state): logits within 2e-5 of the largest at every step,
    every cache leaf after the last within 2e-5 of its largest."""
    cfg_ref, cfg = _configs()
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
        _close_to_largest(g, w, TOL)


def test_prefill_matches_decode_on_text():
    """The port's prefill (the attention kernel's path) and its decode
    (the cache) give the same logits at every position of a text prompt."""
    cfg_ref, cfg = _configs()
    _, params = _params(cfg_ref)
    toks = torch.tensor(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 48)))
    full, _ = T.forward(params, {"tokens": toks}, cfg)
    state = T.init_decode_state(cfg, 2, 48, torch.float32, "cpu")
    for i in range(48):
        logits, state = T.decode_step(params, state, toks[:, i], i, cfg)
        _close_to_largest(logits, full[:, i].numpy(), TOL, i)


def test_lm_loss_and_gradients_match_the_reference():
    """Next-token loss with an image's patch embeddings scattered in
    (``arange`` positions, where the reference's jnp branch, the one it
    differentiates, masks as the port does): the loss within 1e-5
    relative, every gradient leaf within 1e-4 of its largest entry."""
    cfg_ref, cfg = _configs()
    tree, params = _params(cfg_ref)
    batch = image_batch(cfg, seed=5)
    del batch["positions"]
    (want, _), want_g = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, jax.tree.map(jnp.asarray, batch), cfg_ref,
                             use_flash=False), has_aux=True))(tree)
    live = [t.requires_grad_(True) for t in leaves(params)]
    got, _ = T.lm_loss(unflatten(params, live),
                       {k: torch.tensor(v) for k, v in batch.items()}, cfg)
    got.backward()
    assert abs(got.item() - float(want)) <= 1e-5 * abs(float(want))
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(live)
    for t, w in zip(live, want_leaves):
        assert t.grad is not None and t.grad.shape == w.shape
        _close_to_largest(t.grad, w, 1e-4, t.shape)


@pytest.mark.parametrize("use_flash", [False, True], ids=["jnp", "pallas"])
@pytest.mark.parametrize("layout", ["shift", "stride"])
def test_plain_rope_at_other_positions_matches_the_reference(layout,
                                                             use_flash):
    """A plain-RoPE model (qwen2-7b, reduced) given positions
    ``arange(S) + 1`` (RoPE is relative: the logits of ``arange(S)``) or
    ``2 arange(S)`` (other logits): the rotation follows them; both
    branches agree here (these positions keep their order, so the jnp
    branch's position mask is the index mask)."""
    cfg_ref, cfg = _configs("qwen2-7b")
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, (2, S))
    pos = np.arange(S) + 1 if layout == "shift" else 2 * np.arange(S)
    pos = np.broadcast_to(pos, (2, S)).copy()
    got, _ = T.forward(params, {"tokens": torch.tensor(toks),
                                "positions": torch.tensor(pos)}, cfg)
    want, _ = RT.forward(tree, {"tokens": jnp.asarray(toks),
                                "positions": jnp.asarray(pos)}, cfg_ref,
                         use_flash=use_flash)
    _close_to_largest(got, want, TOL)
    at_zero, _ = T.forward(params, {"tokens": torch.tensor(toks)}, cfg)
    moved = float((at_zero - got).abs().max())
    assert moved > 1e-3 if layout == "stride" else moved < 1e-4


def test_serve_greedy_completions_equal_the_reference():
    """Text requests through ``serve()`` (decode rotates by M-RoPE at the
    broadcast position): the reference's completions and counts."""
    cfg_ref, cfg = _configs()
    reqs = ref_serve.make_requests(4, 12, cfg.vocab_size, seed=0)
    want, wstats = ref_serve.serve(cfg_ref, reqs, batch=2, gen=8, seed=0)
    params = params_from_jax(jax.tree.map(np.asarray, RT.init_model(
        cfg_ref, jax.random.PRNGKey(0))), "cpu")
    got, stats = port_serve.serve(cfg, reqs, batch=2, gen=8, seed=0,
                                  params=params, device="cpu")
    assert got == want
    for key in ("tokens", "steps", "refills"):
        assert stats[key] == wstats[key]
