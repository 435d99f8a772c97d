"""HuBERT X-Large in the port (the audio front end, bidirectional attention,
head dim 80, the masked-prediction loss) on the CPU against the JAX
reference.

Two configs: the reference's ``hubert-xlarge`` at ``reduced()`` (d 256, 4
heads of 64) and a variant at HuBERT's own head dim 80 (d 160, 2 heads),
the width the card's attention kernels take in 128-wide tiles.  Weights
come from the reference's ``init_model`` through ``params_from_jax``, with
the LayerNorm scales and biases drawn from numpy (the reference starts
them at one and zero, which would not test them); frame embeddings,
targets and HuBERT's span mask (``launch.profile_encoder.span_mask``)
from numpy with a seed; everything is f32.

Tolerances (``PERF.md`` section 2): logits 2e-5 of the largest (f32 sums
in another order); ``lm_loss`` 1e-5 relative; each gradient leaf 1e-4 of
its largest entry.  S = 128 is held against both reference branches (its
jnp softmax and its Pallas kernel in interpret mode); S = 200, ragged past
one 128-row block, against the jnp branch only: the Pallas wrapper needs
Sq to be a multiple of its block.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.models import transformer as RT
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as port_serve
from repro_torch.launch import train as port_train
from repro_torch.launch.profile_encoder import span_mask
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, params_from_jax, unflatten

ARCH = "hubert-xlarge"
TOL = 2e-5
VARIANTS = {"reduced": {},
            "hd80": {"d_model": 160, "num_heads": 2, "num_kv_heads": 2,
                     "head_dim": 80}}


def _configs(name):
    changes = VARIANTS[name]
    return (dataclasses.replace(ref_config(ARCH).reduced(), **changes),
            dataclasses.replace(get_config(ARCH).reduced(), **changes))


def _params(cfg_ref, seed=0):
    """The reference's tree (numpy leaves), its LayerNorm scales and biases
    drawn from numpy, and the port's copy of it."""
    tree = jax.tree.map(np.asarray,
                        RT.init_model(cfg_ref, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 100)
    norms = [layer[n] for layer in list(tree["stages"]) + list(tree["rest"])
             for n in ("norm1", "norm2")] + [tree["final_norm"]]
    for norm in norms:
        norm["scale"] = (1 + 0.2 * rng.normal(size=norm["scale"].shape)
                         ).astype(np.float32)
        norm["bias"] = (0.2 * rng.normal(size=norm["bias"].shape)
                        ).astype(np.float32)
    return tree, params_from_jax(tree, "cpu")


def _batch(cfg, S, seed, B=2):
    rng = np.random.default_rng(seed)
    return {"embeds": rng.normal(size=(B, S, cfg.d_model)).astype(np.float32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S)),
            "target_mask": span_mask(rng, B, S)}


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
    assert (port.head_dim, port.causal, port.modality_frontend) == (
        80, False, "audio")


@pytest.mark.parametrize("name", list(VARIANTS))
def test_init_model_layout_matches_the_reference(name):
    """No token embedding (the model takes frame embeddings), LayerNorms
    with biases, the reference's leaves and shapes in its order."""
    cfg_ref, cfg = _configs(name)
    want = jax.eval_shape(lambda: RT.init_model(cfg_ref,
                                                jax.random.PRNGKey(0)))
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    assert "embed" not in params and "embed" not in want
    assert set(params) == set(want)
    assert [tuple(t.shape) for t in leaves(params)] == [
        tuple(a.shape) for a in jax.tree.leaves(want)]
    assert set(params["final_norm"]) == {"scale", "bias"}
    assert params["stages"][0]["attn"]["wq"].shape[-1] == (
        cfg.num_heads * cfg.head_dim)


@pytest.mark.parametrize("S,use_flash", [(128, False), (128, True),
                                         (200, False)],
                         ids=["S128-jnp", "S128-pallas", "S200-jnp"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_forward_matches_the_reference(name, S, use_flash):
    """``forward`` over frame embeddings, bidirectional: logits within
    2e-5 of the largest; the aux loss 0."""
    cfg_ref, cfg = _configs(name)
    tree, params = _params(cfg_ref)
    batch = _batch(cfg, S, seed=1)
    got, aux = T.forward(params, {"embeds": torch.tensor(batch["embeds"])},
                         cfg)
    assert got.shape == (2, S, cfg.vocab_size) and float(aux) == 0.0
    want, _ = RT.forward(tree, {"embeds": jnp.asarray(batch["embeds"])},
                         cfg_ref, use_flash=use_flash)
    _close_to_largest(got, want, TOL)


def test_attention_is_bidirectional():
    """A frame's output depends on the frames after it (it would not
    under a causal mask): changing the last frame moves the first
    frame's logits."""
    cfg_ref, cfg = _configs("hd80")
    _, params = _params(cfg_ref)
    x = torch.tensor(_batch(cfg, 64, seed=2)["embeds"])
    a, _ = T.forward(params, {"embeds": x}, cfg)
    x[:, -1] = torch.flip(x[:, -1], [-1])    # (a shift alone LayerNorm undoes)
    b, _ = T.forward(params, {"embeds": x}, cfg)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


@pytest.mark.parametrize("name", list(VARIANTS))
def test_lm_loss_and_gradients_match_the_reference(name):
    """Masked prediction over a span mask (about half the frames): the
    loss within 1e-5 relative of ``jax.value_and_grad`` of the
    reference's (its jnp branch), every gradient leaf within 1e-4 of its
    largest entry."""
    cfg_ref, cfg = _configs(name)
    tree, params = _params(cfg_ref)
    batch = _batch(cfg, 128, seed=3)
    assert 0.2 < batch["target_mask"].mean() < 0.8
    (want, (want_ce, _)), want_g = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, jax.tree.map(jnp.asarray, batch), cfg_ref,
                             use_flash=False), has_aux=True))(tree)
    live = [t.requires_grad_(True) for t in leaves(params)]
    got, (got_ce, aux) = T.lm_loss(unflatten(params, live),
                                   {k: torch.tensor(v)
                                    for k, v in batch.items()}, cfg)
    got.backward()
    assert float(aux) == 0.0
    for g, w in ((got, want), (got_ce, want_ce)):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w))
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(live)
    for t, w in zip(live, want_leaves):
        assert t.grad is not None and t.grad.shape == w.shape
        _close_to_largest(t.grad, w, 1e-4, t.shape)


def test_lm_loss_weighs_only_the_masked_frames():
    """Unshifted targets where ``target_mask`` is set: the loss is the
    mean cross-entropy of those frames, and without a mask every frame
    counts."""
    cfg_ref, cfg = _configs("reduced")
    _, params = _params(cfg_ref)
    b = {k: torch.tensor(v) for k, v in _batch(cfg, 64, seed=4).items()}
    logits, _ = T.forward(params, {"embeds": b["embeds"]}, cfg)
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), b["targets"].reshape(-1),
        reduction="none").reshape(b["targets"].shape)
    m = b["target_mask"]
    loss, _ = T.lm_loss(params, b, cfg)
    assert abs(loss.item() - float((nll * m).sum() / m.sum())) <= 1e-5
    del b["target_mask"]
    loss, _ = T.lm_loss(params, b, cfg)
    assert abs(loss.item() - float(nll.mean())) <= 1e-5


def test_remat_gives_the_same_loss_and_gradients():
    cfg_ref, cfg = _configs("hd80")
    _, params = _params(cfg_ref)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 96, seed=5).items()}
    out = []
    for remat in (False, True):
        live = [t.detach().clone().requires_grad_(True)
                for t in leaves(params)]
        loss, _ = T.lm_loss(unflatten(params, live), batch, cfg, remat=remat)
        loss.backward()
        out.append((loss.detach(), [t.grad for t in live]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_serve_and_train_refuse_the_encoder(monkeypatch):
    """As in the reference, the serving CLI refuses an encoder-only model
    and the LM training driver a non-causal one."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--device",
                                      "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        port_serve.main()
    with pytest.raises(ValueError, match="causal text model"):
        port_train.train(get_config(ARCH).reduced(), steps=1, device="cpu")
