"""The port's LM training gradients on the CPU against the JAX reference.

* the plain backwards ``ref.flash_attention_backward`` and
  ``ref.rglru_scan_backward`` (the formulas the backward kernels compute)
  against ``jax.vjp`` of the reference's jnp attention (``_sdpa``, the
  path of ``use_flash=False``) and jnp scan, and against torch autograd
  of the port's plain forwards;
* ``lm_loss`` and every gradient leaf against
  ``jax.value_and_grad(lm_loss, use_flash=False)``;
* ``remat``, ``_remat_groups`` and ``chunked_ce`` with a remainder chunk.

Inputs come from numpy with a seed; the reference's ``init_model`` gives
the parameters.  Tolerances: f32 gradients 1e-5 of the largest entry
(summation order); bf16 inputs 2e-2 of it (one bf16 rounding of each
input and output); the loss 1e-5 relative and each parameter gradient
1e-4 of its leaf's largest entry (a whole model's sums in another order).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro.models import rglru as RR
from repro.models import transformer as RT
from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, unflatten

from test_torch_lm import VARIANTS, _params, _variant
from test_torch_train import _two_threads  # noqa: F401  (autouse fixture)


def _rel_close(got, want, tol, what="gradient"):
    """max |got - want| <= tol * max |want| (in f32)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float32) - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.fixture
def one_thread():
    """One intra-op thread while a test compares two CPU computations bit
    for bit: neither then depends on an OpenMP or MKL thread team, whose
    size and threads other test files in the same worker process set and
    leave behind."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_attention_vjp(q, k, v, dout, window, softcap):
    """The reference's gradient of its jnp attention (``_sdpa``, queries
    right-aligned to the KV tail) in the layer layout (B, S, H, hd)."""
    Sq, Skv = q.shape[1], k.shape[1]
    i = np.arange(Sq)[:, None] + (Skv - Sq)
    j = np.arange(Skv)[None, :]
    mask = j <= i
    if window:
        mask &= (i - j) < window
    mask = jnp.asarray(mask)[None]

    def f(q, k, v):
        return RL._sdpa(q, k, v, mask, softcap)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(dout))


ATTN_CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, hd, window, softcap)
    "causal": (2, 2, 2, 40, 40, 32, 0, 0.0),
    "window": (1, 2, 2, 70, 70, 32, 16, 0.0),
    "softcap": (1, 2, 2, 33, 33, 64, 0, 30.0),
    "gqa-4:2": (2, 4, 2, 48, 48, 32, 0, 0.0),
    "mqa-window-softcap": (1, 4, 1, 37, 37, 64, 8, 5.0),
    "ragged-skv>sq": (1, 4, 2, 21, 53, 32, 24, 0.0),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_plain_attention_backward_matches_jax_and_autograd(case, dtype,
                                                          one_thread):
    B, Hq, Hkv, Sq, Skv, hd, window, cap = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    k = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Skv, Hkv, hd)).astype(np.float32)
    dout = rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32)
    tdt = getattr(torch, dtype)
    qt, kt, vt, dt = (torch.tensor(x).to(tdt) for x in (q, k, v, dout))
    out, lse = ref.flash_attention(qt.transpose(1, 2), kt.transpose(1, 2),
                                   vt.transpose(1, 2), True, window, cap,
                                   return_lse=True)
    got = ref.flash_attention_backward(
        qt.transpose(1, 2), kt.transpose(1, 2), vt.transpose(1, 2), out,
        dt.transpose(1, 2), True, window, cap, lse=lse)
    assert [g.dtype for g in got] == [tdt] * 3
    got = [g.transpose(1, 2) for g in got]
    # the reference's gradient, from the same (rounded) inputs in f32
    want = _jax_attention_vjp(*(x.float().numpy() for x in (qt, kt, vt, dt)),
                              window, cap)
    tol = 1e-5 if dtype == "float32" else 2e-2
    for name, g, w in zip("qkv", got, want):
        _rel_close(g, w, tol, f"d{name} against jax.vjp")
    # and torch autograd of the port's plain forward (through ops, CPU)
    leaves_ = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
    o = ops.flash_attention(*leaves_, causal=True, window=window,
                            softcap=cap)
    auto = torch.autograd.grad(o, leaves_, dt)
    for name, g, a in zip("qkv", got, auto):
        # ops' backward: this, the forward's LSE
        assert torch.equal(g, a), (f"d{name}: ops' autograd differs from "
                                   f"the plain backward",
                                   float((g.float() - a.float()).abs().max()))


def test_plain_attention_backward_is_not_autograd_of_itself():
    """The gradient is written out: it needs no graph and matches autograd
    of the plain forward computed independently."""
    rng = np.random.default_rng(9)
    q, k, v, do = (torch.tensor(rng.normal(size=(1, 2, 30, 32)),
                                dtype=torch.float32) for _ in range(4))
    with torch.no_grad():
        out = ref.flash_attention(q, k, v, True, 8, 0.0)
        got = ref.flash_attention_backward(q, k, v, out, do, True, 8, 0.0)
    live = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ref.flash_attention(*live, True, 8, 0.0)
    want = torch.autograd.grad(o, live, do)
    for g, w in zip(got, want):
        _rel_close(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,w", [(2, 50, 8), (1, 129, 16)])
def test_plain_scan_backward_matches_jax_and_autograd(B, S, w, dtype):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(B, S, w)).astype(np.float32)
    b = rng.normal(size=(B, S, w)).astype(np.float32)
    dh = rng.normal(size=(B, S, w)).astype(np.float32)
    tdt = getattr(torch, dtype)
    at, bt, dht = (torch.tensor(x).to(tdt) for x in (a, b, dh))
    h = ref.rglru_scan(at, bt)
    da, db = ref.rglru_scan_backward(at, h, dht)
    assert da.dtype == db.dtype == tdt
    want_a, want_b = jax.jit(lambda a, b, g: jax.vjp(RR.rglru_scan, a, b)[1](
        g))(*(jnp.asarray(x.float().numpy()) for x in (at, bt, dht)))
    # bf16: h is stored rounded, and da reads it (the kernel's contract)
    tol = 1e-5 if dtype == "float32" else 2e-2
    _rel_close(da, want_a, tol)
    _rel_close(db, want_b, tol)
    live = [x.detach().requires_grad_(True) for x in (at, bt)]
    auto = torch.autograd.grad(ops.rglru_scan(*live), live, dht)
    assert torch.equal(auto[0], da) and torch.equal(auto[1], db)


def test_plain_scan_backward_rounds_as_the_kernel():
    """One reverse chain, the product rounded before the sum: the f32
    recurrence written out in numpy gives the same bits."""
    rng = np.random.default_rng(3)
    a = rng.uniform(0.5, 1.0, size=(1, 20, 4)).astype(np.float32)
    h = rng.normal(size=(1, 20, 4)).astype(np.float32)
    dh = rng.normal(size=(1, 20, 4)).astype(np.float32)
    da, db = ref.rglru_scan_backward(*(torch.tensor(x) for x in (a, h, dh)))
    g = np.zeros((1, 4), np.float32)
    for t in range(19, -1, -1):
        g = dh[:, t] if t == 19 else np.float32(a[:, t + 1] * g) + dh[:, t]
        assert np.array_equal(db[:, t].numpy(), g)
        want = g * h[:, t - 1] if t else np.zeros_like(g)
        assert np.array_equal(da[:, t].numpy(), want)


# ------------------------------------------------------------- the model --
@pytest.mark.parametrize("name", list(VARIANTS))
def test_lm_loss_and_gradients_match_the_reference(name):
    arch, changes = VARIANTS[name]
    cfg_ref, cfg = _variant(arch, **changes)
    tree, params = _params(cfg_ref)
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 96))
    (want, (want_ce, _)), want_g = jax.jit(jax.value_and_grad(
        lambda p: RT.lm_loss(p, {"tokens": jnp.asarray(toks)}, cfg_ref,
                             use_flash=False), has_aux=True))(tree)
    live = [t.requires_grad_(True) for t in leaves(params)]
    got, (got_ce, aux) = T.lm_loss(params, {"tokens": torch.tensor(toks)},
                                   cfg)
    got.backward()
    got, got_ce = got.detach(), got_ce.detach()
    assert float(aux) == 0.0
    for g, w in ((got, want), (got_ce, want_ce)):
        assert abs(g.item() - float(w)) <= 1e-5 * abs(float(w))
    want_leaves = jax.tree.leaves(want_g)
    assert len(want_leaves) == len(live)
    for t, w in zip(live, want_leaves):
        assert t.grad is not None and t.grad.shape == w.shape
        _rel_close(t.grad, w, 1e-4)


def _grads(params, toks, cfg, remat):
    live = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    loss, _ = T.lm_loss(unflatten(params, live), {"tokens": toks}, cfg,
                        remat=remat)
    loss.backward()
    return loss.detach(), [t.grad for t in live]


@pytest.mark.parametrize("layers,pattern", [(4, ("rglru", "local")),
                                            (20, ("rglru",))])
def test_remat_equals_no_remat(layers, pattern):
    """Recomputing each repetition (4 layers of (RG-LRU, local attention):
    R = 2, one level) or groups of them (20 RG-LRU layers: R = 20, G = 4
    groups of 5) gives the same loss and gradients as keeping every
    activation."""
    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(),
                              num_layers=layers, block_pattern=pattern,
                              d_model=64, head_dim=16, rglru_width=64,
                              d_ff=128, vocab_size=128)
    R = layers // len(cfg.block_pattern)
    assert T._remat_groups(R) == (1 if layers == 4 else 4)
    params = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40)))
    l0, g0 = _grads(params, toks, cfg, False)
    l1, g1 = _grads(params, toks, cfg, True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_groups_match_the_reference():
    assert [T._remat_groups(r) for r in range(1, 101)] == \
        [RT._remat_groups(r) for r in range(1, 101)]


def test_chunked_ce_with_a_remainder_chunk():
    """S = 50 in chunks of 16: three chunks and a remainder of 2, against
    the reference's ``chunked_ce`` and the unchunked cross-entropy, value
    and gradient."""
    cfg_ref, cfg = _variant("gemma2-2b")          # logit softcap, tied
    tree, params = _params(cfg_ref)
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 50, cfg.d_model)).astype(np.float32)
    tg = rng.integers(0, cfg.vocab_size, (2, 50))
    mask = (rng.uniform(size=(2, 50)) < 0.8).astype(np.float32)
    want = RT.chunked_ce(tree, jnp.asarray(h), jnp.asarray(tg),
                         jnp.asarray(mask), cfg_ref, chunk=16)
    ht = torch.tensor(h, requires_grad=True)
    got = T.chunked_ce(params, ht, torch.tensor(tg), torch.tensor(mask), cfg,
                       chunk=16)
    got.backward()
    got = got.detach()
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    logits = T.unembed(params, ht.detach(), cfg, normed=True).float()
    full = torch.nn.functional.cross_entropy(
        logits.reshape(-1, cfg.vocab_size), torch.tensor(tg).reshape(-1),
        reduction="none").reshape(2, 50)
    m = torch.tensor(mask)
    assert math.isclose(float((full * m).sum() / m.sum()), float(got),
                        rel_tol=1e-5)
    want_g = jax.grad(lambda x: RT.chunked_ce(
        tree, x, jnp.asarray(tg), jnp.asarray(mask), cfg_ref, chunk=16))(
        jnp.asarray(h))
    _rel_close(ht.grad, want_g, 1e-5)
