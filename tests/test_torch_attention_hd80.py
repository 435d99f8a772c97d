"""The plain attention versions that judge the card's kernels, held against
the JAX reference at head dim 80 (HuBERT X-Large's), on the CPU.

* ``ref.flash_attention`` (and ``ops.flash_attention``'s CPU route)
  against the reference's Pallas kernel in interpret mode and its jnp
  oracle ``repro.kernels.ref.flash_attention``: bidirectional, causal GQA
  2:1 and a ragged bidirectional length, at block sizes the Pallas
  kernel's asserts accept (whole blocks).  Tolerances are
  ``tests/test_kernels.py``'s: f32 2e-5 (sums in another order), bf16 3e-2
  (one bf16 rounding of outputs that agree in f32).
* ``ref.flash_attention_backward`` against ``jax.vjp`` of the reference's
  jnp attention ``repro.models.layers._sdpa``, with a bidirectional mask
  and with a causal windowed one, in f32 and bf16: f32 1e-5 of the
  largest entry (summation order), bf16 2e-2 of it (one bf16 rounding of
  each input and gradient), as ``tests/test_torch_lm_grad.py``.
* ``ops.flash_attention``'s autograd on the CPU: its gradients are the
  plain backward's given the forward's log-sum-exp, bit for bit, and the
  log-sum-exp it hands over is the reference's within 1e-5.

Inputs come from numpy with a seed and go to both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro.models import layers as RL
from repro_torch.kernels import ops, ref

HD = 80

FORWARD_CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, causal, window, block)
    "bidirectional": (1, 4, 4, 128, 128, False, 0, 64),
    "causal-gqa-2:1": (2, 4, 2, 128, 128, True, 0, 64),
    "bidirectional-ragged": (1, 2, 2, 100, 100, False, 0, 100),
    "window-skv>sq": (1, 4, 2, 64, 192, True, 48, 64),
}

BACKWARD_CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, causal, window)
    "bidirectional": (1, 4, 4, 70, 70, False, 0),
    "bidirectional-gqa-2:1": (2, 4, 2, 45, 45, False, 0),
    "causal-window": (1, 4, 2, 66, 66, True, 24),
}


@pytest.fixture
def pinned_torch():
    """The process-wide torch settings that reach a CPU matmul, pinned
    whatever other files in the worker left: one intra-op thread (two
    computations compared bit for bit then share one summation order) and
    full f32 matmuls ("medium" would run them in bf16 through oneDNN on
    a CPU with AMX, past the f32 limits)."""
    n = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_float32_matmul_precision(precision)
    torch.set_num_threads(n)


def _inputs(seed, B, Hq, Hkv, Sq, Skv):
    """q, k, v and an output gradient in the layer layout (B, S, H, hd),
    f32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, H, HD)).astype(np.float32)
            for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv), (Sq, Hq))]


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _mask(Sq, Skv, causal, window):
    """The reference's (1, Sq, Skv) mask, queries right-aligned."""
    i = np.arange(Sq)[:, None] + (Skv - Sq)
    j = np.arange(Skv)[None, :]
    mask = np.ones((Sq, Skv), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    return jnp.asarray(mask)[None]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_plain_forward_matches_pallas_and_oracle_at_hd80(case, dtype):
    B, Hq, Hkv, Sq, Skv, causal, window, block = FORWARD_CASES[case]
    q, k, v, _ = _inputs(len(case) + Sq, B, Hq, Hkv, Sq, Skv)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    kernel = rops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  block_q=block, block_k=block)
    oracle = rref.flash_attention(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                  jv.swapaxes(1, 2), causal,
                                  window).swapaxes(1, 2)
    tq, tk, tv = (torch.tensor(x).to(getattr(torch, dtype))
                  for x in (q, k, v))
    plain = ref.flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                                tv.transpose(1, 2), causal,
                                window).transpose(1, 2)
    routed = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert plain.shape == (B, Sq, Hq, HD)
    assert plain.dtype == getattr(torch, dtype)
    assert torch.equal(plain, routed)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in (kernel, oracle):
        np.testing.assert_allclose(_f32(plain), _f32(want), rtol=tol,
                                   atol=tol)


def _jax_vjp(q, k, v, dout, causal, window):
    """The reference's gradient of ``_sdpa`` in the layer layout."""
    mask = _mask(q.shape[1], k.shape[1], causal, window)
    _, vjp = jax.vjp(lambda q, k, v: RL._sdpa(q, k, v, mask),
                     *(jnp.asarray(x) for x in (q, k, v)))
    return vjp(jnp.asarray(dout))


def _rel_close(got, want, tol, what):
    """max |got - want| <= tol * max |want| (in f32)."""
    got, want = _f32(got), _f32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, tol * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_plain_backward_matches_jax_vjp_at_hd80(case, dtype, pinned_torch):
    B, Hq, Hkv, Sq, Skv, causal, window = BACKWARD_CASES[case]
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.tensor(x).to(tdt)
                   for x in _inputs(3 * len(case), B, Hq, Hkv, Sq, Skv))
    kq, kk, kv, kdo = (x.transpose(1, 2) for x in (q, k, v, do))
    out, lse = ref.flash_attention(kq, kk, kv, causal, window,
                                   return_lse=True)
    # given the forward's log-sum-exp, and forming it itself
    for given in (lse, None):
        got = ref.flash_attention_backward(kq, kk, kv, out, kdo, causal,
                                           window, lse=given)
        assert [g.dtype for g in got] == [tdt] * 3
        want = _jax_vjp(*(x.float().numpy() for x in (q, k, v, do)),
                        causal, window)
        tol = 1e-5 if dtype == "float32" else 2e-2
        for name, g, w in zip("qkv", got, want):
            _rel_close(g.transpose(1, 2), w, tol, f"d{name}")


@pytest.mark.parametrize("case", ["bidirectional-gqa-2:1", "causal-window"])
def test_ops_autograd_on_the_cpu_at_hd80(case, pinned_torch):
    B, Hq, Hkv, Sq, Skv, causal, window = BACKWARD_CASES[case]
    q, k, v, do = (torch.tensor(x)
                   for x in _inputs(7 * len(case), B, Hq, Hkv, Sq, Skv))
    live = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = ops.flash_attention(*live, causal=causal, window=window)
    auto = torch.autograd.grad(o, live, do)
    kq, kk, kv = (x.transpose(1, 2) for x in (q, k, v))
    out, lse = ref.flash_attention(kq, kk, kv, causal, window,
                                   return_lse=True)
    assert torch.equal(o.detach().transpose(1, 2), out)
    plain = ref.flash_attention_backward(kq, kk, kv, out, do.transpose(1, 2),
                                         causal, window, lse=lse)
    for name, a, p in zip("qkv", auto, plain):
        assert torch.equal(a, p.transpose(1, 2)), f"d{name}"
    # the log-sum-exp against the reference's masked scores
    mask = np.asarray(_mask(Sq, Skv, causal, window))[0]
    s = jnp.einsum("bshd,bthd->bhst", jnp.asarray(q.numpy()),
                   jnp.repeat(jnp.asarray(k.numpy()), Hq // Hkv,
                              axis=2)) / np.sqrt(HD)
    want_lse = jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)
