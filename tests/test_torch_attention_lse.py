"""The attention forward's log-sum-exp, handed to the backward, on the CPU
against the JAX reference.

* ``ref.flash_attention(..., return_lse=True)``: each row's LSE against
  ``jax.nn.logsumexp`` over the masked, softcapped scores formed as
  ``repro.kernels.ref.flash_attention`` forms them (1e-5 relative), and
  the output unchanged;
* ``ref.flash_attention_backward(..., lse=)`` equal to it without the LSE
  (f32, 1e-6 of the largest entry: exp(s - lse) against a softmax);
* ``ops.flash_attention``'s CPU autograd, which now saves the forward's
  LSE for the backward, against ``jax.vjp`` of the reference's attention
  (f32 sums in another order: 1e-5 of the largest entry).

Inputs come from numpy with a seed, in the kernel layout (B, H, S, hd).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK
from repro_torch.kernels import ops, ref

CASES = {
    # name: (B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap)
    "causal": (2, 2, 2, 40, 40, 32, True, 0, 0.0),
    "window": (1, 2, 2, 70, 70, 32, True, 16, 0.0),
    "gqa-4:2": (2, 4, 2, 48, 48, 32, True, 0, 0.0),
    "mqa-window-softcap": (1, 4, 1, 37, 37, 64, True, 8, 5.0),
    "skv>sq-window": (1, 4, 2, 21, 53, 32, True, 24, 0.0),
    "bidirectional-softcap": (1, 2, 1, 30, 45, 32, False, 0, 30.0),
}


def _inputs(case):
    B, Hq, Hkv, Sq, Skv, hd, *_ = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, hd), (B, Hkv, Skv, hd), (B, Hkv, Skv, hd),
                      (B, Hq, Sq, hd))]


def _jax_lse(q, k, causal, window, softcap):
    """logsumexp over the scores of ``repro.kernels.ref.flash_attention``:
    K repeated to the query heads, s / sqrt(hd), softcap, mask to -1e30."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    kq = jnp.repeat(jnp.asarray(k), Hq // Hkv, axis=1)
    s = jnp.einsum("bhsd,bhtd->bhst", jnp.asarray(q), kq) / math.sqrt(hd)
    if softcap:
        s = jnp.tanh(s / softcap) * softcap
    i = jnp.arange(Sq)[:, None] + (Skv - Sq)
    j = jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= j <= i
    if window:
        mask &= (i - j) < window
    s = jnp.where(mask[None, None], s, -1e30)
    return np.asarray(jax.nn.logsumexp(s, axis=-1))


def _rel_close(got, want, tol):
    """max |got - want| <= tol * max |want| (in f32)."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lse_matches_jax_logsumexp(case):
    *_, causal, window, cap = CASES[case]
    q, k, v, _ = _inputs(case)
    qt, kt, vt = (torch.tensor(x) for x in (q, k, v))
    out, lse = ref.flash_attention(qt, kt, vt, causal, window, cap,
                                   return_lse=True)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    want = _jax_lse(q, k, causal, window, cap)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=0)
    assert torch.equal(out, ref.flash_attention(qt, kt, vt, causal, window,
                                                cap))
    _rel_close(out, RK.flash_attention(q, k, v, causal, window, cap), 1e-5)


@pytest.mark.parametrize("case", list(CASES))
def test_backward_with_the_lse_equals_without(case):
    *_, causal, window, cap = CASES[case]
    q, k, v, do = (torch.tensor(x) for x in _inputs(case))
    out, lse = ref.flash_attention(q, k, v, causal, window, cap,
                                   return_lse=True)
    given = ref.flash_attention_backward(q, k, v, out, do, causal, window,
                                         cap, lse=lse)
    plain = ref.flash_attention_backward(q, k, v, out, do, causal, window,
                                         cap)
    for a, b in zip(given, plain):
        assert a.shape == b.shape and a.dtype == b.dtype
        _rel_close(a, b.numpy(), 1e-6)


@pytest.mark.parametrize("case", list(CASES))
def test_ops_cpu_autograd_matches_jax_vjp(case):
    """Layer layout (B, S, H, hd) through ``ops`` on the CPU: the forward
    saves its LSE and the plain backward uses it."""
    *_, causal, window, cap = CASES[case]
    q, k, v, do = _inputs(case)
    live = [torch.tensor(x).transpose(1, 2).requires_grad_(True)
            for x in (q, k, v)]
    o = ops.flash_attention(*live, causal=causal, window=window, softcap=cap)
    got = torch.autograd.grad(o, live, torch.tensor(do).transpose(1, 2))

    def f(q, k, v):
        return RK.flash_attention(q, k, v, causal, window, cap)

    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    for g, w in zip(got, want):
        _rel_close(g.transpose(1, 2), w, 1e-5)


def test_ops_forward_without_gradients_is_the_same_output():
    """Serving (no input needs a gradient) asks for no LSE and gives the
    same output bit for bit."""
    q, k, v, _ = (torch.tensor(x).transpose(1, 2)
                  for x in _inputs("mqa-window-softcap"))
    with torch.no_grad():
        served = ops.flash_attention(q, k, v, causal=True, window=8,
                                     softcap=5.0)
    live = [x.clone().requires_grad_(True) for x in (q, k, v)]
    trained = ops.flash_attention(*live, causal=True, window=8, softcap=5.0)
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach())
