"""The f32 attention kernels' arithmetic, 3xTF32, on the CPU against the
JAX reference.

``csrc/flash_attention.cu`` and ``csrc/flash_attention_backward.cu`` form
every product on the tensor cores in 3xTF32 (``csrc/tf32x3.cuh``): each
f32 operand x is split into hi = x rounded to TF32 (round to nearest,
ties away: ``cvt.rna``) and lo = x - hi, which the tensor core reads
truncated to TF32; a.b is taken as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi,
each TF32 product exact in f32, sums in f32.  This file emulates that in
plain torch (bit arithmetic on ``view(torch.int32)``; the emulation lives
here only, not in the port) and runs it through the attention forward and
backward, as the kernels do, at the shapes of ``ATTN_CASES`` and at
reduced versions of ``chip_smoke.py``'s f32 phase-2b/2c cases:

* the forward against ``repro.kernels.ref.flash_attention`` within the
  f32 kernel's unchanged limit, |err| <= 2e-5 + 2e-5 |ref|;
* the backward against ``jax.vjp`` of the reference's jnp attention
  (``repro.models.layers._sdpa``) within the unchanged ``BWD_TOL`` f32,
  |err| <= 1e-4 |ref| + 1e-5 max |ref|;
* one TF32 product alone (no split) falls outside those limits on some
  case, forward and backward: the split is needed, as the window one tile
  short shows that the mask is.

Inputs come from numpy with a seed.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as RK

from test_torch_lm_grad import ATTN_CASES, _jax_attention_vjp

FWD_TOL = (2e-5, 2e-5)         # rtol, atol: the card test's f32 limit
BWD_TOL = (1e-4, 1e-5)         # rtol, atol of max |ref|

CASES = {
    **{name: (B, Hq, Hkv, Sq, Skv, hd, window, cap)
       for name, (B, Hq, Hkv, Sq, Skv, hd, window, cap)
       in ATTN_CASES.items()},
    # chip_smoke.py's f32 cases, cut in length: phase 2b's reduced config
    # and phase 4b's prefill (2, 10, 1, 2176, 256), window 2,048; phase
    # 2c's LM example (4, 8, 4, 128, 64), window 256, and the training
    # check 7 (b)'s (1, 10, 1, 2176, 256), window 2,048
    "2b-reduced": (2, 4, 1, 128, 128, 64, 64, 0.0),
    "4b-prefill-cut": (1, 10, 1, 160, 160, 256, 128, 0.0),
    "2c-example": (2, 8, 4, 96, 96, 64, 256, 0.0),
    "7b-training-cut": (1, 10, 1, 192, 192, 256, 160, 0.0),
}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous().view(torch.int32)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (ties away from zero), as
    ``cvt.rna.tf32.f32``: 13 low mantissa bits rounded off."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of an f32 operand: its TF32 truncation."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernels form it: a_lo.b_hi + a_hi.b_lo + a_hi.b_hi."""
    ah, bh = tf32_round(a), tf32_round(b)
    al, bl = tf32_cut(a - ah), tf32_cut(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def mm_tf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as one TF32 product: each operand rounded to TF32."""
    return tf32_round(a) @ tf32_round(b)


def _scores(q, kq, window, cap, mm):
    """Masked (softcapped) scores and the softcap's factor, causal,
    queries right-aligned to the KV tail."""
    Sq, Skv, hd = q.shape[2], kq.shape[2], q.shape[3]
    s = mm(q, kq.transpose(-1, -2)) / math.sqrt(hd)
    dcap = torch.ones_like(s)
    if cap:
        t = torch.tanh(s / cap)
        s, dcap = t * cap, 1.0 - t * t
    i = torch.arange(Sq)[:, None] + (Skv - Sq)
    j = torch.arange(Skv)[None, :]
    keep = j <= i
    if window:
        keep &= (i - j) < window
    return torch.where(keep, s, -1e30), keep, dcap


def attention(q, k, v, window, cap, mm):
    """The forward kernel's arithmetic: (output, LSE), kernel layout."""
    g = q.shape[1] // k.shape[1]
    kq, vq = (x.repeat_interleave(g, dim=1) for x in (k, v))
    s, keep, _ = _scores(q, kq, window, cap, mm)
    m = s.amax(-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    return mm(p, vq) / l, (m + torch.log(l))[..., 0]


def attention_backward(q, k, v, out, dout, lse, window, cap, mm):
    """The backward kernels' arithmetic: (dq, dk, dv), kernel layout."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kq, vq = (x.repeat_interleave(g, dim=1) for x in (k, v))
    s, keep, dcap = _scores(q, kq, window, cap, mm)
    p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
    dv = mm(p.transpose(-1, -2), dout)
    dp = mm(dout, vq.transpose(-1, -2))
    ds = p * (dp - (dout * out).sum(-1, keepdim=True)) * dcap
    scale = 1.0 / math.sqrt(hd)
    dq = mm(ds, kq) * scale
    dk = mm(ds.transpose(-1, -2), q) * scale

    def per_kv_head(x):
        return x.reshape(B, Hkv, g, Skv, hd).sum(2)

    return dq, per_kv_head(dk), per_kv_head(dv)


def _inputs(case):
    B, Hq, Hkv, Sq, Skv, hd, window, cap = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, Hq, Sq, hd), (B, Hkv, Skv, hd), (B, Hkv, Skv, hd),
                      (B, Hq, Sq, hd))]


def _fwd_excess(case, mm):
    """max of |got - want| / (atol + rtol |want|) of the forward."""
    *_, window, cap = CASES[case]
    q, k, v, _ = _inputs(case)
    got, _ = attention(*(torch.tensor(x) for x in (q, k, v)), window, cap,
                       mm)
    want = np.asarray(RK.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), True, window, cap))
    rtol, atol = FWD_TOL
    return float((np.abs(got.numpy() - want)
                  / (atol + rtol * np.abs(want))).max())


def _bwd_excess(case, mm):
    """max over dq, dk, dv of |got - want| / (rtol |want| + atol max
    |want|) of the backward, from the same arithmetic's forward."""
    *_, window, cap = CASES[case]
    q, k, v, do = (torch.tensor(x) for x in _inputs(case))
    out, lse = attention(q, k, v, window, cap, mm)
    got = attention_backward(q, k, v, out, do, lse, window, cap, mm)
    want = _jax_attention_vjp(*(x.transpose(1, 2).numpy()
                                for x in (q, k, v, do)), window, cap)
    rtol, atol = BWD_TOL
    worst = 0.0
    for a, w in zip(got, want):
        w = np.asarray(w).transpose(0, 2, 1, 3)
        limit = rtol * np.abs(w) + atol * np.abs(w).max()
        worst = max(worst, float((np.abs(a.numpy() - w) / limit).max()))
    return worst


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0 ** -10                                   # TF32 at 1.0
    x = torch.tensor([1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2 ** -20,
                      1.0 + 3 * ulp / 2, 3.0], dtype=torch.float32)
    got = tf32_round(x)
    assert got.tolist() == [1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp, 3.0]
    assert tf32_cut(one + 0.9 * ulp).item() == 1.0
    # hi + lo is x exactly, and lo keeps what TF32 dropped
    y = torch.tensor(np.random.default_rng(0).normal(size=1000),
                     dtype=torch.float32)
    hi = tf32_round(y)
    assert torch.equal(hi + (y - hi), y)
    assert float(((y - hi).abs() / y.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_forward_within_the_f32_limit(case):
    assert _fwd_excess(case, mm_3xtf32) <= 1.0


@pytest.mark.parametrize("case", list(CASES))
def test_3xtf32_backward_within_the_f32_limit(case):
    assert _bwd_excess(case, mm_3xtf32) <= 1.0


def test_one_tf32_product_falls_outside_the_f32_limits():
    """Without the split the f32 limits reject the result: the forward and
    the backward each exceed their limit on some case."""
    fwd = {case: _fwd_excess(case, mm_tf32) for case in CASES}
    bwd = {case: _bwd_excess(case, mm_tf32) for case in CASES}
    assert max(fwd.values()) > 1.0, fwd
    assert max(bwd.values()) > 1.0, bwd
