"""The LM path's kernel entry points of the port (CPU route: the plain
versions) against the reference's Pallas kernels in interpret mode and its
jnp oracles, on the sweeps of ``tests/test_kernels.py``.

The same seeded numpy inputs go to both sides.  Tolerances are that file's:
flash attention f32 2e-5, bf16 3e-2; the RG-LRU scan f32 1e-5, bf16 3e-2
(bf16 outputs are one rounding of values that agree in f32).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as rg_kernel

FLASH_CASES = [
    (2, 4, 4, 128, 128, 32, True, 0, 0.0),
    (1, 8, 2, 128, 128, 64, True, 0, 0.0),       # GQA 4:1
    (2, 4, 1, 256, 256, 32, True, 64, 0.0),      # MQA + sliding window
    (1, 2, 2, 128, 128, 32, True, 0, 50.0),      # softcap (gemma2)
    (1, 4, 4, 128, 128, 32, False, 0, 0.0),      # encoder (hubert)
    (1, 4, 2, 128, 384, 32, True, 0, 0.0),       # Skv > Sq (decode-ish)
]


def _to_jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _to_torch(x, dtype):
    return torch.tensor(x).to(getattr(torch, dtype))


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------ flash attention ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_CASES)
def test_flash_attention_matches_reference(B, Hq, Hkv, Sq, Skv, hd, causal,
                                           window, softcap, dtype):
    """Layer layout (B, S, H, hd) through ``ops.flash_attention`` against
    the reference's Pallas kernel (interpret) and its oracle."""
    rng = np.random.default_rng(Sq + Skv + hd + Hq)
    q, k, v = (rng.normal(size=(B, S, H, hd)).astype(np.float32)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    jq, jk, jv = (_to_jax(x, dtype) for x in (q, k, v))
    kernel = rops.flash_attention(jq, jk, jv, causal=causal, window=window,
                                  softcap=softcap, block_q=64, block_k=64)
    oracle = rref.flash_attention(jq.swapaxes(1, 2), jk.swapaxes(1, 2),
                                  jv.swapaxes(1, 2), causal, window,
                                  softcap).swapaxes(1, 2)
    got = ops.flash_attention(*(_to_torch(x, dtype) for x in (q, k, v)),
                              causal=causal, window=window, softcap=softcap)
    assert got.shape == (B, Sq, Hq, hd) and got.dtype == getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 3e-2
    for want in (kernel, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_flash_attention_matches_model_chunked_attention():
    """The port's route and the reference model's online-softmax path."""
    from repro.models.layers import _chunked_sdpa
    rng = np.random.default_rng(3)
    B, S, H, hd = 2, 256, 4, 32
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k, v = (rng.normal(size=(B, S, 2, hd)).astype(np.float32)
            for _ in range(2))
    pos = jnp.arange(S)
    want = _chunked_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos,
                         pos, True, 0, 0.0, block=64)
    got = ops.flash_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ rglru scan ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,w,bs,bw", [
    (2, 128, 64, 32, 64), (1, 256, 128, 256, 64), (3, 64, 32, 16, 32),
])
def test_rglru_scan_matches_reference(B, S, w, bs, bw, dtype):
    rng = np.random.default_rng(B * S + w)
    # decay in (0, 1) like real RG-LRU gates
    a = (1 / (1 + np.exp(-rng.normal(size=(B, S, w))))).astype(np.float32)
    b = (rng.normal(size=(B, S, w)) * 0.1).astype(np.float32)
    ja, jb = _to_jax(a, dtype), _to_jax(b, dtype)
    kernel = rops.rglru_scan(ja, jb, block_s=bs, block_w=bw)
    oracle = rref.rglru_scan(ja, jb)
    got = ops.rglru_scan(_to_torch(a, dtype), _to_torch(b, dtype))
    assert got.shape == (B, S, w) and got.dtype == getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 3e-2
    for want in (kernel, oracle):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_rglru_scan_plain_version_carries_h0():
    """``ref.rglru_scan`` with a start state, against the reference's."""
    rng = np.random.default_rng(5)
    a = rng.uniform(0.5, 1.0, size=(2, 16, 8)).astype(np.float32)
    b = rng.normal(size=(2, 16, 8)).astype(np.float32)
    h0 = rng.normal(size=(2, 8)).astype(np.float32)
    want = rref.rglru_scan(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    got = ref.rglru_scan(torch.tensor(a), torch.tensor(b), torch.tensor(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------- wrappers ----
def test_kernel_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch or raise: a CPU tensor never reaches a
    plain version through them (``ops`` picks the route)."""
    q = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.flash_attention(q, q, q)
    a = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="CUDA"):
        rg_kernel.rglru_scan(a, a)
