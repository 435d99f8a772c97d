"""The port's kernel entry points (CPU route: the plain versions) against
the reference's Pallas kernels in interpret mode and its numpy oracles.

The same seeded numpy inputs go to both sides.  Tolerances: exact for the
integer kernels; embedding bag f32 1e-6, bf16 2e-2 (as
``tests/test_kernels.py``); the backward f32 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import ops, ref


# ------------------------------------------------------------ embedding ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("N,d,B,hot", [
    (64, 16, 8, 1), (128, 64, 4, 4), (1000, 32, 16, 3), (32, 512, 2, 2),
])
def test_embedding_bag_matches_reference(N, d, B, hot, dtype):
    rng = np.random.default_rng(N + d + B + hot)
    table = rng.normal(size=(N, d)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, hot)).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = rops.embedding_bag(jnp.asarray(table, jdt), jnp.asarray(idx),
                              block_d=min(512, d))
    got = ops.embedding_bag(torch.tensor(table).to(tdt), torch.tensor(idx))
    tol = 1e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize("N,B,hot", [(10, 32, 1), (50, 16, 3), (7, 8, 4)])
def test_embedding_bag_backward_matches_jax_grad(N, B, hot):
    """Dense table gradient of sum(embedding_bag(table, idx) * w), with ids
    repeating across and within bags (N small against B·hot)."""
    rng = np.random.default_rng(N * B + hot)
    table = rng.normal(size=(N, 16)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, hot)).astype(np.int32)
    idx[0, :] = idx[1, 0]                         # repeats inside one bag
    w = rng.normal(size=(B, 16)).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jnp.sum(t[jnp.asarray(idx)], 1) *
                                      jnp.asarray(w)))(jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    (ops.embedding_bag(t, torch.tensor(idx)) * torch.tensor(w)).sum().backward()
    assert t.grad.shape == (N, 16)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- tracker_select ----
@pytest.mark.parametrize("N,M,k,seg", [
    (1000, 300, 25, 256),    # multi-segment
    (7, 3, 2, 512),          # single tiny segment
    (512, 0, 10, 128),       # no pending ids
    (513, 11, 4, 256),       # ragged last segment (padding picks)
    (100, 50, 100, 512),     # k > live rows
    (300, 40, 700, 64),      # k > seg: clamped to seg
])
def test_tracker_select_matches_reference(N, M, k, seg):
    rng = np.random.default_rng(N + M + k)
    counts = rng.integers(0, 5, size=N).astype(np.int32)     # many ties
    idx = rng.integers(-20, N + 20, size=M).astype(np.int32)  # some invalid
    want_i, want_c = rref.tracker_select(counts, idx, k, seg_size=seg)
    got_i, got_c = ops.tracker_select(torch.tensor(counts), torch.tensor(idx),
                                      k, seg_size=seg)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    assert got_i.dtype == torch.int32 and got_c.dtype == torch.int32


def test_tracker_select_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 9, size=700).astype(np.int32)
    idx = rng.integers(-5, 710, size=(6, 9)).astype(np.int32)
    want_i, want_c = rops.tracker_select(jnp.asarray(counts), jnp.asarray(idx),
                                         5, seg_size=128)
    got_i, got_c = ops.tracker_select(torch.tensor(counts), torch.tensor(idx),
                                      5, seg_size=128)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


def test_autotune_seg_size_on_cpu_picks_a_candidate():
    seg = ops.autotune_seg_size(4096, 8, candidates=(100, 128, 256),
                                trials=1, device="cpu")
    assert seg in (100, 128, 256)
    with pytest.raises(ValueError):
        ops.autotune_seg_size(10, 2, candidates=(), device="cpu")


# --------------------------------------------------------- ssu_dedupe ------
def _ssu_inputs(rng, rn, nc, live, n_present, id_space=1000):
    EMPTY = ref.EMPTY
    buf = np.full(rn, EMPTY, np.int32)
    buf[:live] = np.sort(rng.choice(id_space, size=live, replace=False))
    fresh = rng.choice(id_space, size=nc, replace=True).astype(np.int32)
    fresh[:n_present] = rng.choice(buf[:live], size=n_present, replace=False)
    u = np.unique(fresh)
    cand = np.full(nc, EMPTY, np.int32)
    cand[:u.size] = u
    scores = rng.uniform(size=rn + nc).astype(np.float32)
    return buf, cand, scores


@pytest.mark.parametrize("rn,nc,live,n_present,tied", [
    (16, 12, 13, 1, False),      # no overflow, one duplicate to drop
    (64, 32, 20, 8, False),      # half full, several already present
    (32, 24, 32, 4, False),      # full buffer: overflow, random evict
    (32, 24, 32, 0, True),       # overflow with tied scores (stable order)
    (8, 0, 8, 0, False),         # no candidates
])
def test_ssu_dedupe_evict_matches_reference(rn, nc, live, n_present, tied):
    rng = np.random.default_rng(rn + nc + live)
    buf, cand, scores = _ssu_inputs(rng, rn, nc, live, n_present)
    if tied:
        scores = np.floor(scores * 4) / 4
    want = rref.ssu_dedupe_evict(buf, cand, scores)
    got = ops.ssu_dedupe_evict(torch.tensor(buf), torch.tensor(cand),
                               torch.tensor(scores))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ssu_dedupe_evict_matches_pallas_interpret():
    rng = np.random.default_rng(5)
    buf, cand, scores = _ssu_inputs(rng, 16, 12, 16, 3)
    want = rops.ssu_dedupe_evict(buf, cand, scores)
    got = ops.ssu_dedupe_evict(torch.tensor(buf), torch.tensor(cand),
                               torch.tensor(scores))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------ dispatch -----
def test_wrappers_refuse_cpu_tensors():
    """The kernel wrappers launch on CUDA only; the CPU route is ops' job."""
    from repro_torch.kernels import embedding_bag as eb
    from repro_torch.kernels import ssu_dedupe as sd
    from repro_torch.kernels import tracker_select as ts
    t = torch.zeros(4, 16)
    i = torch.zeros(2, 1, dtype=torch.int32)
    c = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        eb.forward(t, i)
    with pytest.raises(ValueError, match="CUDA"):
        eb.backward(torch.zeros(2, 16), i, 4)
    with pytest.raises(ValueError, match="CUDA"):
        ts.tracker_select(c, c, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sd.ssu_dedupe_evict(c, c, torch.zeros(8))
