"""The tracker kernels' contract on the CPU, against the reference.

``ssu_update(..., backend="kernel")`` hands ``ssu_dedupe_evict`` the raw
strided candidates (unsorted, repeated): the plain version, like the CUDA
kernel, keeps each value once itself.  Held here: the port's kernel
backend walks the reference's reservoir bit for bit given the same ids and
keep-scores, overflow included; the plain version on raw candidates equals
the reference's on their unique, EMPTY-padded form; ``tracker_select``'s
plain version equals the reference on the redesign's edges (ties
everywhere, Zipf counts, counters near INT32_MAX, k = seg, N < seg).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trackers as rtrk
from repro.kernels import ref as rref
from repro_torch.core import trackers as ttrk
from repro_torch.kernels import ops, ref

EMPTY = ref.EMPTY


# ------------------------------------------------------------ ssu_update ----
@pytest.mark.parametrize("ref_backend", ["host", "pallas"])
@pytest.mark.parametrize("period", [1, 2])
def test_ssu_update_kernel_backend_matches_reference(period, ref_backend):
    """Ids drawn from a small space, so every batch repeats ids (inside the
    batch, and against the reservoir); the reference's keep-scores are
    replayed into the port, over enough rounds to overflow."""
    rn = 24
    rs = rtrk.ssu_init(rn, seed=3)
    ts = ttrk.ssu_init(rn, seed=3, device="cpu")
    rng = np.random.default_rng(period)
    for k in range(8):
        idx = rng.integers(0, 70, size=(12, 2)).astype(np.int32)
        idx[6:] = idx[:6]                       # repeats within the batch
        flat = idx.reshape(-1)[::period]
        assert np.unique(flat).size < flat.size
        nc = flat.size
        _, sub = jax.random.split(rs["key"])
        scores = np.asarray(jax.random.uniform(sub, (rn + nc,)))
        rs = rtrk.ssu_update(rs, jnp.asarray(idx), period, backend=ref_backend)
        ts = ttrk.ssu_update(ts, torch.tensor(idx), period, backend="kernel",
                             scores=torch.tensor(scores))
        np.testing.assert_array_equal(ts["buf"].numpy(), np.asarray(rs["buf"]),
                                      err_msg=f"round {k}")
    assert (ts["buf"] != EMPTY).sum() == rn              # it overflowed


# ------------------------------------------------------ ssu_dedupe_evict ----
def _unique_padded(cand):
    u = np.unique(cand)
    out = np.full(cand.size, EMPTY, np.int32)
    out[:u.size] = u
    return out


@pytest.mark.parametrize("rn,nc,live,kind", [
    (64, 40, 20, "raw"),           # no overflow, repeats to keep once
    (32, 24, 32, "raw"),           # overflow
    (32, 24, 32, "tied"),          # overflow with tied scores
    (32, 24, 28, "signed_zero"),   # overflow with -0.0 / +0.0 scores
    (40, 30, 40, "all_present"),   # full, every candidate already in it
    (8, 0, 8, "raw"),              # no candidates
    (1, 6, 0, "raw"),              # one slot, empty
    (1, 4, 1, "raw"),              # one slot, full
])
def test_raw_candidates_match_reference_on_their_unique_form(rn, nc, live,
                                                             kind):
    rng = np.random.default_rng(rn * 100 + nc + live)
    buf = np.full(rn, EMPTY, np.int32)
    buf[:live] = np.sort(rng.choice(500, size=live, replace=False))
    if kind == "all_present":
        cand = rng.choice(buf[:live], size=nc).astype(np.int32)
    else:
        cand = rng.integers(0, 500, size=nc).astype(np.int32)
        if live:
            cand[: nc // 4] = rng.choice(buf[:live], size=nc // 4)
        cand[nc // 2:] = rng.choice(cand[:max(nc // 2, 1)], size=nc - nc // 2)
    scores = rng.uniform(size=rn + nc).astype(np.float32)
    if kind == "tied":
        scores = np.floor(scores * 4) / 4
    if kind == "signed_zero":
        scores = np.where(rng.uniform(size=rn + nc) < 0.5, np.float32(-0.0),
                          np.float32(0.0)).astype(np.float32)
        scores[::3] = 0.5
    want = rref.ssu_dedupe_evict(buf, _unique_padded(cand), scores)
    got = ops.ssu_dedupe_evict(torch.tensor(buf), torch.tensor(cand),
                               torch.tensor(scores))
    np.testing.assert_array_equal(got.numpy(), want)


# -------------------------------------------------------- tracker_select ----
@pytest.mark.parametrize("N,M,k,seg,dist", [
    (700, 0, 7, 7, "equal"),        # ties everywhere, seg 7
    (700, 20, 33, 33, "uniform"),   # k = seg
    (1500, 0, 16, 512, "zipf"),     # most counters 0
    (1500, 30, 16, 512, "near_max"),  # folds wrap past INT32_MAX
    (300, 10, 64, 512, "zipf"),     # N < seg
    (1, 0, 1, 512, "uniform"),      # one row
])
def test_tracker_select_edges_match_reference(N, M, k, seg, dist):
    rng = np.random.default_rng(N + M + k)
    if dist == "equal":
        counts = np.full(N, 3)
    elif dist == "uniform":
        counts = rng.integers(0, 5, N)
    elif dist == "zipf":
        counts = np.minimum(rng.zipf(1.2, N) - 1, 1000)
    else:
        counts = 2 ** 31 - 1 - rng.integers(0, 3, N)
    counts = counts.astype(np.int32)
    idx = rng.integers(-5, N + 5, size=M).astype(np.int32)
    if dist == "near_max":
        idx[: M // 2] = np.argmax(counts)        # several folds into one row
    want_i, want_c = rref.tracker_select(counts, idx, k, seg_size=seg)
    got_i, got_c = ops.tracker_select(torch.tensor(counts), torch.tensor(idx),
                                      k, seg_size=seg)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_c.numpy(), want_c)
