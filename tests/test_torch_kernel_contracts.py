"""The widened kernel contracts on the CPU, against the reference's Pallas
kernels in interpret mode (as the reference's own tests run them).

On the card ``tracker_select`` takes any ``seg`` (a block per segment past
``TEAM_SEG``) and ``embedding_bags`` any number of tables (groups of 64)
and any row width; ``tests/test_torch_cuda.py`` holds the kernels against
the plain versions there.  Held here: the plain versions, which the CPU
path runs and the card is held to, equal the reference's kernels at those
contracts — ``tracker_select`` at ``seg`` > 16,384 (ragged last segments,
ties, folds past INT32_MAX, one segment of a whole table) bit for bit, and
``embedding_bag`` at f32 d = 1, 3, 5 and bf16 d = 4, and the 65- and
130-table ``embedding_bags`` per table.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import embedding_bag as rek
from repro.kernels import tracker_select as rts
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tracker_select import TEAM_SEG


def _counts(rng, N, dist):
    if dist == "equal":
        c = np.full(N, 3)
    elif dist == "uniform":
        c = rng.integers(0, 5, N)
    elif dist == "zipf":
        c = np.minimum(rng.zipf(1.2, N) - 1, 1000)
    else:
        c = 2 ** 31 - 1 - rng.integers(0, 3, N)
    return c.astype(np.int32)


@pytest.mark.parametrize("N,M,k,seg,dist", [
    (40_000, 300, 16, TEAM_SEG + 1, "uniform"),   # ragged last segment
    (2 * (TEAM_SEG + 1), 40, 9, TEAM_SEG + 1, "equal"),   # ties everywhere
    (70_000, 500, 12, 65_536, "zipf"),
    (100_000, 200, 10, 200_000, "near_max"),      # one segment, wraps
])
def test_tracker_select_wide_segments_match_reference(N, M, k, seg, dist):
    rng = np.random.default_rng(N + M + k)
    counts = _counts(rng, N, dist)
    idx = rng.integers(-20, N + 20, size=M).astype(np.int32)
    if dist == "near_max":
        idx[: M // 2] = np.argmax(counts)        # several folds into one row
    want_i, want_c = rts.tracker_select(jnp.asarray(counts), jnp.asarray(idx),
                                        k, seg_size=seg, interpret=True)
    got_i, got_c = ops.tracker_select(torch.tensor(counts), torch.tensor(idx),
                                      k, seg_size=seg)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("d,dtype,hot", [
    (1, np.float32, 3), (3, np.float32, 2), (5, np.float32, 4),
    (4, "bfloat16", 1),
])
def test_embedding_bag_any_width_matches_reference(d, dtype, hot):
    """The reference sums a bag in the table's dtype; at bf16 one lookup a
    bag keeps both sides exact, at f32 the sums agree to rounding."""
    rng = np.random.default_rng(d * 10 + hot)
    N, B = 300, 24
    table = rng.normal(size=(N, d)).astype(np.float32)
    idx = rng.integers(0, N, size=(B, hot)).astype(np.int32)
    jt = jnp.asarray(table, jnp.bfloat16 if dtype == "bfloat16" else dtype)
    want = np.asarray(rek.embedding_bag(jt, jnp.asarray(idx), interpret=True)
                      .astype(jnp.float32))
    tt = torch.from_numpy(np.array(jt.astype(jnp.float32)))
    if dtype == "bfloat16":
        tt = tt.to(torch.bfloat16)
    got = ops.embedding_bag(tt, torch.from_numpy(idx)).float().numpy()
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("T,d", [(65, 16), (130, 3)])
def test_embedding_bags_many_tables_match_reference(T, d):
    """Every table of a 65- or 130-table call against the reference's
    kernel on that table alone, and the dense gradients against autograd
    of the per-table lookups."""
    rng = np.random.default_rng(T + d)
    rows = [int(n) for n in rng.integers(1, 60, size=T)]
    tables = [rng.normal(size=(n, d)).astype(np.float32) for n in rows]
    B, hot = 8, 2
    sparse = np.stack([rng.integers(0, n, size=(B, hot)) for n in rows],
                      axis=1).astype(np.int32)
    tt = [torch.tensor(t, requires_grad=True) for t in tables]
    got = ops.embedding_bags(tt, torch.from_numpy(sparse))
    assert got.shape == (B, T, d)
    for t in range(T):
        want = np.asarray(rek.embedding_bag(
            jnp.asarray(tables[t]), jnp.asarray(sparse[:, t]), interpret=True))
        np.testing.assert_allclose(got[:, t].detach().numpy(), want,
                                   rtol=1e-6, atol=1e-6)
    w = torch.from_numpy(rng.normal(size=(B, T, d)).astype(np.float32))
    (got * w).sum().backward()
    for t in range(T):
        want = ref.embedding_bag_backward(w[:, t], torch.from_numpy(
            sparse[:, t]), rows[t])
        torch.testing.assert_close(tt[t].grad, want, rtol=1e-6, atol=1e-6)
