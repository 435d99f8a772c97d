"""The port's trackers and policy copies against the reference.

Exact: MFU update/select (with ties), segmented MFU, SSU update given the
same keep-scores, ``choose_strategy``, ``FailureInjector``,
``ClickLogDataset``.  SCAR: the same row ids, shadows within f32 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import failure as rfail
from repro.core import overhead as roh
from repro.core import trackers as rtrk
from repro.data.synthetic import ClickLogDataset as RDS
from repro_torch.core import failure as tfail
from repro_torch.core import overhead as toh
from repro_torch.core import trackers as ttrk
from repro_torch.data.synthetic import ClickLogDataset as TDS


# ------------------------------------------------------------------ MFU ----
def test_mfu_update_and_select_exact_with_ties():
    rng = np.random.default_rng(0)
    n, rn = 300, 40
    rc, tc = rtrk.mfu_init(n), ttrk.mfu_init(n, "cpu")
    for _ in range(3):                   # few hits: most counters tie at 0
        idx = rng.integers(0, n, size=(16, 2)).astype(np.int32)
        rc = rtrk.mfu_update(rc, jnp.asarray(idx))
        tc = ttrk.mfu_update(tc, torch.tensor(idx))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    ri, rcl = rtrk.mfu_select(rc, rn)
    ti, tcl = ttrk.mfu_select(tc, rn)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tcl.numpy(), np.asarray(rcl))
    assert ti.dtype == torch.int32


@pytest.mark.parametrize("n,rn,seg,pending", [(1000, 125, 128, 0),
                                              (777, 97, 256, 64),
                                              (50, 6, 512, 10)])
def test_mfu_select_segmented_exact(n, rn, seg, pending):
    rng = np.random.default_rng(n)
    counts = rng.integers(0, 6, size=n).astype(np.int32)
    pend = rng.integers(-3, n + 3, size=pending).astype(np.int32)
    ri, rc = rtrk.mfu_select_segmented(jnp.asarray(counts), rn,
                                       indices=jnp.asarray(pend),
                                       seg_size=seg)
    ti, tc = ttrk.mfu_select_segmented(torch.tensor(counts), rn,
                                       indices=torch.tensor(pend),
                                       seg_size=seg)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(rc))
    assert ttrk.segmented_k(n, rn, seg) == rtrk.segmented_k(n, rn, seg)


# ------------------------------------------------------------------ SSU ----
@pytest.mark.parametrize("backend", ["host", "kernel"])
def test_ssu_update_exact_given_the_same_scores(backend):
    """The reference's keep-scores are replayed into the port: both
    backends then walk the reference's buffers exactly, overflow included."""
    rn, period = 24, 2
    rs = rtrk.ssu_init(rn, seed=5)
    ts = ttrk.ssu_init(rn, seed=5, device="cpu")
    rng = np.random.default_rng(9)
    for k in range(8):
        idx = rng.integers(0, 200, size=(20, 2)).astype(np.int32)
        nc = idx.size // period
        # the reference's draw, replayed: split, then uniform(sub)
        _, sub = jax.random.split(rs["key"])
        scores = np.asarray(jax.random.uniform(sub, (rn + nc,)))
        rs = rtrk.ssu_update(rs, jnp.asarray(idx), period, backend="host")
        ts = ttrk.ssu_update(ts, torch.tensor(idx), period, backend=backend,
                             scores=torch.tensor(scores))
        np.testing.assert_array_equal(ts["buf"].numpy(), np.asarray(rs["buf"]),
                                      err_msg=f"round {k}")
    assert (ts["buf"] != ttrk.EMPTY).sum() == rn         # it overflowed
    rows, reset = ttrk.ssu_select(ts)
    assert (reset["buf"] == ttrk.EMPTY).all() and rows.shape == (rn,)


def test_ssu_update_draws_from_the_state_generator():
    a = ttrk.ssu_init(16, seed=3, device="cpu")
    b = ttrk.ssu_init(16, seed=3, device="cpu")
    idx = torch.arange(100, dtype=torch.int32)
    a = ttrk.ssu_update(a, idx, 2, backend="host")
    b = ttrk.ssu_update(b, idx, 2, backend="kernel")
    assert torch.equal(a["buf"], b["buf"])     # same stream, same result


# ----------------------------------------------------------------- SCAR ----
def test_scar_select_same_rows():
    rng = np.random.default_rng(4)
    table0 = rng.normal(size=(60, 8)).astype(np.float32)
    table = table0.copy()
    moved = rng.choice(60, size=20, replace=False)
    table[moved] += rng.normal(size=(20, 8)).astype(np.float32)
    ri, rs = rtrk.scar_select(rtrk.scar_init(jnp.asarray(table0)),
                              jnp.asarray(table), 25)     # 5 zero-delta ties
    ti, ts = ttrk.scar_select(ttrk.scar_init(torch.tensor(table0)),
                              torch.tensor(table), 25)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ri))
    np.testing.assert_allclose(ts["shadow"].numpy(), np.asarray(rs["shadow"]),
                               rtol=1e-6, atol=1e-6)


def test_tracker_memory_and_correlation_match():
    for mode in ("scar", "mfu", "ssu", "none"):
        assert ttrk.tracker_memory_bytes(mode, 1000, 64, 0.125) == \
            rtrk.tracker_memory_bytes(mode, 1000, 64, 0.125)
    rng = np.random.default_rng(1)
    c = rng.integers(0, 9, size=50)
    t0 = rng.normal(size=(50, 4))
    t1 = t0 + rng.normal(size=(50, 4)) * c[:, None]
    assert ttrk.access_update_correlation(torch.tensor(c), torch.tensor(t1),
                                          t0) == \
        pytest.approx(rtrk.access_update_correlation(c, t1, t0), abs=1e-12)


# -------------------------------------------------------- policy copies ----
def test_choose_strategy_identical_over_a_grid():
    for T_fail in (2.0, 10.0, 28.0, 100.0):
        for N_emb in (1, 4, 8, 32):
            for O_save in (0.01, 0.06, 0.5):
                for pls in (0.01, 0.1, 0.5):
                    kw = dict(T_fail=T_fail, N_emb=N_emb, O_save=O_save)
                    assert toh.choose_strategy(toh.SystemParams(**kw), pls) \
                        == roh.choose_strategy(roh.SystemParams(**kw), pls)
    assert toh.scalability_curve([8, 64, 512]) == \
        roh.scalability_curve([8, 64, 512])
    assert dataclasses.asdict(toh.SystemParams()) == \
        dataclasses.asdict(roh.SystemParams())


@pytest.mark.parametrize("seed,uniform", [(0, True), (11, True), (7, False)])
def test_failure_injector_identical_events(seed, uniform):
    r = rfail.FailureInjector(3, 0.25, 8, 56.0, seed=seed, uniform=uniform)
    t = tfail.FailureInjector(3, 0.25, 8, 56.0, seed=seed, uniform=uniform)

    def rows(events):
        return [(e.time, e.shard_ids, e.fraction) for e in events]

    assert rows(t.events) == rows(r.events)
    assert rows(t.between(10.0, 40.0)) == rows(r.between(10.0, 40.0))


@pytest.mark.parametrize("multi_hot", [1, 2])
def test_click_log_batches_byte_identical(multi_hot):
    sizes = (1460, 583, 3000, 27, 4)
    r = RDS(sizes, num_samples=700, multi_hot=multi_hot, seed=3)
    t = TDS(sizes, num_samples=700, multi_hot=multi_hot, seed=3)
    assert r.ctr == t.ctr and r.eval_split(0.1) == t.eval_split(0.1)
    for rb, tb in zip(r.batches(256, loop=False), t.batches(256, loop=False)):
        for k in ("dense", "sparse", "label"):
            assert rb[k].dtype == tb[k].dtype
            assert rb[k].tobytes() == tb[k].tobytes()
