"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the check runs
inside the ``card`` fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Edge shapes the full-width smoke run does not reach: 1 to 26 tables of
ragged row counts with out-of-range ids in one embedding launch, 65 and
130 tables (groups of 64, a launch each), rows that are not whole
16-byte chunks (f32 d = 1, 3, 5; bf16 d = 4) or start mid-row, ragged
segments, seg from 7 to TEAM_SEG and past it (16,385, 65,536, one
1,000,000-row segment), k > seg and k = seg, ties everywhere,
counts near INT32_MAX, N < seg, empty and invalid pending ids; raw
(unsorted, repeated) candidates, none, 8,192 (one tile) and up to 65,536
of them (values repeated across tiles), a one-slot reservoir, overflow
with tied and signed-zero scores, a full reservoir that holds every
candidate; ``rglru_scan`` at the prefill's width and rows of any
alignment; for the LM path, head dims 32-256, MQA/GQA, windows,
softcaps, Skv > Sq, ragged lengths, f32 and bf16, the bf16 kernel's tile
edges, and the reduced models against the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ops, ref
from repro_torch.kernels.ssu_dedupe import TILE
from repro_torch.kernels import embedding_bag as eb
from repro_torch.kernels.tracker_select import TEAM_SEG

pytestmark = pytest.mark.card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("N,d,B,hot", [(64, 16, 8, 1), (128, 64, 4, 4),
                                       (1000, 32, 16, 3), (32, 512, 2, 2)])
def test_embedding_bag_kernel(card, N, d, B, hot, dtype, tol):
    g = torch.Generator(device=card).manual_seed(N + d)
    table = torch.randn((N, d), generator=g, device=card).to(dtype)
    idx = torch.randint(0, N, (B, hot), generator=g, device=card,
                        dtype=torch.int32)
    before = LAUNCHES["embedding_bag"]
    got = ops.embedding_bag(table, idx)
    assert LAUNCHES["embedding_bag"] == before + 1
    torch.testing.assert_close(got.float(), ref.embedding_bag(table, idx).float(),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("N,B,hot", [(10, 32, 1), (50, 16, 3), (7, 64, 4)])
def test_embedding_bag_backward_kernel(card, N, B, hot):
    g = torch.Generator(device=card).manual_seed(N * B)
    table = torch.randn((N, 16), generator=g, device=card, requires_grad=True)
    idx = torch.randint(0, N, (B, hot), generator=g, device=card,
                        dtype=torch.int32)
    w = torch.randn((B, 16), generator=g, device=card)
    (ops.embedding_bag(table, idx) * w).sum().backward()
    want = ref.embedding_bag_backward(w, idx, N)
    # atomic adds in run-dependent order: f32 rounding of the row sums
    torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-5)


def _bags_on_card(card, T, hot, dtype, seed, B=24, d=16):
    """T tables of ragged row counts and (B, T, hot) ids, some of them out
    of range (negative or >= N_t), on the card."""
    rng = np.random.default_rng(seed)
    rows = [int(n) for n in rng.integers(1, 3000, size=T)]
    tables = [torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
              .to(card).to(dtype) for n in rows]
    sparse = np.stack([rng.integers(-3, n + 3, size=(B, hot)) for n in rows],
                      axis=1).astype(np.int32)
    return rows, tables, torch.from_numpy(sparse).to(card)


def _in_range(sparse, rows, t):
    """Table t's ids with each out-of-range id pointed at row N_t, a zero
    row the plain version is given: such ids contribute nothing."""
    ids = sparse[:, t].long()
    return torch.where((ids >= 0) & (ids < rows[t]), ids,
                       torch.full_like(ids, rows[t]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("T,hot", [(1, 1), (1, 4), (3, 2), (26, 1), (26, 3)])
def test_embedding_bags_kernel(card, T, hot, dtype, tol):
    """All tables in one launch, against the per-table plain version."""
    rows, tables, sparse = _bags_on_card(card, T, hot, dtype, T * 7 + hot)
    before = LAUNCHES["embedding_bag"]
    got = ops.embedding_bags(tables, sparse)
    assert LAUNCHES["embedding_bag"] == before + 1
    assert got.shape == (sparse.shape[0], T, 16) and got.dtype == dtype
    for t, table in enumerate(tables):
        padded = torch.cat([table, table.new_zeros((1, 16))])
        want = ref.embedding_bag(padded, _in_range(sparse, rows, t))
        torch.testing.assert_close(got[:, t].float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("T,hot", [(1, 1), (1, 4), (3, 2), (26, 1), (26, 3)])
def test_embedding_bags_backward_kernel(card, T, hot):
    """Every table's dense gradient from one launch, reading the output
    gradient in place through a strided view (as the model's
    concatenation hands it over), against the per-table plain version."""
    rows, tables, sparse = _bags_on_card(card, T, hot, torch.float32,
                                         T * 11 + hot)
    tables = [t.requires_grad_(True) for t in tables]
    g = torch.Generator(device=card).manual_seed(T + hot)
    w = torch.randn((sparse.shape[0], T + 1, 16), generator=g, device=card)
    before = LAUNCHES["embedding_bag_backward"]
    out = ops.embedding_bags(tables, sparse)
    feats = torch.cat([torch.zeros_like(out[:, :1]), out], dim=1)
    (feats * w).sum().backward()
    assert LAUNCHES["embedding_bag_backward"] == before + 1
    for t, table in enumerate(tables):
        want = ref.embedding_bag_backward(w[:, t + 1], _in_range(sparse, rows, t),
                                          rows[t] + 1)[:rows[t]]
        # atomic adds in run-dependent order: f32 rounding of the row sums
        torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-5)


def test_embedding_bags_kernel_refuses(card):
    sparse = torch.zeros((2, 2, 1), dtype=torch.int32, device=card)
    a = torch.zeros((4, 16), device=card)
    with pytest.raises(ValueError, match="one dtype"):
        eb.forward([a, a.to(torch.bfloat16)], sparse)
    with pytest.raises(ValueError, match="one dtype, one d"):
        eb.forward([a, torch.zeros((4, 8), device=card)], sparse)
    with pytest.raises(ValueError, match="contiguous"):
        eb.forward([a, torch.zeros((4, 32), device=card)[:, ::2]], sparse)
    with pytest.raises(ValueError, match="tables"):
        eb.forward([a] * 3, sparse)
    with pytest.raises(ValueError, match="at least one"):
        eb.forward([], sparse)


def _tables_of(card, rng, rows, d, dtype, view):
    """Tables of ``rows`` (N_t, d); ``view``: each a contiguous view that
    starts one element past its allocation (so mid-row, and never 16-byte
    aligned)."""
    out = []
    for n in rows:
        x = torch.from_numpy(rng.normal(size=n * d + view).astype(np.float32))
        x = x.to(card).to(dtype)
        out.append(x[view:].view(n, d))
    return out


_WIDE_BAGS = [
    # T > 64: groups of 64 tables, a launch each way per group
    (65, 16, torch.float32, False), (130, 16, torch.float32, False),
    (65, 3, torch.float32, False), (130, 8, torch.bfloat16, False),
    # rows that are not whole 16-byte chunks: the element path
    (3, 1, torch.float32, False), (3, 3, torch.float32, False),
    (26, 5, torch.float32, False), (4, 4, torch.bfloat16, False),
    # views that start mid-row (d = 16 would be whole chunks)
    (26, 16, torch.float32, True), (3, 8, torch.bfloat16, True),
]


@pytest.mark.parametrize("hot", [1, 2])
@pytest.mark.parametrize("T,d,dtype,view", _WIDE_BAGS)
def test_embedding_bags_kernel_any_count_and_width(card, T, d, dtype, view,
                                                   hot):
    """Equal to the plain version under ``torch.equal``: at most two
    lookups a bag, so the kernel's f32 sum (0 + a + b) is the plain
    version's in any order; out-of-range ids point at a zero row the plain
    version is given."""
    rng = np.random.default_rng(T * 100 + d + hot + view)
    rows = [int(n) for n in rng.integers(1, 400, size=T)]
    tables = _tables_of(card, rng, rows, d, dtype, int(view))
    B = 16
    sparse = torch.from_numpy(np.stack(
        [rng.integers(-2, n + 2, size=(B, hot)) for n in rows],
        axis=1).astype(np.int32)).to(card)
    before = LAUNCHES["embedding_bag"]
    got = ops.embedding_bags(tables, sparse)
    assert LAUNCHES["embedding_bag"] - before == eb.launches(T) == -(-T // 64)
    assert got.shape == (B, T, d) and got.dtype == dtype
    for t, table in enumerate(tables):
        padded = torch.cat([table, table.new_zeros((1, d))])
        want = ref.embedding_bag(padded, _in_range(sparse, rows, t))
        assert torch.equal(got[:, t], want), t


@pytest.mark.parametrize("hot", [1, 3])
@pytest.mark.parametrize("T,d,dtype,view", _WIDE_BAGS)
def test_embedding_bags_backward_kernel_any_count_and_width(card, T, d,
                                                            dtype, view,
                                                            hot):
    """Every table's dense gradient, read through a strided output
    gradient whose rows are not 16-byte aligned (the element path) or are
    (d % 4 == 0 and an aligned view: the vector path)."""
    rng = np.random.default_rng(T * 10 + d + hot + view)
    rows = [int(n) for n in rng.integers(1, 400, size=T)]
    tables = [t.requires_grad_(True) for t in
              _tables_of(card, rng, rows, d, dtype, int(view))]
    B = 16
    sparse = torch.from_numpy(np.stack(
        [rng.integers(-2, n + 2, size=(B, hot)) for n in rows],
        axis=1).astype(np.int32)).to(card)
    w = torch.from_numpy(rng.normal(size=(B, T + 1, d)).astype(np.float32)
                         ).to(card)
    before = LAUNCHES["embedding_bag_backward"]
    out = ops.embedding_bags(tables, sparse)
    feats = torch.cat([torch.zeros_like(out[:, :1]), out], dim=1)
    (feats.float() * w).sum().backward()
    assert LAUNCHES["embedding_bag_backward"] - before == eb.launches(T)
    # the output gradient reaches the kernel in the output's dtype (a bf16
    # output rounds it), and the kernel sums it in f32
    g = w.to(dtype).float()
    for t, table in enumerate(tables):
        want = ref.embedding_bag_backward(g[:, t + 1],
                                          _in_range(sparse, rows, t),
                                          rows[t] + 1)[:rows[t]]
        assert table.grad.dtype == dtype
        # atomic adds in run-dependent order: f32 rounding of the row sums,
        # and for bf16 tables the sum rounded once to bf16 (one step of
        # 2**-8 where the two sums straddle a rounding edge)
        rtol = 1e-5 if dtype == torch.float32 else 1e-2
        torch.testing.assert_close(table.grad.float(), want.to(dtype).float(),
                                   rtol=rtol, atol=1e-5)


def _counts(rng, N, dist):
    """Counters of one shape of skew: ``uniform`` 0..4 (many ties),
    ``equal`` (ties everywhere), ``zipf`` (mostly 0), ``near_max`` (within
    3 of INT32_MAX)."""
    if dist == "uniform":
        c = rng.integers(0, 5, N)
    elif dist == "equal":
        c = np.full(N, 3)
    elif dist == "zipf":
        c = np.minimum(rng.zipf(1.2, N) - 1, 1000)
    else:
        c = 2 ** 31 - 1 - rng.integers(0, 3, N)
    return c.astype(np.int32)


_TS_CASES = [
    # the earlier cases (uniform counters), ids as before
    *(pytest.param(N, M, k, seg, "uniform", id=f"{N}-{M}-{k}-{seg}")
      for N, M, k, seg in [(1000, 300, 25, 256), (7, 3, 2, 512),
                           (512, 0, 10, 128), (513, 11, 4, 256),
                           (100, 50, 100, 512), (300, 40, 700, 64),
                           (100_003, 5000, 64, 2048)]),
    # the redesign's edges: seg 7, 33, 512, 2048, TEAM_SEG; k = seg; ties
    # everywhere; Zipf counts, mostly 0; counts near INT32_MAX; N < seg
    (1000, 30, 3, 7, "uniform"), (1000, 30, 7, 7, "equal"),
    (5000, 100, 5, 33, "zipf"), (990, 0, 33, 33, "uniform"),
    (100_000, 0, 64, 512, "zipf"), (100_000, 2048, 64, 512, "zipf"),
    (10_000, 0, 64, 512, "equal"), (2048, 0, 512, 512, "equal"),
    (10_000, 0, 64, 512, "near_max"), (9000, 0, 64, 2048, "equal"),
    # pending ids fold counters near INT32_MAX past it (int32 wrap)
    (10_000, 2048, 64, 512, "near_max"), (9000, 3000, 64, 2048, "near_max"),
    (20_000, 0, 2048, 2048, "zipf"), (700, 10, 64, 2048, "uniform"),
    (40_000, 100, 300, TEAM_SEG, "uniform"),
    (20_000, 0, TEAM_SEG, TEAM_SEG, "zipf"), (300, 10, 64, 512, "zipf"),
    (1, 0, 1, 512, "uniform"),
    # past TEAM_SEG: a block per segment, selecting in device memory;
    # ragged last segments, ties, k = seg, folds past INT32_MAX, one
    # 1,000,000-row table as a single segment (seg_size >= N too)
    (40_000, 300, 64, TEAM_SEG + 1, "uniform"),
    (2 * (TEAM_SEG + 1), 100, TEAM_SEG + 1, TEAM_SEG + 1, "equal"),
    (200_000, 2048, 300, 65_536, "zipf"),
    (150_000, 3000, 1000, 65_536, "near_max"),
    (1_000_000, 5000, 64, 1_000_000, "uniform"),
    (1_000_000, 5000, 125_000, 1_000_000, "zipf"),
    (1_000_000, 100, 1000, 2_000_000, "near_max"),
]


@pytest.mark.parametrize("N,M,k,seg,dist", _TS_CASES)
def test_tracker_select_kernel(card, N, M, k, seg, dist):
    rng = np.random.default_rng(N + M)
    counts = torch.from_numpy(_counts(rng, N, dist)).to(card)
    pend = torch.from_numpy(rng.integers(-20, N + 20, M).astype(np.int32)
                            ).to(card)
    got_i, got_c = ops.tracker_select(counts, pend, k, seg_size=seg)
    want_i, want_c = ref.tracker_select(counts, pend, k, seg_size=seg)
    assert torch.equal(got_i, want_i) and torch.equal(got_c, want_c)


_SSU_CASES = [
    # the earlier cases (candidates deduped and EMPTY-padded by the test)
    *(pytest.param(rn, nc, live, tied, "unique",
                   id=f"{rn}-{nc}-{live}-{tied}")
      for rn, nc, live, tied in [(16, 12, 13, False), (32, 24, 32, False),
                                 (32, 24, 32, True), (8, 0, 8, False),
                                 (10_000, 300, 10_000, False),
                                 (10_000, 300, 4_000, False),
                                 (20_000, 3000, 20_000, True)]),
    # raw candidates (unsorted, repeated), as ssu_update now passes them
    (64, 48, 60, False, "raw"), (10_000, 300, 4_000, False, "raw"),
    (10_000, 300, 10_000, True, "raw"),
    # no candidates; the most candidates
    (100, 0, 40, False, "raw"), (20_000, 8192, 20_000, False, "raw"),
    (1000, 8192, 500, False, "unique"),
    # a one-slot reservoir
    (1, 5, 0, False, "raw"), (1, 3, 1, False, "raw"), (1, 0, 1, False, "raw"),
    # overflow with -0.0 and +0.0 keep-scores (they tie)
    (32, 24, 32, False, "signed_zero"), (5000, 600, 5000, False, "signed_zero"),
    # a full reservoir that already holds every candidate
    (10_000, 300, 10_000, False, "all_present"),
    # more candidates than one tile (TILE = 8,192): sorted a tile at a
    # time, ranked across tiles; "raw" repeats the first half's values in
    # the second half, so values repeat across tiles
    (20_000, TILE + 1, 4_000, False, "raw"),
    (20_000, TILE + 1, 20_000, True, "raw"),
    (50_000, 2 * TILE, 10_000, False, "unique"),
    (50_000, 2 * TILE, 50_000, False, "signed_zero"),
    (50_000, 2 * TILE, 50_000, False, "all_present"),
    (1_266_403, 2 * TILE, 633_201, False, "raw"),       # full width
    (1_266_403, 2 * TILE, 1_266_403, False, "raw"),
    (200_000, 8 * TILE, 100_000, False, "raw"),
    (200_000, 8 * TILE, 200_000, False, "raw"),
    (100_000, 8 * TILE, 100_000, True, "raw"),
]


@pytest.mark.parametrize("rn,nc,live,tied,kind", _SSU_CASES)
def test_ssu_dedupe_evict_kernel(card, rn, nc, live, tied, kind):
    rng = np.random.default_rng(rn + nc)
    EMPTY = ref.EMPTY
    buf = np.full(rn, EMPTY, np.int32)
    buf[:live] = np.sort(rng.choice(10 * rn, size=live, replace=False))
    if kind == "all_present":
        c = rng.choice(buf[:live], size=nc).astype(np.int32)
    else:
        c = rng.choice(10 * rn, size=nc).astype(np.int32)
        if live:
            c[: nc // 4] = rng.choice(buf[:live], size=nc // 4)
    if kind == "raw":
        c[nc // 2:] = rng.choice(c[:max(nc // 2, 1)], size=nc - nc // 2)
        cand = c                                    # unsorted, repeated
    else:
        u = np.unique(c)
        cand = np.full(nc, EMPTY, np.int32)
        cand[:u.size] = u
    scores = rng.uniform(size=rn + nc).astype(np.float32)
    if tied:
        scores = np.floor(scores * 8) / 8
    if kind == "signed_zero":
        scores = np.where(rng.uniform(size=rn + nc) < 0.5, np.float32(-0.0),
                          np.float32(0.0)).astype(np.float32)
        scores[::5] = 0.5
    args = [torch.from_numpy(a).to(card) for a in (buf, cand, scores)]
    got = ops.ssu_dedupe_evict(*args)
    assert torch.equal(got, ref.ssu_dedupe_evict(*args))
    if kind == "raw":             # the same as on the deduped, padded form
        u = np.unique(cand)
        dedup = np.full(nc, EMPTY, np.int32)
        dedup[:u.size] = u
        assert torch.equal(got, ops.ssu_dedupe_evict(
            args[0], torch.from_numpy(dedup).to(card), args[2]))


def test_emulator_on_the_card_matches_the_cpu_path(card):
    from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
    from repro_torch.core import (CPRManager, Emulator, FailureInjector,
                                  SystemParams)
    from repro_torch.data.synthetic import ClickLogDataset
    from repro_torch.models.dlrm import init_dlrm, params_to_numpy
    cfg = scaled(DLRM_KAGGLE, 2000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=8000, seed=3)
    init = params_to_numpy(init_dlrm(cfg, torch.Generator().manual_seed(0),
                                     "cpu"))
    out = []
    for device in (card, "cpu"):
        p = SystemParams()
        mgr = CPRManager("cpr-mfu", p, cfg.table_sizes, device=device,
                         tracker_backend="kernel")
        inj = FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        out.append(Emulator(cfg, ds, mgr, inj, batch_size=256, device=device,
                            init_params=init).run())
    a, b = out
    assert a.report["bytes_written"] == b.report["bytes_written"]
    assert a.report["measured_pls"] == b.report["measured_pls"]
    assert abs(a.auc - b.auc) <= 5e-3


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("n,d", [(1, 1), (7, 3), (257, 5), (1000, 16),
                                 (513, 9), (5, 0)])
def test_row_hash_kernel(card, n, d, dtype):
    """Bit-exact against the plain version: 8-, 4-, 2- and 1-byte load
    units, ragged rows (36-byte f32 rows, 3-byte int8 rows), an f32
    accumulator (one 4-byte word, zeros high)."""
    g = torch.Generator(device=card).manual_seed(n * 7 + d)
    values = (torch.randn((n, d), generator=g, device=card) * 50).to(dtype)
    accs = torch.rand(n, generator=g, device=card)
    before = LAUNCHES["row_hash"]
    got = ops.row_hash(values, accs)
    assert LAUNCHES["row_hash"] == before + 1
    assert got.dtype == torch.int64 and got.shape == (n,)
    assert torch.equal(got, ref.row_hash(values, accs))


@pytest.mark.parametrize("case", ["no rows", "zero-byte rows",
                                  "zero-byte values", "unaligned view"])
def test_row_hash_kernel_edge_cases(card, case):
    if case == "no rows":
        values, accs = torch.zeros((0, 16), device=card), torch.zeros(
            0, device=card)
    elif case == "zero-byte rows":
        values, accs = torch.zeros((4, 0), device=card), torch.zeros(
            (4, 0), device=card)
    elif case == "zero-byte values":
        values = torch.zeros((6, 0), device=card)
        accs = torch.arange(6, dtype=torch.float32, device=card)
    else:   # rows starting 4 bytes past an 8-byte boundary
        base = torch.arange(4 * 33, dtype=torch.float32, device=card)
        values = base[1:].reshape(-1)[:4 * 32].reshape(32, 4)
        accs = torch.arange(32, dtype=torch.float32, device=card)
    before = LAUNCHES["row_hash"]
    got = ops.row_hash(values, accs)
    want = ref.row_hash(values, accs)
    assert torch.equal(got, want)
    launched = LAUNCHES["row_hash"] - before
    if case in ("no rows", "zero-byte rows"):       # answered, no launch
        assert launched == 0
        assert (got == ref.FNV_OFFSET).all()
    else:
        assert launched == 1


def test_row_hash_kernel_refuses_strided_rows(card):
    values = torch.zeros((8, 16), device=card)[:, ::2]
    accs = torch.zeros(8, device=card)
    from repro_torch.kernels import row_hash as rh
    with pytest.raises(ValueError, match="contiguous"):
        rh.row_hash(values, accs)


@pytest.mark.parametrize("hash_backend", ["host", "kernel"])
def test_fleet_ledger_on_the_card_hashes_through_the_kernel(card,
                                                            hash_backend):
    """Tables on the card put the delta ledger there and every hash
    through the kernel, whatever ``hash_backend`` name is passed; the
    counts, ledger and image equal the same writer's on the CPU."""
    from repro_torch.core import EmbShardSpec, ShardedCheckpointWriter
    sizes = (1001, 37)
    rng = np.random.default_rng(3)
    tabs = [rng.standard_normal((n, 16)).astype(np.float32) for n in sizes]
    accs = [rng.random(n).astype(np.float32) for n in sizes]
    out = {}
    for device in (card, torch.device("cpu")):
        t = [torch.tensor(x, device=device) for x in tabs]
        a = [torch.tensor(x, device=device) for x in accs]
        before = LAUNCHES["row_hash"]
        w = ShardedCheckpointWriter(t, a, EmbShardSpec(sizes, 3),
                                    hash_backend=hash_backend)
        w.save_full([x + 1 for x in t], [x + 1 for x in a], step=1)
        rows = torch.arange(0, sizes[0], 3, device=device)
        vals = t[0][rows] + 1                   # equal to the full: skipped
        vals[::2] += 1
        w.save_rows(0, rows, vals, a[0][rows] + 1, step=2)
        w.save_rows(1, np.array([1, 5, 40]), np.ones((3, 16), np.float32),
                    np.ones(3, np.float32), step=2)     # host rows
        w.fence()
        out[device.type] = (w.hash_backend, LAUNCHES["row_hash"] - before,
                            w.bytes_written, w.delta_rows_skipped,
                            w.delta_bytes_skipped,
                            [h.cpu() for h in w._hashes],
                            w.restore_all()[:2])
        w.close()
    gpu, cpu = out["cuda"], out["cpu"]
    assert (gpu[0], cpu[0]) == ("kernel", "host")
    assert gpu[1] == 6 and cpu[1] == 0      # 2 at init, 2 full, 2 rows
    assert gpu[2:5] == cpu[2:5] and gpu[3] > 0
    assert all(torch.equal(x, y) for x, y in zip(gpu[5], cpu[5]))
    for x, y in zip(gpu[6][0] + gpu[6][1], cpu[6][0] + cpu[6][1]):
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------ the LM serving path --
FLASH_CARD_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap
    (2, 4, 4, 128, 128, 32, True, 0, 0.0),
    (1, 8, 2, 128, 128, 64, True, 0, 0.0),         # GQA 4:1
    (2, 10, 1, 300, 300, 256, True, 64, 0.0),      # MQA, window, ragged
    (1, 4, 2, 100, 333, 64, True, 0, 50.0),        # softcap, Skv > Sq
    (1, 4, 4, 77, 77, 128, False, 0, 0.0),         # bidirectional, ragged
    (1, 8, 4, 256, 256, 256, True, 0, 50.0),       # gemma2: global, softcap
    (2, 2, 1, 1, 40, 32, True, 16, 0.0),           # one query, window
]


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 4e-3)])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_CARD_CASES)
def test_flash_attention_kernel(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                window, softcap, dtype, rtol, atol):
    """Layer layout (B, S, H, hd) through ``ops``: the kernel reads the
    transposed views in place.  f32 within 2e-5 of the plain version (the
    order of the f32 sums differs); bf16 outputs within one rounding (a
    bf16 ulp is at most 2**-7 of the value) plus 4e-3."""
    g = torch.Generator(device=card).manual_seed(Sq * 31 + Skv + hd)
    q = torch.randn((B, Sq, Hq, hd), generator=g, device=card).to(dtype)
    k = torch.randn((B, Skv, Hkv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((B, Skv, Hkv, hd), generator=g, device=card).to(dtype)
    before = LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert LAUNCHES["flash_attention"] == before + 1
    torch.cuda.synchronize()
    want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, window,
                               softcap).transpose(1, 2)
    assert got.shape == want.shape and got.dtype == dtype
    assert got.is_contiguous()
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=atol)


# the bf16 kernel's tiles: 64 keys, 64 query rows a warpgroup, 128 a CTA
FLASH_BF16_EDGE_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap
    (1, 2, 1, 63, 63, 64, True, 0, 0.0),           # one row / key short
    (1, 2, 1, 65, 65, 64, True, 0, 0.0),           # one row / key over
    (2, 2, 2, 63, 65, 128, True, 0, 0.0),          # Skv - Sq = 2
    (1, 2, 1, 127, 127, 128, False, 0, 0.0),       # one row short of a CTA
    (1, 2, 1, 129, 129, 32, True, 0, 0.0),         # one row over a CTA
    (1, 4, 2, 100, 231, 128, True, 0, 0.0),        # Skv - Sq = 131
    (1, 2, 1, 70, 333, 32, True, 0, 30.0),         # Skv - Sq = 263, softcap
    (1, 2, 1, 256, 256, 64, True, 64, 0.0),        # window on a tile edge
    (1, 2, 1, 256, 256, 64, True, 65, 0.0),        # one key past it
    (1, 2, 1, 256, 256, 64, True, 63, 0.0),        # one key short of it
    (1, 2, 1, 200, 300, 128, True, 128, 0.0),      # window, Skv > Sq
    (1, 10, 1, 200, 200, 256, True, 128, 0.0),     # MQA 10:1, hd 256
    (1, 8, 4, 190, 260, 256, True, 0, 50.0),       # GQA 8:4, hd 256, softcap
    (2, 10, 1, 520, 520, 256, True, 192, 0.0),     # serving shape, cut short
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_BF16_EDGE_CASES)
def test_flash_attention_bf16_tile_edges(card, B, Hq, Hkv, Sq, Skv, hd,
                                         causal, window, softcap):
    """The tensor-core kernel at its tile edges, at the bf16 limit
    |kernel - plain| <= 1e-2 |plain| + 4e-3 (p and the output are rounded
    to bf16; the plain version keeps p in f32)."""
    test_flash_attention_kernel(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                window, softcap, torch.bfloat16, 1e-2, 4e-3)


def test_flash_attention_kernel_refuses(card):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros((1, 2, 8, 48), device=card)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q, q, q)
    q = torch.zeros((1, 2, 8, 32), device=card)
    with pytest.raises(ValueError, match="Skv"):
        fa.flash_attention(q, q[:, :, :4], q[:, :, :4])
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        fa.flash_attention(q.half(), q.half(), q.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,w", [(2, 128, 64), (1, 257, 130), (3, 64, 32),
                                   (1, 1, 5), (2, 4096, 256),
                                   # the prefill's shape; S one past it
                                   (2, 4096, 2560), (1, 4097, 2560),
                                   (8, 300, 96),
                                   # a tile of 64 steps and one more;
                                   # 16-step tiles of 160 channels
                                   (1, 65, 64), (8, 33, 2560)])
def test_rglru_scan_kernel(card, B, S, w, dtype):
    """Bit-exact against the plain version: the same f32 product and sum,
    rounded the same way, in the same order; ragged S and w (rows of 520,
    260, 20 and 10 bytes fill the ring with 8- and 4-byte copies and, for
    bf16 with odd w, plain loads)."""
    g = torch.Generator(device=card).manual_seed(B * S + w)
    a = torch.sigmoid(torch.randn((B, S, w), generator=g, device=card)
                      ).to(dtype)
    b = (torch.randn((B, S, w), generator=g, device=card) * 0.1).to(dtype)
    before = LAUNCHES["rglru_scan"]
    got = ops.rglru_scan(a, b)
    assert LAUNCHES["rglru_scan"] == before + 1
    want = ref.rglru_scan(a, b)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_rglru_scan_kernel_unaligned_base(card, offset, dtype):
    """Inputs that start 1-3 elements past an aligned address (contiguous
    views into a larger buffer) take the narrower copies or plain loads,
    and still match bit for bit."""
    B, S, w = 2, 300, 64
    g = torch.Generator(device=card).manual_seed(offset)
    n = B * S * w
    a = torch.sigmoid(torch.randn(n + offset, generator=g, device=card)
                      ).to(dtype)[offset:].view(B, S, w)
    b = (torch.randn(n + offset, generator=g, device=card) * 0.1
         ).to(dtype)[offset:].view(B, S, w)
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    got = ops.rglru_scan(a, b)
    assert got.dtype == dtype and torch.equal(got, ref.rglru_scan(a, b))


@pytest.mark.parametrize("arch,changes", [
    ("recurrentgemma-2b", {}), ("gemma2-2b", {"num_kv_heads": 2})])
def test_reduced_model_on_the_card_matches_the_cpu(card, arch, changes):
    """The same weights on the card (kernels) and on the CPU (plain
    versions, held against JAX by ``tests/test_torch_lm.py``): prefill
    logits within 1e-4 (f32 sums in another order) and identical greedy
    completions."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda t: t.to(card), cpu)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    LAUNCHES["flash_attention"] = LAUNCHES["rglru_scan"] = 0
    got, _ = T.forward(gpu, {"tokens": toks.to(card)}, cfg)
    kinds = cfg.layer_kinds
    assert LAUNCHES["flash_attention"] == sum(k != "rglru" for k in kinds)
    assert LAUNCHES["rglru_scan"] == sum(k == "rglru" for k in kinds)
    want, _ = T.forward(cpu, {"tokens": toks}, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    reqs = make_requests(4, 12, cfg.vocab_size, seed=0)
    a, _ = serve(cfg, reqs, batch=2, gen=8, params=gpu, device=card)
    b, _ = serve(cfg, reqs, batch=2, gen=8, params=cpu, device="cpu")
    assert a == b
