"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the check runs
inside the ``card`` fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

(the f32 attention kernels alone: ``-m card -k "flash and float32"``).

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
alignment; for the LM path, head dims 32-256 (HuBERT's 80 among them,
bidirectional and causal), MQA/GQA, windows, softcaps, Skv > Sq, ragged
lengths, f32 and bf16, the bf16 kernel's tile edges, the backward kernels
of attention and the scan and the autograd path through them, and the
reduced models' logits and gradients against the CPU (HuBERT's and
Qwen2-VL's with an image among them).
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
                                             (torch.bfloat16, 1e-2, 4e-3)],
                         ids=["float32", "bfloat16"])
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_attention_kernels_first_on_a_fresh_thread(card, dtype):
    """The forward and the backward launched as the first CUDA work of a
    new thread (as autograd's device thread runs a backward before any
    other operation there) give what they give on the main thread.  The
    bf16 kernels encode their TMA maps with a driver call, which needs a
    context bound to the thread: without one they failed to launch."""
    import threading

    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(7)
    q, do = (torch.randn((1, 8, 256, 256), generator=g, device=card)
             .to(dtype) for _ in range(2))
    k, v = (torch.randn((1, 4, 256, 256), generator=g, device=card)
            .to(dtype) for _ in range(2))
    out, lse = fa.flash_attention(q, k, v, True, 0, 50.0, return_lse=True)
    want = fa.flash_attention_backward(q, k, v, out, do, True, 0, 50.0,
                                       lse=lse)
    got = {}

    def run():
        try:
            got["out"] = fa.flash_attention(q, k, v, True, 0, 50.0)
            got["grads"] = fa.flash_attention_backward(q, k, v, out, do,
                                                       True, 0, 50.0,
                                                       lse=lse)
        except RuntimeError as e:
            got["error"] = e
    for _ in range(2):              # a new thread each time
        got.clear()
        t = threading.Thread(target=run)
        t.start()
        t.join()
        assert "error" not in got, got.get("error")
        torch.cuda.synchronize()
        assert torch.equal(got["out"], out)
        assert all(torch.equal(a, b) for a, b in zip(got["grads"], want))


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


# the f32 forward's tiles (3xTF32): 16 query rows a warp, 128 a CTA,
# 16-key tiles; a tile short, exact, one over, at hd 32 and 256; the
# training check 7 (b)'s MQA shape at reduced length
FLASH_F32_EDGE_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap
    (1, 2, 1, 15, 15, 32, True, 0, 0.0),           # one row short of a warp
    (1, 2, 1, 16, 16, 256, True, 0, 0.0),          # a warp's rows
    (1, 2, 1, 17, 17, 32, True, 0, 30.0),          # one row over, softcap
    (1, 2, 1, 63, 63, 256, True, 0, 0.0),
    (2, 2, 2, 64, 64, 32, False, 0, 0.0),
    (1, 4, 1, 65, 65, 256, True, 0, 0.0),
    (1, 2, 1, 127, 127, 32, True, 0, 0.0),         # one row short of a CTA
    (1, 2, 1, 128, 128, 256, True, 0, 0.0),        # a CTA's rows
    (1, 4, 2, 129, 129, 256, True, 0, 0.0),        # one row over
    (1, 2, 1, 40, 55, 256, True, 0, 0.0),          # Skv - Sq = 15
    (1, 2, 1, 40, 56, 32, True, 0, 0.0),           # Skv - Sq = a key tile
    (1, 2, 1, 40, 57, 256, True, 0, 0.0),          # one key over
    (1, 2, 1, 40, 71, 256, True, 0, 0.0),          # 31
    (1, 2, 1, 40, 72, 32, True, 0, 0.0),           # 32
    (1, 2, 1, 40, 73, 256, True, 0, 0.0),          # 33
    (1, 2, 1, 128, 128, 32, True, 15, 0.0),        # window a key short
    (1, 2, 1, 128, 128, 256, True, 16, 0.0),       # window on a tile edge
    (1, 2, 1, 128, 128, 32, True, 17, 0.0),        # one key past it
    (1, 2, 1, 128, 128, 32, True, 31, 0.0),
    (1, 2, 1, 128, 128, 256, True, 32, 0.0),
    (1, 2, 1, 128, 128, 32, True, 33, 0.0),
    (1, 10, 1, 320, 320, 256, True, 256, 0.0),     # 7 (b), cut in length
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_F32_EDGE_CASES)
def test_flash_attention_float32_tile_edges(card, B, Hq, Hkv, Sq, Skv, hd,
                                        causal, window, softcap):
    """The f32 kernel at its tile edges, at the f32 limit (2e-5)."""
    test_flash_attention_kernel(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                window, softcap, torch.float32, 2e-5, 2e-5)


def assert_grad_close(got, want, rtol, atol):
    """|got - want| <= rtol * |want| + atol * max |want|, elementwise."""
    got, want = got.float(), want.float()
    limit = rtol * want.abs() + atol * want.abs().max()
    assert bool(((got - want).abs() <= limit).all()), \
        float(((got - want).abs() / limit).max())


# the backward's limits: f32 sums in another order; bf16 adds one rounding
# of each gradient (2**-8 of the value, nearest) to that
BWD_TOL = {torch.float32: (1e-4, 1e-5), torch.bfloat16: (1e-2, 5e-3)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_CARD_CASES + [
                             # the first f32 kernels' key tile (32) and
                             # query tile (64) edges, and the training
                             # path's MQA shape
                             (1, 2, 1, 31, 33, 32, True, 0, 0.0),
                             (1, 2, 2, 65, 97, 64, True, 32, 0.0),
                             (2, 10, 1, 128, 128, 256, True, 2048, 0.0),
                             # the bf16 kernels' tiles: 64 keys, 64 query
                             # rows; a tile short, exact, one over, at
                             # each head dim
                             (1, 2, 1, 63, 63, 32, True, 0, 0.0),
                             (1, 2, 1, 64, 64, 64, True, 0, 0.0),
                             (1, 2, 1, 65, 65, 128, True, 0, 0.0),
                             (1, 10, 1, 63, 65, 256, True, 0, 0.0),
                             (2, 10, 1, 129, 129, 256, True, 64, 0.0),
                             (1, 8, 2, 127, 191, 128, True, 65, 30.0),
                             (2, 6, 3, 100, 163, 64, False, 63, 0.0),
                             (1, 4, 1, 1, 64, 256, True, 0, 50.0),
                             (1, 10, 1, 257, 257, 32, True, 128, 0.0)])
def test_flash_attention_backward_kernel(card, B, Hq, Hkv, Sq, Skv, hd,
                                         causal, window, softcap, dtype):
    """The backward kernel against the plain backward on the same q, k, v,
    output and output gradient, one launch a call: given the forward
    kernel's log-sum-exp and without it, both within ``BWD_TOL``, and
    the same gradients bit for bit from a second call."""
    from repro_torch.kernels import flash_attention as fa
    g = torch.Generator(device=card).manual_seed(Sq * 7 + Skv + hd)
    q = torch.randn((B, Hq, Sq, hd), generator=g, device=card).to(dtype)
    k = torch.randn((B, Hkv, Skv, hd), generator=g, device=card).to(dtype)
    v = torch.randn((B, Hkv, Skv, hd), generator=g, device=card).to(dtype)
    do = torch.randn((B, Hq, Sq, hd), generator=g, device=card).to(dtype)
    out = ref.flash_attention(q, k, v, causal, window, softcap)
    _, lse = fa.flash_attention(q, k, v, causal, window, softcap,
                                return_lse=True)
    want = ref.flash_attention_backward(q, k, v, out, do, causal, window,
                                        softcap)
    for given in (None, lse):
        before = LAUNCHES["flash_attention_backward"]
        got = fa.flash_attention_backward(q, k, v, out, do, causal, window,
                                          softcap, lse=given)
        assert LAUNCHES["flash_attention_backward"] == before + 1
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.dtype == dtype
            assert_grad_close(a, b, *BWD_TOL[dtype])
    again = fa.flash_attention_backward(q, k, v, out, do, causal, window,
                                        softcap, lse=lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# the f32 backward's tiles: dK/dV tiles of 64 keys walking steps of 16
# query rows, dQ tiles of 64 rows walking 16-key tiles; a tile short,
# exact, one over, at hd 32 and 256; 7 (b)'s MQA shape at reduced length
BWD_F32_EDGE_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap
    (1, 2, 1, 15, 63, 32, True, 0, 0.0),           # a step and a key tile short
    (1, 2, 1, 16, 64, 256, True, 0, 0.0),          # exact
    (1, 2, 1, 17, 65, 32, True, 0, 0.0),           # one over
    (1, 2, 1, 63, 79, 256, True, 16, 0.0),         # dQ rows short, window a tile
    (2, 2, 2, 64, 64, 32, True, 15, 0.0),          # exact, window a key short
    (1, 4, 2, 65, 65, 256, True, 17, 30.0),        # one over, softcap
    (1, 10, 1, 320, 320, 256, True, 256, 0.0),     # 7 (b), cut in length
]


@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         BWD_F32_EDGE_CASES)
def test_flash_attention_backward_float32_tile_edges(card, B, Hq, Hkv, Sq, Skv,
                                                 hd, causal, window, softcap):
    """The f32 backward at its tile edges, within ``BWD_TOL`` f32, and
    the same gradients from a second call."""
    test_flash_attention_backward_kernel(card, B, Hq, Hkv, Sq, Skv, hd,
                                         causal, window, softcap,
                                         torch.float32)


def test_flash_attention_backward_float32_split_runs_are_deterministic(card):
    """A shape whose first key tiles are cut into several runs (the
    scratch holds dK/dV partials): within ``BWD_TOL`` f32, and two calls
    give equal gradients (the runs are summed in order, no atomics)."""
    from repro_torch.kernels import flash_attention as fa
    B, Hq, Hkv, S, hd, window = 1, 10, 1, 512, 256, 384
    _, scratch_size = fa._backward_fns(torch.float32)
    assert scratch_size(B, Hq, Hkv, S, S, hd, 1, window) > B * Hq * S
    test_flash_attention_backward_kernel(card, B, Hq, Hkv, S, S, hd, True,
                                         window, 0.0, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_autograd_through_the_kernels_on_the_card(card, dtype):
    """``ops.flash_attention`` and ``ops.rglru_scan`` on CUDA tensors give
    gradients (no dropped ones) equal to the backward kernels' outputs;
    attention's forward hands its log-sum-exp to the backward (one launch
    each way)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=card).manual_seed(11)
    q, k, v = (torch.randn((2, 96, h, 64), generator=g, device=card)
               .to(dtype).requires_grad_(True) for h in (4, 2, 2))
    do = torch.randn((2, 96, 4, 64), generator=g, device=card).to(dtype)
    before = dict(LAUNCHES)
    out = ops.flash_attention(q, k, v, causal=True, window=40, softcap=0.0)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    assert LAUNCHES["flash_attention"] == before["flash_attention"] + 1
    assert LAUNCHES["flash_attention_backward"] == \
        before["flash_attention_backward"] + 1
    lt = [x.detach().transpose(1, 2) for x in (q, k, v)]
    _, lse = fa.flash_attention(*lt, True, 40, 0.0, return_lse=True)
    want = fa.flash_attention_backward(
        *lt, out.detach().transpose(1, 2), do.transpose(1, 2).contiguous(),
        True, 40, 0.0, lse=lse)
    for a, b in zip(got, want):
        assert torch.equal(a, b.transpose(1, 2))
    a = torch.sigmoid(torch.randn((2, 70, 96), generator=g, device=card)
                      ).to(dtype).requires_grad_(True)
    b = torch.randn((2, 70, 96), generator=g, device=card).to(
        dtype).requires_grad_(True)
    dh = torch.randn((2, 70, 96), generator=g, device=card).to(dtype)
    h = ops.rglru_scan(a, b)
    before = LAUNCHES["rglru_scan_backward"]
    got = torch.autograd.grad(h, (a, b), dh)
    assert LAUNCHES["rglru_scan_backward"] == before + 1
    want = rg.rglru_scan_backward(a.detach(), h.detach(), dh)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,w", [(2, 128, 64), (1, 257, 130), (3, 64, 32),
                                   (1, 1, 5), (1, 17, 33), (8, 512, 2560),
                                   (2, 4096, 2560),
                                   # one step; S past a 64-step tile; S
                                   # past a 16-step tile (160 channels)
                                   (1, 1, 2560), (2, 65, 40), (8, 33, 2560),
                                   # w < 8 (odd: element loads in bf16)
                                   (3, 70, 7), (2, 9, 3),
                                   # B = 1 at full width; B = 16 (256
                                   # channels a block, more blocks than SMs)
                                   (1, 129, 2560), (16, 40, 2560)])
def test_rglru_scan_backward_kernel(card, B, S, w, dtype):
    """Bit-exact against the plain backward: one reverse f32 chain a
    channel, the product rounded before the sum; ragged S (a last tile of
    fewer steps, walked first) and w (rows of 520, 260, 14 and 6 bytes
    take 4-byte copies or element loads), and two calls give the same
    gradients."""
    from repro_torch.kernels import rglru_scan as rg
    g = torch.Generator(device=card).manual_seed(B * S + w + 1)
    a = torch.sigmoid(torch.randn((B, S, w), generator=g, device=card)
                      ).to(dtype)
    h = torch.randn((B, S, w), generator=g, device=card).to(dtype)
    dh = torch.randn((B, S, w), generator=g, device=card).to(dtype)
    before = LAUNCHES["rglru_scan_backward"]
    got = rg.rglru_scan_backward(a, h, dh)
    assert LAUNCHES["rglru_scan_backward"] == before + 1
    want = ref.rglru_scan_backward(a, h, dh)
    assert all(x.dtype == dtype and torch.equal(x, y)
               for x, y in zip(got, want))
    again = rg.rglru_scan_backward(a, h, dh)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_rglru_scan_backward_kernel_unaligned_base(card, offset, dtype):
    """a, h and dh that start 1-3 elements past an aligned address
    (contiguous views into larger buffers) take 4-byte copies or element
    loads, and the gradients still match bit for bit."""
    from repro_torch.kernels import rglru_scan as rg
    B, S, w = 2, 300, 64
    g = torch.Generator(device=card).manual_seed(offset + 7)
    n = B * S * w

    def view(x):
        return x.to(dtype)[offset:].view(B, S, w)

    a = view(torch.sigmoid(torch.randn(n + offset, generator=g,
                                       device=card)))
    h, dh = (view(torch.randn(n + offset, generator=g, device=card))
             for _ in range(2))
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    got = rg.rglru_scan_backward(a, h, dh)
    want = ref.rglru_scan_backward(a, h, dh)
    assert all(x.dtype == dtype and torch.equal(x, y)
               for x, y in zip(got, want))


@pytest.mark.parametrize("arch,changes", [
    ("recurrentgemma-2b", {}), ("gemma2-2b", {"num_kv_heads": 2}),
    ("qwen2-moe-a2.7b", {}), ("qwen3-moe-30b-a3b", {"num_kv_heads": 2}),
    ("qwen2-7b", {}), ("phi3-medium-14b", {})])
def test_reduced_lm_loss_gradients_on_the_card_match_the_cpu(card, arch,
                                                              changes):
    """``lm_loss`` and every gradient leaf of the reduced model on the
    card (the forward and backward kernels) against the CPU (the plain
    versions, held against ``jax.grad`` by ``tests/test_torch_lm_grad.py``):
    the loss within 1e-5 relative, each leaf within 1e-4 of its largest
    entry."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map, unflatten
    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 128)))
    out = {}
    for dev, params in (("cpu", cpu),
                        (card, tree_map(lambda t: t.to(card), cpu))):
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        before = dict(LAUNCHES)
        loss, _ = T.lm_loss(unflatten(params, live),
                            {"tokens": toks.to(dev)}, cfg)
        loss.backward()
        out[str(dev)] = (loss.item(), [t.grad.cpu() for t in live])
        if dev != "cpu":
            kinds = cfg.layer_kinds
            for name, n in (("flash_attention_backward",
                             sum(k != "rglru" for k in kinds)),
                            ("rglru_scan_backward",
                             sum(k == "rglru" for k in kinds))):
                assert LAUNCHES[name] - before[name] == n, name
    (lc, gc), (lg, gg) = out["cpu"], out[str(card)]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert_grad_close(a, b, 0.0, 1e-4)


@pytest.mark.parametrize("arch,changes", [
    ("recurrentgemma-2b", {}), ("gemma2-2b", {"num_kv_heads": 2}),
    ("qwen2-moe-a2.7b", {}), ("qwen3-moe-30b-a3b", {"num_kv_heads": 2}),
    ("qwen2-7b", {}), ("phi3-medium-14b", {})])
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


# ------------------------------------------------------- the MoE serving path --
# the Qwen models' attention: head dim 128, MHA (qwen2-moe, 16:16) and GQA
# (qwen3-moe, 32:4), causal, at the prefill's 4,096 tokens
FLASH_HD128_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap
    (2, 16, 16, 4096, 4096, 128, True, 0, 0.0),
    (1, 32, 4, 4096, 4096, 128, True, 0, 0.0),
]


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 4e-3)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_HD128_CASES)
def test_flash_attention_qwen_shapes(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                     window, softcap, dtype, rtol, atol):
    """The forward at the Qwen models' prefill shapes, at the limits of
    ``test_flash_attention_kernel``."""
    test_flash_attention_kernel(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                window, softcap, dtype, rtol, atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_HD128_CASES)
def test_flash_attention_backward_qwen_shapes(card, B, Hq, Hkv, Sq, Skv, hd,
                                              causal, window, softcap, dtype):
    """The backward at the same shapes, within ``BWD_TOL``, two calls
    equal."""
    test_flash_attention_backward_kernel(card, B, Hq, Hkv, Sq, Skv, hd,
                                         causal, window, softcap, dtype)


def _moe_on(device, arch, dtype, T, capacity_factor, reduced=True):
    """(moe params, moe config, x (2, T / 2, d) drawn with an offset, so
    that the router prefers some experts) of ``arch``'s MoE layer, reduced
    or at full width, on ``device``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_map
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    m = dataclasses.replace(cfg.moe, capacity_factor=capacity_factor)
    g = torch.Generator().manual_seed(T)
    params = M.init_moe(g, cfg.d_model, m)
    x = torch.randn((2, T // 2, cfg.d_model), generator=g) + 0.5
    return (tree_map(lambda t: t.to(device), params), m,
            x.to(device).to(dtype))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("capacity_factor", [4.0, 1.25])
def test_apply_moe_on_the_card_matches_the_cpu(card, arch, capacity_factor):
    """The reduced MoE layer (f32) on the card against the CPU path (held
    against the reference by ``tests/test_torch_moe.py``): the same kept
    assignments, the output within 1e-5 of its largest entry, the aux
    within 1e-6 relative; two calls on the card give equal outputs."""
    from repro_torch.models import moe as M
    from repro_torch.tree import tree_map
    p, m, x = _moe_on(card, arch, torch.float32, 256, capacity_factor)
    cpu = tree_map(lambda t: t.cpu(), p)
    got, aux = M.apply_moe(p, x, m)
    again, aux2 = M.apply_moe(p, x, m)
    assert torch.equal(got, again) and torch.equal(aux, aux2)
    want, want_aux = M.apply_moe(cpu, x.cpu(), m)
    C = M.expert_capacity(m, 256, 128)
    plans = [M.dispatch(M.route(q, x.reshape(256, -1).to(dev), m)[2], C,
                        m.num_experts)
             for q, dev in ((p, card), (cpu, "cpu"))]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(*plans))
    assert_grad_close(got.cpu(), want, 0.0, 1e-5)
    assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


def test_apply_moe_bf16_is_deterministic_and_never_syncs(card):
    """qwen2-moe's MoE layer at full width (60 experts, top 4, the shared
    expert) in bf16 over 2 x 512 tokens, with drops (capacity 1.25): no
    host sync (``set_sync_debug_mode("error")``), and two calls give equal
    outputs (the combine adds in a fixed order, no atomics)."""
    from repro_torch.models import moe as M
    p, m, x = _moe_on(card, "qwen2-moe-a2.7b", torch.bfloat16, 1024, 1.25,
                      reduced=False)
    M.apply_moe(p, x, m)                      # warm-up: allocations, handles
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, aux = M.apply_moe(p, x, m)
        again, aux2 = M.apply_moe(p, x, m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got, again) and torch.equal(aux, aux2)
    C = M.expert_capacity(m, 1024, 512)
    _, slot = M.dispatch(M.route(p, x.reshape(1024, -1), m)[2], C,
                         m.num_experts)
    assert int((slot == m.num_experts * C).sum()) > 0      # drops happened
    assert bool(torch.isfinite(got).all())


# ----------------------------------------- HuBERT and Qwen2-VL (head dim 80) --
# head dim 80: the bf16 kernels' exact 80-wide tiles (the backward's dK/dV
# a 128-key block a CTA, 64 keys a warpgroup), the f32 kernels' five
# 16-column steps (dQ's halves of 40); bidirectional and causal, ragged
# Sq = Skv, GQA 2:1 and 4:1, HuBERT's 1,000 frames
FLASH_HD80_CASES = [
    # B, Hq, Hkv, Sq, Skv, hd, causal, window, softcap
    (2, 16, 16, 200, 200, 80, False, 0, 0.0),      # bidirectional, ragged
    (1, 4, 2, 129, 129, 80, True, 0, 0.0),         # causal, GQA 2:1, ragged
    (1, 4, 2, 64, 64, 80, False, 0, 0.0),          # bidirectional GQA, a tile
    (1, 2, 1, 100, 230, 80, True, 64, 0.0),        # window, Skv > Sq
    (1, 16, 16, 1000, 1000, 80, False, 0, 0.0),    # HuBERT's 20 s of frames
    (1, 8, 2, 300, 300, 80, False, 0, 0.0),        # GQA 4:1, ragged
    # each 128-key block's 32 steps in 16 runs: the runs' sum launches
    (1, 2, 1, 1024, 1024, 80, False, 0, 0.0),
    # window 256 under GQA 4:1 in runs of 6 steps: a run holds the last
    # query tile that sees warpgroup 0's keys and the 4 dead steps after it
    (1, 8, 2, 2048, 2048, 80, True, 256, 0.0),
    # softcaps: causal GQA 2:1 ragged, and a window under GQA 4:1
    (1, 4, 2, 129, 129, 80, True, 0, 50.0),
    (1, 8, 2, 300, 300, 80, True, 64, 30.0),
]


@pytest.mark.parametrize("dtype,rtol,atol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 1e-2, 4e-3)],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_HD80_CASES)
def test_flash_attention_hd80(card, B, Hq, Hkv, Sq, Skv, hd, causal, window,
                              softcap, dtype, rtol, atol):
    """The forward at head dim 80, at the limits of
    ``test_flash_attention_kernel``, and the same output bit for bit from
    a second call."""
    test_flash_attention_kernel(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                window, softcap, dtype, rtol, atol)
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn((B, S, H, hd), generator=g, device=card).to(dtype)
               for S, H in ((Sq, Hq), (Skv, Hkv), (Skv, Hkv)))
    a = ops.flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    b = ops.flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap)
    assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,hd,causal,window,softcap",
                         FLASH_HD80_CASES)
def test_flash_attention_backward_hd80(card, B, Hq, Hkv, Sq, Skv, hd, causal,
                                       window, softcap, dtype):
    """The backward at head dim 80, within ``BWD_TOL``, two calls equal."""
    test_flash_attention_backward_kernel(card, B, Hq, Hkv, Sq, Skv, hd,
                                         causal, window, softcap, dtype)


HUBERT_VARIANTS = {"reduced": {},
                   "hd80": {"d_model": 160, "num_heads": 2,
                            "num_kv_heads": 2, "head_dim": 80}}


@pytest.mark.parametrize("name", list(HUBERT_VARIANTS))
def test_reduced_hubert_on_the_card_matches_the_cpu(card, name):
    """The reduced HuBERT (and its head-dim-80 variant) from the same
    weights on the card and the CPU (held against the reference by
    ``tests/test_torch_audio.py``) over 200 frames: logits within 1e-4 of
    the largest, the masked-prediction loss within 1e-5 relative and each
    gradient leaf within 1e-4 of its largest entry; one bidirectional
    attention launch a layer each way."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map, unflatten
    cfg = dataclasses.replace(get_config("hubert-xlarge").reduced(),
                              **HUBERT_VARIANTS[name])
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    batch = {"embeds": torch.from_numpy(rng.normal(
                 size=(2, 200, cfg.d_model)).astype(np.float32)),
             "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                      (2, 200))),
             "target_mask": torch.from_numpy(
                 (rng.random((2, 200)) < 0.5).astype(np.float32))}
    out = {}
    for dev, params in (("cpu", cpu),
                        (card, tree_map(lambda t: t.to(card), cpu))):
        on = {k: v.to(dev) for k, v in batch.items()}
        logits, _ = T.forward(params, {"embeds": on["embeds"]}, cfg)
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        before = dict(LAUNCHES)
        loss, _ = T.lm_loss(unflatten(params, live), on, cfg)
        loss.backward()
        if dev != "cpu":
            for kernel in ("flash_attention", "flash_attention_backward"):
                assert LAUNCHES[kernel] - before[kernel] == cfg.num_layers
        out[str(dev)] = (logits.cpu(), loss.item(),
                         [t.grad.cpu() for t in live])
    (xc, lc, gc), (xg, lg, gg) = out["cpu"], out[str(card)]
    assert_grad_close(xg, xc, 0.0, 1e-4)
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    for a, b in zip(gg, gc):
        assert_grad_close(a, b, 0.0, 1e-4)


def image_positions(S, start, rows, cols):
    """Qwen2-VL's (3, S) positions: text, one image of rows x cols patches
    at ``start`` (t = start, h and w start + row and start + column), text
    resuming at the largest position + 1."""
    n = rows * cols
    pos = np.empty((3, S), np.int64)
    pos[:, :start] = np.arange(start)
    r, c = np.divmod(np.arange(n), cols)
    pos[:, start:start + n] = start
    pos[1, start:start + n] += r
    pos[2, start:start + n] += c
    pos[:, start + n:] = pos[:, :start + n].max() + 1 + np.arange(
        S - start - n)
    return pos


def test_reduced_qwen2_vl_on_the_card_matches_the_cpu(card):
    """The reduced Qwen2-VL from the same weights on the card and the CPU
    (held against the reference by ``tests/test_torch_vlm.py``): with 64
    patch embeddings scattered at 16..79 and the image-layout M-RoPE
    positions, logits within 1e-4 of the largest; greedy ``serve()``
    completions identical."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_requests, serve
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = get_config("qwen2-vl-72b").reduced()
    cpu = T.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    gpu = tree_map(lambda t: t.to(card), cpu)
    rng = np.random.default_rng(2)
    pos = image_positions(128, 16, 8, 8)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                     (2, 128))),
             "patch_embeds": torch.from_numpy(rng.normal(
                 size=(2, 64, cfg.d_model)).astype(np.float32)),
             "patch_positions": torch.arange(16, 80).expand(2, 64),
             "positions": torch.from_numpy(pos)[:, None].expand(3, 2, 128)}
    LAUNCHES["flash_attention"] = 0
    got, _ = T.forward(gpu, {k: v.to(card) for k, v in batch.items()}, cfg)
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    want, _ = T.forward(cpu, batch, cfg)
    assert_grad_close(got.cpu(), want, 0.0, 1e-4)
    reqs = make_requests(4, 12, cfg.vocab_size, seed=0)
    a, _ = serve(cfg, reqs, batch=2, gen=8, params=gpu, device=card)
    b, _ = serve(cfg, reqs, batch=2, gen=8, params=cpu, device="cpu")
    assert a == b


@pytest.mark.parametrize("pos", [524_287, 196_608])
def test_attention_merge_at_the_production_piece_size(card, pos):
    """gemma2-2b x long_500k on pod16x16: one global layer's bf16 cache of
    524,288 slots in 256 pieces of 2,048; the pieces' f32 partial
    attentions merged (``merge_pieces``) against the one-piece result
    within 1e-5 of its largest entry, with every slot valid and with 159
    pieces empty."""
    from repro_torch.configs import get_config
    from repro_torch.launch.profile_mesh import MERGE_PIECES, merge_check

    cfg = get_config("gemma2-2b")
    g = torch.Generator(device=card).manual_seed(0)
    shape = (1, 524_288, cfg.num_kv_heads, cfg.head_dim)
    k = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    v = torch.randn(shape, generator=g, device=card).to(torch.bfloat16)
    q = torch.randn((1, 1, cfg.num_heads, cfg.head_dim), generator=g,
                    device=card).to(torch.bfloat16)
    err, empty = merge_check(cfg, k, v, q, pos)
    assert empty == (0 if pos == 524_287 else 159)
    assert MERGE_PIECES == 256 and err <= 1e-5
