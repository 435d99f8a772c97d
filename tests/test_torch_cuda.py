"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the check runs
inside the ``card`` fixture, never at import).  On a GPU machine:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Edge shapes the full-width smoke run does not reach: ragged segments,
k > seg, empty and invalid pending ids, no candidates, a reservoir that
spans several compaction tiles, more candidates than one block has threads.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import LAUNCHES, ops, ref


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


@pytest.mark.parametrize("N,M,k,seg", [(1000, 300, 25, 256), (7, 3, 2, 512),
                                       (512, 0, 10, 128), (513, 11, 4, 256),
                                       (100, 50, 100, 512), (300, 40, 700, 64),
                                       (100_003, 5000, 64, 2048)])
def test_tracker_select_kernel(card, N, M, k, seg):
    rng = np.random.default_rng(N + M)
    counts = torch.from_numpy(rng.integers(0, 5, N).astype(np.int32)).to(card)
    pend = torch.from_numpy(rng.integers(-20, N + 20, M).astype(np.int32)
                            ).to(card)
    got_i, got_c = ops.tracker_select(counts, pend, k, seg_size=seg)
    want_i, want_c = ref.tracker_select(counts, pend, k, seg_size=seg)
    assert torch.equal(got_i, want_i) and torch.equal(got_c, want_c)


@pytest.mark.parametrize("rn,nc,live,tied", [(16, 12, 13, False),
                                             (32, 24, 32, False),
                                             (32, 24, 32, True),
                                             (8, 0, 8, False),
                                             (10_000, 300, 10_000, False),
                                             (10_000, 300, 4_000, False),
                                             (20_000, 3000, 20_000, True)])
def test_ssu_dedupe_evict_kernel(card, rn, nc, live, tied):
    rng = np.random.default_rng(rn + nc)
    EMPTY = ref.EMPTY
    buf = np.full(rn, EMPTY, np.int32)
    buf[:live] = np.sort(rng.choice(10 * rn, size=live, replace=False))
    c = rng.choice(10 * rn, size=nc).astype(np.int32)
    c[: nc // 4] = rng.choice(buf[:live], size=nc // 4)
    u = np.unique(c)
    cand = np.full(nc, EMPTY, np.int32)
    cand[:u.size] = u
    scores = rng.uniform(size=rn + nc).astype(np.float32)
    if tied:
        scores = np.floor(scores * 8) / 8
    args = [torch.from_numpy(a).to(card) for a in (buf, cand, scores)]
    assert torch.equal(ops.ssu_dedupe_evict(*args), ref.ssu_dedupe_evict(*args))


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
