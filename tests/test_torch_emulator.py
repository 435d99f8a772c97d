"""The slice as a whole: the port's Emulator against the reference's.

Same config, dataset, initial parameters and failure seed (the fixture of
``tests/test_emulator.py``).  Exact: the overhead charges (save, load,
lost, resched), ``measured_pls``, ``n_failures``, ``T_save`` and
``bytes_written``.  AUC and final loss within ``AUC_TOL``/``LOSS_TOL``:
both sides train in f32 but sum in different orders (XLA vs PyTorch CPU
kernels), and the rounding differences compound over 28 steps and two
partial restores.  Measured on the CPU: 0 for ``full`` and ``cpr-mfu``,
6e-5 (AUC) and 1.5e-4 (loss) for ``cpr``; the limits leave 10× room.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_KAGGLE, scaled
from repro.core import CPRManager as RManager
from repro.core import Emulator as REmulator
from repro.core import FailureInjector as RInjector
from repro.core import SystemParams as RParams
from repro.data.synthetic import ClickLogDataset as RDS
from repro.models import dlrm as RD
from repro_torch import core as T
from repro_torch.data.synthetic import ClickLogDataset as TDS

AUC_TOL = 2e-3
LOSS_TOL = 2e-3
SSU_AUC_TOL = 0.03     # different eviction draws (torch vs jax streams)


@pytest.fixture(scope="module")
def setup():
    cfg = scaled(DLRM_KAGGLE, max_rows=2000)
    rds = RDS(cfg.table_sizes, num_samples=8000, seed=3)
    tds = TDS(cfg.table_sizes, num_samples=8000, seed=3)
    init = jax.tree.map(np.asarray, RD.init_dlrm(cfg, jax.random.PRNGKey(0)))
    return cfg, rds, tds, init


def _run_both(setup, mode, backend):
    cfg, rds, tds, init = setup
    p = RParams()
    rmgr = RManager(mode, p, cfg.table_sizes, target_pls=0.1,
                    tracker_backend=backend)
    rinj = RInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
    ref = REmulator(cfg, rds, rmgr, rinj, batch_size=256).run()
    tp = T.SystemParams()
    tmgr = T.CPRManager(mode, tp, cfg.table_sizes, target_pls=0.1,
                        tracker_backend=backend, device="cpu")
    tinj = T.FailureInjector(2, 0.25, tp.N_emb, tp.T_total, seed=11)
    port = T.Emulator(cfg, tds, tmgr, tinj, batch_size=256, device="cpu",
                      init_params=init).run()
    return ref, port


def _assert_policy_identical(ref, port, with_bytes=True):
    a, b = ref.report, port.report
    keys = ("save", "load", "lost", "resched") if with_bytes else \
        ("load", "lost", "resched")
    for k in keys:
        assert b["overheads"][k] == a["overheads"][k], k
    for k in ("measured_pls", "n_failures", "T_save", "effective_mode",
              "expected_pls", "save_interval"):
        assert b[k] == a[k], k
    assert b["pls_by_shard"] == a["pls_by_shard"]
    if with_bytes:
        assert b["bytes_written"] == a["bytes_written"]
    assert port.n_steps == ref.n_steps


@pytest.mark.parametrize("mode,backend", [("full", "host"), ("cpr", "host"),
                                          ("cpr-mfu", "host"),
                                          ("cpr-mfu", "pallas")])
def test_emulator_matches_reference(setup, mode, backend):
    ref, port = _run_both(setup, mode, backend)
    _assert_policy_identical(ref, port)
    assert port.report["n_failures"] == 2
    assert abs(port.auc - ref.auc) <= AUC_TOL
    assert abs(port.final_loss - ref.final_loss) <= LOSS_TOL
    if backend == "pallas":           # the port's name for the same backend
        assert port.report["tracker_backend"] == "kernel"


def test_emulator_cpr_ssu_policy_matches_reference(setup):
    ref, port = _run_both(setup, "cpr-ssu", "host")
    _assert_policy_identical(ref, port, with_bytes=False)
    assert abs(port.auc - ref.auc) <= SSU_AUC_TOL


def test_async_directory_store_matches_sync_memory(setup, tmp_path):
    """The async writer and the disk store change where the bytes go, not
    the policy: same charges, PLS and bytes as the sync memory store, and
    the directory reloads to the final image."""
    cfg, _, tds, init = setup
    out = {}
    for name, kw in (("sync", {}),
                     ("async", {"async_save": True,
                                "directory": str(tmp_path / "ckpt")})):
        p = T.SystemParams()
        mgr = T.CPRManager("cpr-mfu", p, cfg.table_sizes, device="cpu",
                           tracker_backend="kernel", **kw)
        inj = T.FailureInjector(2, 0.25, p.N_emb, p.T_total, seed=11)
        emu = T.Emulator(cfg, tds, mgr, inj, batch_size=256, device="cpu",
                         init_params=init)
        out[name] = (emu.run(max_steps=12), mgr)
    (rs, ms), (ra, ma) = out["sync"], out["async"]
    assert ra.report["bytes_written"] == rs.report["bytes_written"]
    assert ra.report["measured_pls"] == rs.report["measured_pls"]
    loaded = T.CheckpointStore.load_latest(
        str(tmp_path / "ckpt"), ma.store.image_tables, ma.store.image_accs,
        ma.spec)
    for a, b in zip(loaded.image_tables, ma.store.image_tables):
        np.testing.assert_array_equal(a, b)
    # a new run resumes from that directory (flat layout)
    p = T.SystemParams()
    mgr = T.CPRManager("cpr", p, cfg.table_sizes, device="cpu")
    res = T.Emulator(cfg, tds, mgr, T.FailureInjector(0, 0.25, p.N_emb,
                                                      p.T_total),
                     batch_size=256, device="cpu").run(
        max_steps=1, resume_from=str(tmp_path / "ckpt"))
    assert res.n_steps == 1 and np.isfinite(res.final_loss)


def test_entry_points_refuse_to_run_without_a_gpu(setup):
    """Without device="cpu" the port expects CUDA; with none available it
    raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg, _, tds, _ = setup
    p = T.SystemParams()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.CPRManager("full", p, cfg.table_sizes)
    mgr = T.CPRManager("full", p, cfg.table_sizes, device="cpu")
    inj = T.FailureInjector(0, 0.25, p.N_emb, p.T_total)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.Emulator(cfg, tds, mgr, inj)


@pytest.mark.parametrize("kw", [{"sharded_save": True}, {"writer_procs": True},
                                {"transport": "socket"}, {"attach": True},
                                {"parity_group_size": 2}])
def test_sharded_fleet_arguments_wait_for_slice_2(kw):
    with pytest.raises(NotImplementedError, match="slice 2"):
        T.CPRManager("cpr", T.SystemParams(), (10, 20), device="cpu", **kw)
