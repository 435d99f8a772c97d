"""The port's sharded writer fleet against the reference's, on the CPU.

* The same schedule of ``save_full`` / ``save_rows`` / ``save_trainer`` /
  ``fence`` through the port's writer (torch CPU tensors or numpy) and the
  reference's (numpy): equal returned byte counts, delta counters and
  per-shard bytes, byte-identical images, and equal manifests apart from
  timestamps — over the inproc, pipe and socket transports, with delta
  saves on and off.  Every ``hash_backend`` name is accepted and selects
  nothing: on the CPU the ledger hashes with the plain ``row_hash``.
* Interop: a port coordinator fences through a reference ``shard_server``
  and a reference coordinator through the port's.
* ``CPRManager(sharded_save=True)`` in the port and the reference on the
  scaled config: identical charges, PLS, bytes and delta counts.
* Emulator resume from a sharded directory the other package wrote.
* A SIGKILLed pipe writer, one resize and one ``attach`` takeover.

Socket fleets here connect to shard servers hosted on threads of the test
process, as the reference's failover tests do (auto-spawned servers cost
seconds per shard to start and to stop; ``chip_smoke.py`` drives those).
"""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs.dlrm import DLRM_KAGGLE, scaled
from repro.core import CPRManager as RManager
from repro.core import Emulator as REmulator
from repro.core import FailureInjector as RInjector
from repro.core import SystemParams as RParams
from repro.core.checkpoint import EmbShardSpec as REmbShardSpec
from repro.core.checkpoint import resolve_run_dir
from repro.core.sharded_checkpoint import ShardedCheckpointWriter as RWriter
from repro.core.sharded_checkpoint import load_latest_auto as r_load_auto
from repro.data.synthetic import ClickLogDataset as RDS
from repro.launch import shard_server as r_server
from repro.models import dlrm as RD
from repro_torch import core as T
from repro_torch.core.sharded_checkpoint import ShardedCheckpointWriter as TWriter
from repro_torch.data.synthetic import ClickLogDataset as TDS
from repro_torch.launch import shard_server as t_server

SIZES = (40, 23, 7)
D = 4
N_SHARDS = 3
LOSS_TOL = 2e-3


def make_state(seed=0):
    rng = np.random.default_rng(seed)
    tables = [rng.standard_normal((n, D)).astype(np.float32) for n in SIZES]
    accs = [rng.random(n).astype(np.float32) for n in SIZES]
    trainer = {"bottom": [rng.standard_normal((3, 2)).astype(np.float32)],
               "top": [rng.standard_normal(2).astype(np.float32)]}
    return tables, accs, trainer


def _thread_server(module):
    """A shard server on a daemon thread of this process; its (host,
    port)."""
    ready, addr = threading.Event(), {}

    def cb(h, p):
        addr["hp"] = (h, p)
        ready.set()

    threading.Thread(target=module.serve, args=("127.0.0.1", 0, cb),
                     daemon=True).start()
    assert ready.wait(10.0)
    return addr["hp"]


def _schedule(tables, accs, trainer):
    """The save calls both writers see: (method, args, kwargs)."""
    v1 = [t + 1 for t in tables]
    a1 = [a + 1 for a in accs]
    tr1 = {k: [x + 1 for x in v] for k, v in trainer.items()}
    rows0 = np.array([0, 3, 5, 39])
    vals0 = v1[0][rows0].copy()
    vals0[2:] += 7                       # rows 0 and 3 unchanged: skipped
    rows1 = np.array([-1, 2, 22, 23, 50])   # three out of range
    vals1 = np.zeros((5, D), np.float32) + 3
    rows2 = np.arange(SIZES[2])
    vals2 = v1[2].copy()
    vals2[::2] -= 1
    return [
        ("save_full", (v1, a1, tr1), {"step": 1}),
        ("save_rows", (0, rows0, vals0, a1[0][rows0]), {"step": 2}),
        ("save_rows", (1, rows1, vals1, np.ones(5, np.float32)), {"step": 2}),
        ("fence", (), {}),
        ("save_rows", (0, np.array([5, 6]),
                       np.stack([vals0[2], vals0[2] * 2]),
                       np.array([a1[0][5], 9.0], np.float32)), {"step": 3}),
        ("save_trainer", ({k: [x * 2 for x in v]
                           for k, v in trainer.items()},), {"step": 3}),
        ("save_full", ([t + 2 for t in tables], [a + 2 for a in accs]),
         {"step": 4}),
        ("save_rows", (2, rows2, vals2, a1[2]), {"step": 5}),
        ("fence", (), {}),
    ]


def _to_torch(x):
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x.copy())
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    return x


def _strip(m):
    return {**m, "events": [{k: v for k, v in e.items() if k != "time"}
                            for e in m["events"]]}


def _manifest(root):
    with open(os.path.join(resolve_run_dir(root), "manifest.json")) as f:
        return _strip(json.load(f))


def _drive(writer_cls, spec, root, tensors=False, **kw):
    tables, accs, trainer = make_state()
    t, a, tr = ((_to_torch(tables), _to_torch(accs), _to_torch(trainer))
                if tensors else (tables, accs, trainer))
    fleet = writer_cls(t, a, spec, tr, directory=str(root),
                       drain_timeout=30.0, **kw)
    returns = []
    for name, args, kwargs in _schedule(tables, accs, trainer):
        if tensors:
            args = _to_torch(args)
        returns.append(getattr(fleet, name)(*args, **kwargs))
    out = {"returns": returns,
           "image": fleet.restore_all()[:2],
           "counters": {k: getattr(fleet, k) for k in (
               "bytes_written", "delta_rows_skipped", "delta_bytes_skipped",
               "dropped_bytes", "shard_bytes", "shard_events", "cycle",
               "hash_backend")}}
    fleet.close()
    out["manifest"] = _manifest(str(root))
    return out


def _assert_same(ref, port):
    assert port["returns"] == ref["returns"]
    assert port["counters"] == ref["counters"]
    for a, b in zip(ref["image"], port["image"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert port["manifest"] == ref["manifest"]


@pytest.mark.parametrize("backend,delta,hash_backend,tensors", [
    ("inproc", True, "kernel", True),
    ("inproc", False, "host", False),
    ("pipe", True, "host", True),
    ("pipe", False, "pallas", False),
    ("socket", True, "kernel", True),
])
def test_schedule_matches_reference(tmp_path, backend, delta, hash_backend,
                                    tensors):
    kw = {"backend": backend, "delta_saves": delta}
    rkw, tkw = dict(kw), dict(kw, hash_backend=hash_backend)
    if backend == "socket":
        rkw["addresses"] = [_thread_server(r_server)] * N_SHARDS
        tkw["addresses"] = [_thread_server(t_server)] * N_SHARDS
    ref = _drive(RWriter, REmbShardSpec(SIZES, N_SHARDS), tmp_path / "r",
                 **rkw)
    port = _drive(TWriter, T.EmbShardSpec(SIZES, N_SHARDS), tmp_path / "p",
                  tensors=tensors, **tkw)
    _assert_same(ref, port)
    if delta:
        assert port["counters"]["delta_rows_skipped"] > 0
    # either package loads the other's directory to the same image
    tables, accs, trainer = make_state()
    got = T.load_latest_auto(str(tmp_path / "r"), tables, accs,
                             T.EmbShardSpec(SIZES, N_SHARDS),
                             trainer_state=trainer).restore_all()
    want = r_load_auto(str(tmp_path / "p"), tables, accs,
                       REmbShardSpec(SIZES, N_SHARDS),
                       trainer_state=trainer).restore_all()
    for x, y in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_array_equal(x, y)
    for x, y in zip(jax.tree.leaves(got[2]), jax.tree.leaves(want[2])):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("coordinator", ["port", "reference"])
def test_coordinator_fences_through_the_other_packages_server(tmp_path,
                                                               coordinator):
    """The frames are the same bytes: a port coordinator drives reference
    writers and the reverse, to the reference's own result."""
    spec_r, spec_t = REmbShardSpec(SIZES, N_SHARDS), T.EmbShardSpec(
        SIZES, N_SHARDS)
    oracle = _drive(RWriter, spec_r, tmp_path / "oracle", backend="inproc")
    if coordinator == "port":
        addr = _thread_server(r_server)
        got = _drive(TWriter, spec_t, tmp_path / "x", tensors=True,
                     backend="socket", hash_backend="kernel",
                     addresses=[addr] * N_SHARDS)
    else:
        addr = _thread_server(t_server)
        got = _drive(RWriter, spec_r, tmp_path / "x", backend="socket",
                     addresses=[addr] * N_SHARDS)
    _assert_same(oracle, got)


# ------------------------------------------------------------- manager ----

@pytest.fixture(scope="module")
def scaled_setup():
    cfg = scaled(DLRM_KAGGLE, max_rows=2000)
    rds = RDS(cfg.table_sizes, num_samples=8000, seed=3)
    tds = TDS(cfg.table_sizes, num_samples=8000, seed=3)
    init = jax.tree.map(np.asarray, RD.init_dlrm(cfg, jax.random.PRNGKey(0)))
    return cfg, rds, tds, init


@pytest.mark.parametrize("mode", ["full", "cpr-mfu"])
def test_sharded_manager_matches_reference(scaled_setup, mode):
    cfg, rds, tds, init = scaled_setup
    p = RParams()
    rmgr = RManager(mode, p, cfg.table_sizes, target_pls=0.1,
                    sharded_save=True)
    ref = REmulator(cfg, rds, rmgr, RInjector(2, 0.25, p.N_emb, p.T_total,
                                              seed=11),
                    batch_size=256).run(max_steps=12)
    tp = T.SystemParams()
    tmgr = T.CPRManager(mode, tp, cfg.table_sizes, target_pls=0.1,
                        sharded_save=True, hash_backend="kernel",
                        device="cpu")
    port = T.Emulator(cfg, tds, tmgr, T.FailureInjector(
        2, 0.25, tp.N_emb, tp.T_total, seed=11), batch_size=256,
        device="cpu", init_params=init).run(max_steps=12)
    a, b = ref.report, port.report
    for k in ("save", "load", "lost", "resched"):
        assert b["overheads"][k] == a["overheads"][k], k
    for k in ("measured_pls", "pls_by_shard", "n_failures", "bytes_written",
              "shard_bytes", "shard_events", "delta_rows_skipped",
              "delta_bytes_skipped", "dropped_bytes", "poisoned_shards",
              "coordinator_epoch", "layout_epoch"):
        assert b[k] == a[k], k
    assert b["sharded_save"] and b["writer_backend"] == "inproc"
    assert b["hash_backend"] == a["hash_backend"] == "host"
    if mode == "cpr-mfu":
        assert b["delta_rows_skipped"] > 0
        assert any(h["event"] == "failure" for h in tmgr.history)
    assert abs(port.auc - ref.auc) <= LOSS_TOL


def test_emulator_resumes_from_the_other_packages_sharded_directory(
        scaled_setup, tmp_path):
    """Each package writes the same state as a sharded directory; each
    loads the other's bit for bit, and an Emulator of each resumes from
    the other's directory to the same first-step loss (a run that ignored
    the directory would start from a different random init)."""
    cfg, rds, tds, init = scaled_setup
    rng = np.random.default_rng(5)
    tables = [np.asarray(t) for t in init["tables"]]
    accs = [np.zeros(len(t), np.float32) for t in tables]
    trainer = {"bottom": init["bottom"], "top": init["top"]}
    saved_t = [t + rng.standard_normal(t.shape).astype(np.float32) * 0.05
               for t in tables]
    saved_a = [a + rng.random(a.shape).astype(np.float32) for a in accs]
    saved_tr = jax.tree.map(lambda x: x * 0.9, trainer)
    dirs = {"reference": str(tmp_path / "r"), "port": str(tmp_path / "p")}
    for name, cls, spec in (("reference", RWriter, REmbShardSpec),
                            ("port", TWriter, T.EmbShardSpec)):
        w = cls(tables, accs, spec(cfg.table_sizes, 8), trainer,
                directory=dirs[name])
        w.save_full(saved_t, saved_a, saved_tr, step=1)
        w.fence()
        w.close()
    got = T.load_latest_auto(dirs["reference"], tables, accs,
                             T.EmbShardSpec(cfg.table_sizes, 8)).restore_all()
    want = r_load_auto(dirs["port"], tables, accs,
                       REmbShardSpec(cfg.table_sizes, 8)).restore_all()
    for x, y, z in zip(got[0] + got[1], want[0] + want[1],
                       saved_t + saved_a):
        np.testing.assert_array_equal(x, z)
        np.testing.assert_array_equal(y, z)
    p = RParams()
    ref = REmulator(cfg, rds, RManager("full", p, cfg.table_sizes),
                    RInjector(0, 0.25, p.N_emb, p.T_total),
                    batch_size=256).run(max_steps=1,
                                        resume_from=dirs["port"])
    tp = T.SystemParams()
    port = T.Emulator(cfg, tds, T.CPRManager("full", tp, cfg.table_sizes,
                                             device="cpu"),
                      T.FailureInjector(0, 0.25, tp.N_emb, tp.T_total),
                      batch_size=256, device="cpu").run(
        max_steps=1, resume_from=dirs["reference"])
    assert abs(port.final_loss - ref.final_loss) <= 1e-5


# ------------------------------------------------ crash, resize, attach ----

def _image_of(root, spec, tables, accs):
    return T.load_latest_auto(root, tables, accs, spec).restore_all()


def test_sigkilled_pipe_writer_recovers_to_its_last_stamp(tmp_path):
    tables, accs, _ = make_state()
    spec = T.EmbShardSpec(SIZES, 2)
    root = str(tmp_path)
    fleet = TWriter(_to_torch(tables), _to_torch(accs), spec, directory=root,
                    backend="pipe", delta_saves=True, hash_backend="kernel",
                    drain_timeout=30.0)
    v1 = [t + 1 for t in tables]
    a1 = [a + 1 for a in accs]
    fleet.save_full(_to_torch(v1), _to_torch(a1), step=1)
    fleet.fence()                                    # cycle 1
    dead_pid = fleet.procs[1].pid
    fleet.kill_shard(1)
    v2 = [t + 2 for t in tables]
    a2 = [a + 2 for a in accs]
    fleet.save_full(_to_torch(v2), _to_torch(a2), step=2)
    with pytest.raises(T.ShardSaveError) as ei:
        fleet.fence()                                # cycle 2: shard 0 only
    assert sorted(ei.value.shard_errors) == [1]
    assert fleet.dropped_bytes > 0
    got_t, got_a, _ = _image_of(root, spec, tables, accs)
    for t in range(len(SIZES)):
        for j, (vt, va) in ((0, (v2, a2)), (1, (v1, a1))):
            lo, hi = spec.shard_range(t, j)
            np.testing.assert_array_equal(got_t[t][lo:hi], vt[t][lo:hi])
            np.testing.assert_array_equal(got_a[t][lo:hi], va[t][lo:hi])
    # re-admission respawns the writer and reseeds it with the current rows
    assert fleet.readmit(_to_torch(v2), _to_torch(a2), step=3) == [1]
    assert fleet.procs[1].pid != dead_pid
    fleet.fence()
    fleet.close()
    got_t, got_a, _ = _image_of(root, spec, tables, accs)
    for t in range(len(SIZES)):
        np.testing.assert_array_equal(got_t[t], v2[t])
        np.testing.assert_array_equal(got_a[t], a2[t])


def _check_resize(tmp_path, tables, accs, v1, a1):
    """The same schedule through both packages: a 3 -> 2 merge between
    two stamped cycles gives equal manifests and images."""
    out = {}
    for name, cls, spec_cls in (("ref", RWriter, REmbShardSpec),
                                ("port", TWriter, T.EmbShardSpec)):
        d = str(tmp_path / name)
        f = cls(tables, accs, spec_cls(SIZES, 3), directory=d)
        f.save_full(v1, a1, step=1)
        f.fence()
        info = f.resize(2, step=2)
        f.save_rows(0, np.array([1, 30]), np.full((2, D), 5, np.float32),
                    np.full(2, 5, np.float32), step=3)
        f.fence()
        out[name] = (info["to"], f.layout_epoch, f.restore_all()[:2],
                     f.delta_rows_skipped)
        f.close()
        out[name] += (_manifest(d),)
    (r_to, r_ep, r_img, r_skip, r_man) = out["ref"]
    (t_to, t_ep, t_img, t_skip, t_man) = out["port"]
    assert (t_to, t_ep, t_skip) == (r_to, r_ep, r_skip) == (2, 2, 0)
    for x, y in zip(r_img[0] + r_img[1], t_img[0] + t_img[1]):
        np.testing.assert_array_equal(x, y)
    assert t_man == r_man
    assert any(e["kind"] == "layout" for e in t_man["events"])


def _check_attach(tmp_path, tables, accs, v1, a1, trainer):
    """A standby adopts the fleet at the last stamp; the superseded
    coordinator can no longer stamp."""
    root = str(tmp_path / "port")
    spec = T.EmbShardSpec(SIZES, 2)
    first = TWriter(_to_torch(tables), _to_torch(accs), spec, trainer,
                    directory=root, hash_backend="kernel")
    first.save_full(_to_torch(v1), _to_torch(a1), trainer, step=1)
    first.fence()                                    # the stamp to land on
    first.save_rows(0, np.array([2, 3]), np.full((2, D), 9, np.float32),
                    np.full(2, 9, np.float32), step=2)   # never stamped
    standby = TWriter.attach(root, tables, accs, spec, trainer_state=trainer,
                             hash_backend="kernel")
    assert standby.epoch == first.epoch + 1
    got_t, got_a, _ = standby.restore_all()
    for t in range(len(SIZES)):
        np.testing.assert_array_equal(got_t[t], v1[t])
        np.testing.assert_array_equal(got_a[t], a1[t])
    with pytest.raises(T.StaleCoordinatorError):
        first.fence()
    # the standby's ledger was re-based on the stamped image: resaving
    # the stamped rows is skipped
    assert standby.save_rows(0, np.arange(SIZES[0]), v1[0], a1[0]) == 0
    assert standby.delta_rows_skipped == SIZES[0]
    standby.close()
    first.transport.close()


@pytest.mark.parametrize("step", ["resize", "attach"])
def test_resize_and_attach_takeover(tmp_path, step):
    tables, accs, trainer = make_state()
    v1 = [t + 1 for t in tables]
    a1 = [a + 1 for a in accs]
    if step == "resize":
        _check_resize(tmp_path, tables, accs, v1, a1)
    else:
        _check_attach(tmp_path, tables, accs, v1, a1, trainer)


def test_full_saves_between_fences_are_not_pinned():
    """A fleet with no directory never fences in ``full`` mode: the host
    snapshot of every save_full must be freed once its writers have it,
    not pinned by the transport until a fence (at full Kaggle width each
    one is 2.3 GB).  Inproc, so every byte is in this process."""
    import gc
    import tracemalloc
    rows = 1 << 16
    tables = [np.zeros((rows, 4), np.float32)]
    accs = [np.zeros(rows, np.float32)]
    fleet = TWriter(tables, accs, T.EmbShardSpec((rows,), 2),
                    backend="inproc", async_save=True, delta_saves=False)
    snap_bytes = tables[0].nbytes + accs[0].nbytes
    tracemalloc.start()
    try:
        for i in range(1, 11):
            fleet.save_full([t + i for t in tables], [a + i for a in accs])
        for ep in fleet.endpoints:       # the writers have every snapshot
            np.testing.assert_array_equal(ep.fetch_image(30.0)[0][0],
                                          (tables[0] + 10)[
                                              slice(*fleet.ranges[ep.shard][0])])
        gc.collect()
        held, _ = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert held < 3 * snap_bytes, held
    fleet.close()
