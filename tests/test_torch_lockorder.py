"""The port's runtime lock-order sanitizer over the port's fleet, held
against the reference's.

Each workload runs once under the port's own
``repro_torch.analysis.lockorder.LockOrderSanitizer()`` and once under the
reference's ``repro.analysis.lockorder.LockOrderSanitizer(package=
"repro_torch")``.  Each is installed before the workload builds its fleet,
so every lock, re-entrant lock and condition that the port's source
constructs (``core/transport.py``, ``core/sharded_checkpoint.py``,
``launch/shard_server.py``) is tracked, and is uninstalled in a
``finally``.  Under each sanitizer a workload must track constructions and
leave an acyclic acquisition-order graph, and both must track the same
construction sites:

* failover: the CPR manager's sharded fleet under injected failures,
  asynchronous saves (the emulator at test size), and a SIGKILLed pipe
  writer re-admitted;
* reshard: a 3 -> 2 shard merge between stamped cycles, and an
  ``attach`` takeover by a standby coordinator;
* process transports: the pipe writers above, and a socket fleet with a
  mux group over shard servers on threads of this process, killed and
  re-admitted.
"""
import numpy as np
# numpy imports numpy.random on first use, and its bit generators bind
# threading.Lock then: imported under a sanitizer, every generator's lock
# would go on being made by that sanitizer's factory after it uninstalls
import numpy.random  # noqa: F401
import pytest
import torch

from repro.analysis import lockorder as r_lockorder
from repro_torch import core as T
from repro_torch.analysis import lockorder as t_lockorder
from repro_torch.configs.dlrm import DLRM_KAGGLE, scaled
from repro_torch.core.sharded_checkpoint import ShardedCheckpointWriter
from repro_torch.data.synthetic import ClickLogDataset
from repro_torch.launch import shard_server

SIZES = (40, 23, 7)
D = 4


def _state(seed=0):
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
              for n in SIZES]
    accs = [torch.from_numpy(rng.random(n).astype(np.float32)) for n in SIZES]
    return tables, accs


def _bumped(xs, by):
    return [x + by for x in xs]


def _failover_manager(tmp_path):
    cfg = scaled(DLRM_KAGGLE, max_rows=2000)
    ds = ClickLogDataset(cfg.table_sizes, num_samples=4000, seed=3)
    p = T.SystemParams()
    mgr = T.CPRManager("cpr-mfu", p, cfg.table_sizes, target_pls=0.1,
                       sharded_save=True, async_save=True,
                       directory=str(tmp_path), device="cpu")
    T.Emulator(cfg, ds, mgr, T.FailureInjector(2, 0.25, p.N_emb, p.T_total,
                                               seed=11),
               batch_size=256, device="cpu").run(max_steps=12)
    assert any(h["event"] == "failure" for h in mgr.history)


def _failover_pipe(tmp_path):
    tables, accs = _state()
    fleet = ShardedCheckpointWriter(tables, accs, T.EmbShardSpec(SIZES, 2),
                                    directory=str(tmp_path), backend="pipe",
                                    delta_saves=True, drain_timeout=30.0)
    fleet.save_full(_bumped(tables, 1), _bumped(accs, 1), step=1)
    fleet.fence()
    fleet.kill_shard(1)
    fleet.save_full(_bumped(tables, 2), _bumped(accs, 2), step=2)
    with pytest.raises(T.ShardSaveError):
        fleet.fence()
    assert fleet.readmit(_bumped(tables, 2), _bumped(accs, 2), step=3) == [1]
    fleet.fence()
    fleet.close()


def _reshard(tmp_path):
    tables, accs = _state()
    fleet = ShardedCheckpointWriter(tables, accs, T.EmbShardSpec(SIZES, 3),
                                    directory=str(tmp_path / "resize"))
    fleet.save_full(_bumped(tables, 1), _bumped(accs, 1), step=1)
    fleet.fence()
    assert fleet.resize(2, step=2)["to"] == 2
    fleet.save_rows(0, np.array([1, 30]), np.full((2, D), 5, np.float32),
                    np.full(2, 5, np.float32), step=3)
    fleet.fence()
    fleet.close()

    root = str(tmp_path / "attach")
    spec = T.EmbShardSpec(SIZES, 2)
    first = ShardedCheckpointWriter(tables, accs, spec, directory=root)
    first.save_full(_bumped(tables, 1), _bumped(accs, 1), step=1)
    first.fence()
    standby = ShardedCheckpointWriter.attach(root, tables, accs, spec)
    with pytest.raises(T.StaleCoordinatorError):
        first.fence()
    standby.save_full(_bumped(tables, 3), _bumped(accs, 3), step=2)
    standby.fence()
    standby.close()
    first.transport.close()


def _thread_server():
    import threading
    ready, addr = threading.Event(), {}

    def cb(h, p):
        addr["hp"] = (h, p)
        ready.set()

    threading.Thread(target=shard_server.serve, args=("127.0.0.1", 0, cb),
                     daemon=True).start()
    assert ready.wait(10.0)
    return addr["hp"]


def _socket(tmp_path):
    tables, accs = _state()
    addr = _thread_server()
    fleet = ShardedCheckpointWriter(
        tables, accs, T.EmbShardSpec(SIZES, 3), directory=str(tmp_path),
        backend="socket", addresses=[addr] * 3, delta_saves=True,
        drain_timeout=30.0, transport_options={"mux_group": 3})
    fleet.save_full(_bumped(tables, 1), _bumped(accs, 1), step=1)
    fleet.save_rows(0, np.array([0, 3]), np.full((2, D), 7, np.float32),
                    np.full(2, 7, np.float32), step=2)
    fleet.fence()
    got_t, _, _ = fleet.restore_all()
    np.testing.assert_array_equal(got_t[2], (tables[2] + 1).numpy())
    fleet.close()


WORKLOADS = {"failover_manager": _failover_manager,
             "failover_pipe": _failover_pipe, "reshard": _reshard,
             "socket": _socket}


SANITIZERS = {
    "port": lambda: t_lockorder.LockOrderSanitizer(),
    "reference": lambda: r_lockorder.LockOrderSanitizer(
        package="repro_torch")}
_RUNS = {}


def _run(tmp_path_factory, name, which):
    """The workload under one sanitizer (once a session): the sanitizer
    and the construction sites it tracked."""
    if (name, which) not in _RUNS:
        san = SANITIZERS[which]()
        sites = set()
        wrap = san.wrap

        def recording(inner, site):
            sites.add(site)
            return wrap(inner, site)

        san.wrap = recording
        san.install()
        try:
            WORKLOADS[name](tmp_path_factory.mktemp(f"{name}-{which}"))
        finally:
            san.uninstall()
        _RUNS[name, which] = san, sites
    return _RUNS[name, which]


@pytest.mark.parametrize("which", list(SANITIZERS))
@pytest.mark.parametrize("name", list(WORKLOADS))
def test_port_fleet_lock_order_is_acyclic(tmp_path_factory, name, which):
    san, sites = _run(tmp_path_factory, name, which)
    assert san.tracked_constructions > 0
    san.assert_acyclic()
    assert all(not s.startswith("/") and ".py:" in s for s in sites)
    other = "reference" if which == "port" else "port"
    assert sites == _run(tmp_path_factory, name, other)[1]
