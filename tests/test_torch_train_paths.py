"""The port's LM training driver on the paths that take over or reshape the
writer fleet, on the CPU, against the reference's driver: a coordinator
that attaches to the previous one's fleet (``attach=True``), a live fleet
resize under training (``resize_at``), and writer processes over the pipe
and socket transports.

The setup and limits are ``test_torch_train.py``'s: both drivers start
from the reference's initial parameters and read the same tokens; losses
agree within 1e-4 relative, and the policy, the events and every fleet
field of the report that both sides have are equal.  Each package writes
into its own directory.  Socket shard servers run on threads of the test
process in both packages (a spawned server takes seconds to start and to
stop); the pipe writers are real processes.
"""
import pytest

from repro.core import transport as r_transport
from repro.launch import shard_server as r_server
from repro.launch import train as ref_train
from repro_torch.core import transport as t_transport
from repro_torch.launch import shard_server as t_server
from repro_torch.launch import train as port_train

from test_torch_bench_fleet import _ThreadServer
from test_torch_train import _two_threads  # noqa: F401  (autouse fixture)
from test_torch_train import (RUN, _configs, _init, assert_losses_close,
                              assert_policy_identical)

FLEET = ("shard_bytes", "shard_events", "delta_rows_skipped",
         "delta_bytes_skipped", "dropped_bytes", "shard_failures",
         "coordinator_epoch", "attach")
ATTACH = ("cycle", "adopted", "respawned", "poisoned")


@pytest.fixture
def thread_servers(monkeypatch):
    """Auto-spawned socket shard servers on threads of this process, in
    both packages."""
    for transport, server in ((r_transport, r_server),
                              (t_transport, t_server)):
        def spawn(connect_timeout, name, server=server):
            srv = _ThreadServer(server)
            return srv.address, srv
        monkeypatch.setattr(transport, "spawn_loopback_server", spawn)
        if hasattr(transport, "spawn_loopback_servers"):    # the port
            monkeypatch.setattr(transport, "spawn_loopback_servers",
                                lambda timeout, names, spawn=spawn:
                                [spawn(timeout, n) for n in names])


def train_both(tmp_path, mode="cpr-mfu", runs=({},), **kw):
    """Each package's ``train()`` over the runs (each run's own keywords
    over ``kw`` and ``RUN``), in its own checkpoint directory: the
    histories, by package."""
    cfg_ref, cfg = _configs()
    out = {"ref": [], "port": []}
    for side in out:
        d = str(tmp_path / side)
        for run in runs:
            args = {**RUN, "checkpoint_dir": d, **kw, **run}
            if side == "ref":
                _, h = ref_train.train(cfg_ref, mode=mode, **args)
            else:
                _, h = port_train.train(cfg, mode=mode, device="cpu",
                                        params=_init(cfg_ref), **args)
            out[side].append(h)
    return out


def assert_runs_agree(ref, port):
    """Losses, policy, events and the fleet fields of one run."""
    a, b = ref["report"], port["report"]
    assert b["sharded_save"] and a["sharded_save"]
    assert b["writer_backend"] == a["writer_backend"]
    assert_policy_identical(a, b)
    for k in FLEET:
        assert (k in b) == (k in a), k
        if k in a:
            assert b[k] == a[k], k
    assert port["events"] == ref["events"]
    assert_losses_close(ref, port)


def test_attach_takes_over_the_fleet_and_warms_the_trainer(tmp_path):
    """A first run saves through the inproc fleet into a directory and
    ends; a second ``train(..., attach=True)`` on that directory takes
    over at the next coordinator epoch and starts from the stamped image,
    in both packages alike."""
    out = train_both(tmp_path, runs=({"steps": 4},
                                     {"steps": 3, "attach": True}),
                     sharded_save=True)
    for a, b in zip(out["ref"], out["port"]):
        assert_runs_agree(a, b)
    first, second = out["port"]
    rep = second["report"]
    assert any(e[0] == "failure" for e in first["events"] + second["events"])
    assert rep["coordinator_epoch"] == first["report"]["coordinator_epoch"] + 1
    assert rep["attach"]["cycle"] is not None
    ref_rep = out["ref"][1]["report"]
    for k in ATTACH:
        assert rep["attach"][k] == ref_rep["attach"][k], k
    # the second run starts from the stamped weights, not the initial ones
    assert second["loss"][0][1] != first["loss"][0][1]


def test_live_resize_under_training(tmp_path):
    """``resize_at={2: 4}`` reshards the 8-shard inproc fleet to 4 shards
    while training runs: the resize lands at step 2 in both packages and
    the saves after it write the same bytes."""
    out = train_both(tmp_path, sharded_save=True, n_emb=8,
                     resize_at={2: 4})
    (ref,), (port,) = out["ref"], out["port"]
    assert ("resize", 2, 4) in port["events"]
    assert_runs_agree(ref, port)


@pytest.mark.parametrize("transport", ["pipe", "socket"])
def test_writer_processes_over_a_transport(tmp_path, thread_servers,
                                           transport):
    """``writer_procs=True`` with the pipe or socket transport, under 2
    failures: the fleet fields and losses equal the reference's over the
    same transport."""
    out = train_both(tmp_path, writer_procs=True, transport=transport,
                     n_emb=2)
    (ref,), (port,) = out["ref"], out["port"]
    assert port["report"]["writer_backend"] == transport
    assert port["report"]["n_failures"] == RUN["n_failures"]
    assert_runs_agree(ref, port)
