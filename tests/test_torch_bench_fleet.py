"""The port's fleet figures (``benchmarks_torch`` fig15 and fig17; fig16
in ``test_torch_bench_reshard.py``) against the reference's harness
(``benchmarks``), on the CPU.

Both harnesses run at the same small sizes (the reference's
``FAST_OVERRIDES`` or smaller).  Held:

- every deterministic field equal: fig15's ``total_rows``, ``bytes``, the
  ``delta_save`` byte counts, the ``bytes_lost_at_crash`` byte counts and
  reconstructions, ``socket_wire_bytes``' raw and wire bytes; fig17's
  server counts, the wire bytes
  of ``shm_full_handoff`` and of the reshard stream (the frames are
  byte-identical and zlib is the same library).  The reference's socket
  fleets without a directory (``compressed_reshard``'s) cannot reshard in
  place: they send None where the spec says str, the server refuses the
  frame, and each donor waits out a 60 s drain timeout and is respawned.
  The port sends "" there, so the stream is compared with a directory on
  both sides;
- every audit field true on both sides;
- the port's ``delta_save`` and ``bytes_lost_at_crash`` rows equal
  ``artifacts/bench/fig15.json``'s at its own size (``FAST_OVERRIDES``);
- the port's hashes equal the reference's numpy ``row_hash`` on every
  shape class of ``_bench_hash``.  The reference's own ``hash_kernel`` row
  cannot run here (its Pallas ``row_hash`` needs ``enable_x64``, which
  jax 0.9.0 dropped), so its ``_bench_mux``, ``_bench_reshard`` and
  ``_bench_shm`` are called directly.

Timing fields are each device's own and are never compared.  Auto-spawned
socket servers are hosted on threads of the test process in both packages
(a spawned server costs seconds to start); the pipe writers are real
processes.
"""
import itertools
import json
import sys
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))       # the harnesses are top-level packages

import benchmarks.fig15_sharded_save as R15  # noqa: E402
import benchmarks.fig17_wire as R17  # noqa: E402
import benchmarks.run as RRUN  # noqa: E402
import benchmarks_torch.fig15_sharded_save as T15  # noqa: E402
import benchmarks_torch.fig17_wire as T17  # noqa: E402
import benchmarks_torch.run as TRUN  # noqa: E402
from repro.analysis.protocol import spec as r_spec  # noqa: E402
from repro.core import transport as r_transport  # noqa: E402
from repro.core.checkpoint import EmbShardSpec as RSpec  # noqa: E402
from repro.core.sharded_checkpoint import ShardedCheckpointWriter as RWriter  # noqa: E402,E501
from repro.core.sharded_checkpoint import row_hash as r_row_hash  # noqa: E402
from repro.launch import shard_server as r_server  # noqa: E402
from repro_torch.analysis.protocol import spec as t_spec  # noqa: E402
from repro_torch.core import transport as t_transport  # noqa: E402
from repro_torch.core.checkpoint import EmbShardSpec as TSpec  # noqa: E402
from repro_torch.core.sharded_checkpoint import ShardedCheckpointWriter as TWriter  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import shard_server as t_server  # noqa: E402

ARTIFACTS = ROOT / "artifacts" / "bench"
FIG15 = {"max_rows": 2000, "n_shards": (2,), "events": 2,
         "lost_shards": (2,)}
FIG17 = {"max_rows": 2000, "n_shards": 2, "mux_group": 2, "events": 2}
AUDITS = ("image_matches_sync", "image_matches_oracle", "image_matches_raw",
          "parity_strictly_below", "parity_image_matches_oracle",
          "readmit_ok", "compressed_fewer_bytes", "shm_verified",
          "hash_kernel_exact", "mux_fewer_servers", "shm_fewer_bytes")
EXACT = {
    "save_event": ("backend", "n_shards", "total_rows", "bytes"),
    "delta_save": ("n_shards", "first_bytes", "unchanged_resave_bytes",
                   "changed_rows", "partial_resave_bytes", "skip_ratio"),
    "pipe_snapshot_path": ("n_shards", "total_rows"),
    "socket_save_event": ("n_shards", "total_rows"),
    "socket_wire_bytes": ("n_shards", "raw_sent", "wire_sent",
                          "wire_ratio"),
    "bytes_lost_at_crash": ("n_shards", "total_rows",
                            "stamped_replay_lost_bytes",
                            "parity_reconstruct_lost_bytes",
                            "parity_reconstructions"),
    "readmission": ("n_shards",),
    "reshard": ("backend", "from_shards", "to_shards", "total_rows",
                "moved_mb"),
}


class _ThreadServer:
    """Stands in for an auto-spawned shard server process: the package's
    ``serve`` on a daemon thread of this process, with a pid of its own
    (the mux row counts servers by pid)."""
    _pids = itertools.count(1 << 22)

    def __init__(self, module):
        ready, box = threading.Event(), {}

        def cb(h, p):
            box["hp"] = (h, p)
            ready.set()

        threading.Thread(target=module.serve, args=("127.0.0.1", 0, cb),
                         daemon=True).start()
        assert ready.wait(10.0)
        self.address = box["hp"]
        self.pid = next(self._pids)
        self._alive = True

    def is_alive(self):
        return self._alive

    def kill(self):
        self._alive = False

    def join(self, timeout=None):
        pass


@pytest.fixture(scope="module", autouse=True)
def thread_servers():
    with pytest.MonkeyPatch.context() as mp:
        for transport, server in ((r_transport, r_server),
                                  (t_transport, t_server)):
            def spawn(connect_timeout, name, server=server):
                srv = _ThreadServer(server)
                return srv.address, srv
            mp.setattr(transport, "spawn_loopback_server", spawn)
            if hasattr(transport, "spawn_loopback_servers"):    # the port
                mp.setattr(transport, "spawn_loopback_servers",
                           lambda timeout, names, spawn=spawn:
                           [spawn(timeout, n) for n in names])
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(n)


def _by_kind(rows):
    out = {}
    for row in rows:
        out.setdefault(row["kind"], []).append(row)
    return out


def _audits_true(row):
    bad = [k for k in AUDITS if k in row and row[k] is not True]
    assert not bad, (row, bad)


def _side_by_side(*calls):
    """The runs of both harnesses at once (each mostly waits on its writer
    processes), in the order given."""
    with ThreadPoolExecutor(len(calls)) as pool:
        futures = [pool.submit(call) for call in calls]
        return [f.result() for f in futures]


FAST_KINDS = ("delta_save", "bytes_lost_at_crash")


@pytest.fixture(scope="module")
def fig15_rows():
    """(reference, port) rows at ``FIG15``'s size, and the port's
    ``FAST_KINDS`` rows at the reference's ``FAST_OVERRIDES``."""
    return tuple(map(_by_kind, _side_by_side(
        lambda: R15.run(**FIG15), lambda: T15.run(**FIG15, device="cpu"),
        lambda: T15.run(**TRUN.FAST_OVERRIDES["fig15"], device="cpu",
                        kinds=FAST_KINDS))))


@pytest.mark.parametrize("kind", T15.KINDS)
def test_fig15_rows_match_reference(fig15_rows, kind):
    want, got, _ = (rows.get(kind) for rows in fig15_rows)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert set(a) == set(b)
        assert {k: a[k] for k in EXACT[kind]} == \
            {k: b[k] for k in EXACT[kind]}
        _audits_true(a)
        _audits_true(b)


@pytest.mark.parametrize("kind", FAST_KINDS)
def test_fig15_fast_rows_equal_the_reference_artifact(fig15_rows, kind):
    """``delta_save`` and ``bytes_lost_at_crash`` at the artifact's own
    size (the reference's ``FAST_OVERRIDES``: 26,777 rows)."""
    got = fig15_rows[2][kind]
    want = _by_kind(json.loads((ARTIFACTS / "fig15.json").read_text()))[kind]
    assert [{k: r[k] for k in EXACT[kind]} for r in got] == \
        [{k: r[k] for k in EXACT[kind]} for r in want]
    for r in got:
        _audits_true(r)
    if kind == "bytes_lost_at_crash":
        assert {r["total_rows"] for r in got} == {26_777}


@pytest.fixture(scope="module")
def fig17_rows():
    return {r["kind"]: r for r in T17.run(**FIG17, hash_rows=3000,
                                          device="cpu")}


def _fig17_sizes():
    m = FIG17["max_rows"]
    return (m, m // 2, m // 4), 16


def test_fig17_mux_matches_reference(fig17_rows):
    sizes, d = _fig17_sizes()
    res = R17._bench_mux(sizes, d, FIG17["n_shards"], FIG17["mux_group"],
                         FIG17["events"])
    row = fig17_rows["mux_save_event"]
    assert (row["per_conn_servers"], row["mux_servers"]) == \
        (res["per_conn"][2], res["mux"][2])
    assert res["per_conn"][1] and res["mux"][1]
    _audits_true(row)


def _reshard_wire(writer_cls, spec_cls, tables, accs, directory, codec):
    """``_bench_reshard``'s grow resize of a socket fleet, with a
    directory: (wire counters, image)."""
    n = FIG17["n_shards"]
    writer = writer_cls(
        [np.array(t) for t in tables], [np.array(a) for a in accs],
        spec_cls([len(t) for t in tables], n), directory=str(directory),
        backend="socket", delta_saves=False,
        transport_options={"codec_level": codec} if codec else {})
    writer.save_full(tables, accs, step=0)
    writer.fence()
    writer.resize(2 * n, step=1)
    wire = writer.wire_stats
    wt, wa, _ = writer.restore_all()
    writer.close()
    return wire, wt + wa


@pytest.mark.parametrize("codec", [0, 6])
def test_fig17_reshard_stream_matches_reference(tmp_path, codec):
    """The reshard stream's frames are byte-identical: the same resize
    through either package's socket fleet (in the same directory, one
    after the other) counts the same raw and wire bytes, to the same
    image."""
    sizes, d = _fig17_sizes()
    tables, accs = R17._state(sizes, d)
    want, want_img = _reshard_wire(RWriter, RSpec, tables, accs,
                                   tmp_path / "ck", codec)
    shutil.rmtree(tmp_path / "ck")          # the same paths in the frames
    got, got_img = _reshard_wire(TWriter, TSpec, tables, accs,
                                 tmp_path / "ck", codec)
    assert got == want
    assert all(np.array_equal(a, b) for a, b in zip(got_img, want_img))


def test_fig17_compressed_reshard_row(fig17_rows, monkeypatch):
    """The port's row, and its reshard frames: a fleet without a
    directory sends "" in the frame's directory slot, which the spec
    types str.  The reference sends None, which its own spec refuses, so
    its donors wait out a 60 s drain and respawn instead of resharding
    in place."""
    row = fig17_rows["compressed_reshard"]
    assert row["codec_wire_bytes"] < row["raw_wire_bytes"]
    _audits_true(row)
    frame = ("reshard", 1, [8, 4], 2, [[0, 4, 8], [0, 2, 4]], None,
             [], [], None)
    assert "directory" in r_spec.violation(frame)
    sent = []
    send = t_transport.SockChannel.send

    def record(chan, msg):
        sent.append(msg)
        return send(chan, msg)

    monkeypatch.setattr(t_transport.SockChannel, "send", record)
    sizes, d = _fig17_sizes()
    wire, _, _ = T17._bench_reshard(sizes, d, 2, 4, 0, "cpu")
    frames = [m for m in sent if m[0] == "reshard"]
    assert frames and all(t_spec.violation(m) is None for m in frames)
    assert not [m for m in sent if m[0] == "error"]


def test_fig17_shm_handoff_matches_reference(fig17_rows):
    sizes, d = _fig17_sizes()
    res = R17._bench_shm(sizes, d, FIG17["n_shards"], FIG17["events"])
    row = fig17_rows["shm_full_handoff"]
    assert row["streamed_wire_bytes"] == res["streamed"][2]["wire_sent"]
    assert row["shm_wire_bytes"] == res["shm"][2]["wire_sent"]
    assert res["streamed"][1] and res["shm"][1] and res["shm"][3]
    _audits_true(row)


@pytest.mark.parametrize("n,d", [(0, 8), (1, 1), (7, 3), (257, 5),
                                 (3000, 16), (4, 0)])
def test_fig17_hashes_equal_the_reference_numpy_hash(fig17_rows, n, d):
    """The port's row hash (the plain version here; the kernel on the
    card, held to it bit for bit) against the reference's numpy loop, on
    every shape class of ``_bench_hash``."""
    _audits_true(fig17_rows["hash_kernel"])
    rng = np.random.default_rng(n * 10 + d)
    v = rng.normal(size=(n, d)).astype(np.float32)
    a = (np.abs(rng.normal(size=n)).astype(np.float32) if d else
         np.zeros((n, 0), np.float32))
    got = ops.row_hash(torch.from_numpy(v), torch.from_numpy(a))
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  r_row_hash(v, a))


def test_fast_overrides_are_the_references():
    for name in ("fig15", "fig16", "fig17"):
        assert TRUN.FAST_OVERRIDES[name] == RRUN.FAST_OVERRIDES[name]
    names = [n for n, _, _ in TRUN.BENCHMARKS]
    assert names == [n for n, _, _ in RRUN.BENCHMARKS]
