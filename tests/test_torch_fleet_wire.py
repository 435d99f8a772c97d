"""The fleet suites that only the reference held, run through both
packages: XOR parity stripes and reconstruction (``tests/test_parity.py``),
the coordinator lease (``LEASE_PTR``, clock-skew slack, forced and expired
takeovers), the hardened wire codec and socket framing, mux and shm
handoff (``tests/test_wire_hardening.py``,
``tests/test_protocol_fuzz.py``), and the spec-derived fuzz of a live
shard server: the port's own fuzzer (``repro_torch.analysis.protocol.
fuzz``, its tables on the CPU) against the reference's, seed for seed.

Every case runs on each package's writer (numpy tables, so the port's
ledger is on the CPU) and compares what comes back: images, byte counts,
parity reports and counters, which shards a fault poisons, and the
errors raised (their type and message).  Auto-spawned socket servers are
hosted on threads of the test process in both packages.
"""
import json
import os
import socket
import struct
import time
import zlib
from types import SimpleNamespace

import numpy as np
import pytest
from test_torch_bench_fleet import _ThreadServer

from repro.analysis.protocol import fuzz as r_fuzz
from repro.analysis.protocol import spec as r_spec
from repro.core import checkpoint as r_checkpoint
from repro.core import sharded_checkpoint as r_sc
from repro.core import transport as r_transport
from repro.launch import shard_server as r_server
from repro_torch.analysis.protocol import fuzz as t_fuzz
from repro_torch.analysis.protocol import spec as t_spec
from repro_torch.core import checkpoint as t_checkpoint
from repro_torch.core import sharded_checkpoint as t_sc
from repro_torch.core import transport as t_transport
from repro_torch.launch import shard_server as t_server

PKGS = {
    name: SimpleNamespace(
        Writer=sc.ShardedCheckpointWriter, Spec=ck.EmbShardSpec, sc=sc,
        transport=tr, server=srv, spec=spec, resolve_run_dir=ck.resolve_run_dir)
    for name, sc, ck, tr, srv, spec in (
        ("reference", r_sc, r_checkpoint, r_transport, r_server, r_spec),
        ("port", t_sc, t_checkpoint, t_transport, t_server, t_spec))}
SIZES = (40, 17, 3)
DIM = 8
_U32 = struct.Struct(">I")
_U64 = struct.Struct(">Q")


@pytest.fixture(scope="module", autouse=True)
def thread_servers():
    with pytest.MonkeyPatch.context() as mp:
        for pkg in PKGS.values():
            def spawn(connect_timeout, name, server=pkg.server):
                srv = _ThreadServer(server)
                return srv.address, srv
            mp.setattr(pkg.transport, "spawn_loopback_server", spawn)
            if hasattr(pkg.transport, "spawn_loopback_servers"):
                mp.setattr(pkg.transport, "spawn_loopback_servers",
                           lambda timeout, names, spawn=spawn:
                           [spawn(timeout, n) for n in names])
        yield


def make_state(sizes=SIZES, d=DIM, seed=0):
    rng = np.random.default_rng(seed)
    tables = [rng.normal(size=(n, d)).astype(np.float32) for n in sizes]
    accs = [np.zeros(n, np.float32) for n in sizes]
    return tables, accs


def new_fleet(pkg, tables, accs, spec, directory=None, **kw):
    kw.setdefault("backend", "inproc")
    kw.setdefault("async_save", True)
    kw.setdefault("delta_saves", True)
    kw.setdefault("parity_group_size", 2)
    return pkg.Writer([t.copy() for t in tables], [a.copy() for a in accs],
                      spec, directory=directory, **kw)


def drift(fleet, tables, accs, step, seed=7):
    """Post-stamp updates across every table (saved, not stamped)."""
    rng = np.random.default_rng(seed)
    for t in range(len(tables)):
        tables[t] = tables[t] + rng.normal(size=tables[t].shape) \
            .astype(np.float32)
        accs[t] = accs[t] + 1.0
        fleet.save_rows(t, np.arange(tables[t].shape[0]), tables[t],
                        accs[t], step=step)
    return tables, accs


def both(case, **kw):
    """``case(pkg, **kw)`` on each package: {name: result}."""
    return {name: case(pkg, **kw) for name, pkg in PKGS.items()}


def same(a, b) -> bool:
    """Deep equality of results holding arrays, lists, tuples and dicts."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    return a == b


def assert_same(out):
    assert same(out["port"], out["reference"]), out


# ------------------------------------------------------------ parity ------
def _layout(pkg):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 6))
    rep = fleet.parity_report
    fleet.close()
    return rep


def test_parity_group_layout_and_holders():
    """Groups partition the fleet; each group's stripe lives outside it."""
    out = both(_layout)
    assert_same(out)
    rep = out["port"]
    assert rep["enabled"] and rep["stale_groups"] == []
    assert sorted(j for g in rep["groups"] for j in g) == list(range(6))
    for g, members in enumerate(rep["groups"]):
        assert rep["holders"][g] not in members


def _hot(pkg):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 8),
                      parity_group_size=4)
    fleet.configure_parity(hot_shards=[1, 2])
    rep = fleet.parity_report
    fleet.save_full(tables, accs, step=0)
    fleet.fence()
    rt, ra, _ = fleet.reconstruct_shard(1)
    lo, hi = fleet.ranges[1][0]
    fleet.close()
    return rep, rt, ra, tables[0][lo:hi]


def test_parity_hot_shards_get_smaller_groups():
    out = both(_hot)
    assert_same(out)
    rep, rt, _, want = out["port"]
    assert rep["hot_shards"] == [1, 2] and rep["stale_groups"] == []
    assert all(len(g) <= 2 for g in rep["groups"] if set(g) & {1, 2})
    np.testing.assert_array_equal(rt[0], want)


def _disabled(pkg):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 1))
    out = (fleet.parity_enabled, fleet.reconstruct_shard(0))
    fleet.close()
    return out


def test_parity_disabled_below_two_shards():
    out = both(_disabled)
    assert_same(out)
    assert out["port"] == (False, None)


def _reconstruct(pkg, backend):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 4),
                      backend=backend)
    fleet.save_full(tables, accs, step=0)
    fleet.fence()
    tables, accs = drift(fleet, tables, accs, step=1)
    fleet.quiesce()                     # applied everywhere, stamped nowhere
    rt, ra, _ = fleet.reconstruct_shard(3)
    want = [(t[lo:hi], a[lo:hi]) for t, a, (lo, hi) in
            zip(tables, accs, fleet.ranges[3])]
    counters = (fleet.parity_reconstructions, fleet.parity_fallbacks,
                fleet.bytes_written, fleet.delta_rows_skipped)
    fleet.close()
    return rt, ra, want, counters


@pytest.mark.parametrize("backend", ["inproc", "pipe", "socket"])
def test_parity_reconstructs_unstamped_updates(backend):
    """After a stamp and further quiesced, unstamped updates, a shard
    rebuilds to its current image from its peers' data and parity."""
    out = both(_reconstruct, backend=backend)
    assert_same(out)
    rt, ra, want, counters = out["port"]
    for t, (wt, wa) in enumerate(want):
        np.testing.assert_array_equal(rt[t], wt)
        np.testing.assert_array_equal(ra[t], wa)
    assert counters[:2] == (1, 0)


def _double_failure(pkg, directory):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 4),
                      directory=str(directory))
    fleet.save_full(tables, accs, step=0)
    fleet.fence()
    drift(fleet, tables, accs, step=1)
    fleet.quiesce()
    g0 = fleet.parity_report["groups"][0]
    for j in g0:                        # kill the whole group
        fleet.kill_shard(j)
    out = (g0, fleet.reconstruct_shard(g0[0]), fleet.parity_fallbacks)
    fleet.close()
    return out


def test_parity_double_failure_refuses_reconstruction(tmp_path):
    out = {name: _double_failure(pkg, tmp_path / name)
           for name, pkg in PKGS.items()}
    assert_same(out)
    _, recon, fallbacks = out["port"]
    assert recon is None and fallbacks > 0


def _dead_holder(pkg):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 4))
    fleet.save_full(tables, accs, step=0)
    fleet.fence()
    rep = fleet.parity_report
    member, holder = rep["groups"][0][0], rep["holders"][0]
    fleet.kill_shard(holder)
    lo, hi = fleet.ranges[member][0]
    rows = np.arange(lo, hi)
    tables[0][rows] += 1.0
    fleet.save_rows(0, rows, tables[0][rows], accs[0][rows], step=1)
    fleet.quiesce()
    stale = list(fleet.parity_report["stale_groups"])
    refused = fleet.reconstruct_shard(member) is None
    fleet.readmit(tables, accs, step=2)
    after = list(fleet.parity_report["stale_groups"])
    rt, _, _ = fleet.reconstruct_shard(member)
    fleet.close()
    return stale, refused, after, rt[0], tables[0][lo:hi]


def test_parity_dead_holder_marks_group_stale_then_readmit_reseeds():
    out = both(_dead_holder)
    assert_same(out)
    stale, refused, after, rt, want = out["port"]
    assert 0 in stale and refused and 0 not in after
    np.testing.assert_array_equal(rt, want)


def _quiesce_then_stamp(pkg, directory):
    tables, accs = make_state()
    fleet = new_fleet(pkg, tables, accs, pkg.Spec(SIZES, 2),
                      directory=str(directory))
    fleet.save_full(tables, accs, step=0)
    n = fleet.quiesce()
    fleet.fence()                       # stamps the quiesced events
    fleet.close()
    lt, la, _ = pkg.Writer.load_latest(str(directory), tables, accs,
                                       fleet.spec).restore_all()
    return n, lt, la, tables


def test_quiesce_preserves_acked_events_for_next_stamp(tmp_path):
    out = {name: _quiesce_then_stamp(pkg, tmp_path / name)
           for name, pkg in PKGS.items()}
    assert_same(out)
    n, lt, _, tables = out["port"]
    assert n > 0
    np.testing.assert_array_equal(lt[0], tables[0])


# ------------------------------------------------------------- lease ------
def test_lease_status_skew_slack(tmp_path):
    """The same LEASE record reads the same through both packages: held
    until ``expires`` plus the skew slack, free after it or on an explicit
    release, None where there is no lease."""
    assert t_sc.LEASE_PTR == r_sc.LEASE_PTR
    assert t_sc.LEASE_CLOCK_SKEW_S == r_sc.LEASE_CLOCK_SKEW_S
    skew = t_sc.LEASE_CLOCK_SKEW_S
    path = tmp_path / t_sc.LEASE_PTR
    now = time.time()
    for expires, held in ((now + 10, True), (now - skew / 2, True),
                          (now - skew - 1.0, False), (0.0, False)):
        path.write_text(json.dumps({"epoch": 1, "ttl": 1.0,
                                    "expires": expires}))
        out = both(lambda pkg: pkg.sc.lease_status(str(tmp_path)))
        assert_same(out)
        assert out["port"]["held"] is held
    out = both(lambda pkg: pkg.sc.lease_status(str(tmp_path),
                                               skew_slack=0.0))
    assert_same(out)
    assert both(lambda pkg: pkg.sc.lease_status(str(tmp_path / "none"))) \
        == {"reference": None, "port": None}


def _lease_takeover(pkg, directory, how):
    tables, accs = make_state()
    spec = pkg.Spec(SIZES, 2)
    root = str(directory)
    fleet = pkg.Writer(tables, accs, spec, directory=root, delta_saves=False,
                       lease_ttl=0.05 if how == "expire" else 60.0)
    fleet.save_full([t + 1 for t in tables], [a + 1 for a in accs], step=1)
    fleet.fence()
    seen = [pkg.sc.lease_status(root)["held"]]
    if how == "force":
        try:
            pkg.Writer.attach(root, tables, accs, spec)
            seen.append("attached")
        except pkg.sc.LeaseHeldError as e:
            seen.append(type(e).__name__)
        standby = pkg.Writer.attach(root, tables, accs, spec, force=True,
                                    lease_ttl=60.0)
        fleet.close()                   # cannot release the usurper's lease
    elif how == "expire":
        deadline = time.time() + 5.0
        while pkg.sc.lease_status(root)["held"] and time.time() < deadline:
            time.sleep(0.02)            # the hung coordinator stops renewing
        standby = pkg.Writer.attach(root, tables, accs, spec)
    else:                               # a clean close releases it
        fleet.close()
        seen.append(pkg.sc.lease_status(root)["held"])
        standby = pkg.Writer.attach(root, tables, accs, spec)
    rec = pkg.sc.lease_status(root)
    seen.append((standby.epoch, rec["held"], rec["epoch"]))
    lt, la, _ = standby.restore_all()
    standby.close()
    if how == "expire":
        fleet.close()
    return seen, lt, la


@pytest.mark.parametrize("how", ["force", "expire", "close"])
def test_lease_takeover(tmp_path, how):
    """A live lease refuses a standby's attach unless forced (and the
    superseded coordinator's close leaves the usurper's lease alone); an
    expired or released lease admits it without force."""
    out = {name: _lease_takeover(pkg, tmp_path / name, how)
           for name, pkg in PKGS.items()}
    assert_same(out)
    seen, lt, _ = out["port"]
    tables, _ = make_state()
    np.testing.assert_array_equal(lt[0], tables[0] + 1)
    if how == "force":
        assert seen == [True, "LeaseHeldError", (2, True, 2)]
    else:
        assert seen[-1][0] == 2


# ------------------------------------------------- codec and framing ------
def test_codec_frames_are_byte_identical():
    msg = ("rows", 3, 7, 11, 0, [1, 2, 3],
           {"k": (True, False, None, 2.5, b"\x00raw")},
           np.arange(12, dtype=np.float32).reshape(3, 4))
    out = both(lambda pkg: pkg.transport.pack_msg(msg))
    assert_same(out)
    back = t_transport.unpack_msg(out["port"])
    assert back[:7] == msg[:7]
    np.testing.assert_array_equal(back[7], msg[7])


_MALFORMED = {
    "bad tag": b"\xff",
    "empty": b"",
    "truncated scalar": b"i\x00\x01",
    "lying string length": b"s" + _U32.pack(1000) + b"abc",
    "phantom tuple count": b"t" + _U32.pack(0xFFFF_FFF0) + b"n" * 8,
    "phantom list count": b"l" + _U32.pack(0xFFFF_FFF0) + b"n" * 8,
    "phantom dict count": b"d" + _U32.pack(0xFFFF_FFF0) + b"nn",
    "truncated array": r_transport.pack_msg(np.arange(16.0))[:-4],
    "hostile dtype": b"a" + _U32.pack(4) + b"zorp" + _U32.pack(0)
    + _U64.pack(0),
    "hostile ndim": b"a" + _U32.pack(3) + b"<f4" + _U32.pack(1 << 20),
    "trailing garbage": r_transport.pack_msg(("ping", 1, "t")) + b"x",
}


def _decode_error(pkg, body):
    try:
        pkg.transport.unpack_msg(body)
    except pkg.transport.ProtocolError as e:
        return str(e)
    return None


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_codec_rejects_malformed_bodies(case):
    out = both(_decode_error, body=_MALFORMED[case])
    assert_same(out)
    assert out["port"] is not None


def _framed(pkg, raw, max_frame=None):
    """What a channel makes of ``raw`` bytes from its peer: the frame,
    or the error's type and message, then whether it stays severed."""
    a, b = socket.socketpair()
    chan = pkg.transport.SockChannel(a)
    b.sendall(raw)
    try:
        got = ("frame", chan.recv())
    except (pkg.transport.ProtocolError, EOFError) as e:
        got = (type(e).__name__, str(e))
    finally:
        b.close()
    try:
        chan.recv()
        after = "frame"
    except (pkg.transport.ProtocolError, EOFError) as e:
        after = type(e).__name__
    chan.close()
    return got, after


def _bomb():
    blob = zlib.compress(b"\x00" * (1 << 22))
    return _U64.pack(len(blob) | t_transport._FRAME_COMPRESSED) + blob


def _deflate(body):
    return _U64.pack(len(body) | t_transport._FRAME_COMPRESSED) + body


_FRAMES = {
    "prefix over MAX_FRAME_BYTES": _U64.pack(t_transport.MAX_FRAME_BYTES + 1),
    "exabyte prefix": _U64.pack((1 << 40) | (1 << 55)) + b"junk",
    "zlib bomb": _bomb(),
    "dirty deflate": _deflate(zlib.compress(
        t_transport.pack_msg(("pong", "tok"))) + b"xx"),
    "truncated deflate": _deflate(zlib.compress(
        t_transport.pack_msg(("pong", "tok")))[:-4]),
    "garbage body": _U64.pack(5) + b"\x93abcd",
}


@pytest.mark.parametrize("case", sorted(_FRAMES))
def test_socket_framing_rejects_hostile_bytes(case, monkeypatch):
    """Each hostile byte stream ends as a ProtocolError with the same
    message in both packages, and the channel stays severed."""
    if case == "zlib bomb":         # a small cap, so the bomb must inflate
        for pkg in PKGS.values():   # past it
            monkeypatch.setattr(pkg.transport, "MAX_FRAME_BYTES", 1 << 16)
    out = both(_framed, raw=_FRAMES[case])
    assert_same(out)
    (kind, _), after = out["port"]
    assert kind == "ProtocolError" and after in ("ProtocolError", "EOFError")


def _roundtrip(pkg):
    a, b = socket.socketpair()
    chan, peer = pkg.transport.SockChannel(a), pkg.transport.SockChannel(b)
    peer.send(("ack", 1, {"bytes": 10}))
    first = chan.recv()
    peer.enable_codec(6, floor=0)
    big = ("full", 1, 2, 3, b"\x00" * 100_000)
    peer.send(big)
    out = (first, chan.recv() == big, peer.raw_bytes_sent,
           peer.wire_bytes_sent)
    chan.close(), peer.close()
    return out


def test_socket_roundtrip_plain_and_compressed():
    out = both(_roundtrip)
    assert_same(out)
    first, ok, raw, wire = out["port"]
    assert first == ("ack", 1, {"bytes": 10}) and ok and wire < raw


def _save_and_load(pkg, backend, directory):
    sizes = (512, 128)
    rng = np.random.default_rng(3)
    tables = [rng.normal(size=(n, 4)).astype(np.float32) for n in sizes]
    accs = [np.zeros(n, np.float32) for n in sizes]
    spec = pkg.Spec(sizes, 2)
    fleet = pkg.Writer(tables, accs, spec, directory=str(directory),
                       backend=backend, delta_saves=False)
    nbytes = fleet.save_full([t + 1 for t in tables], [a + 1 for a in accs],
                             step=1)
    fleet.fence()
    health = fleet.check_health()
    written = fleet.bytes_written
    fleet.close()
    lt, la, _ = pkg.Writer.load_latest(str(directory), tables, accs,
                                       spec).restore_all()
    return nbytes, health, written, lt, la, tables


@pytest.mark.parametrize("backend", ["inproc", "pipe", "socket"])
def test_hardened_transports_save_and_restore(backend, tmp_path):
    out = {name: _save_and_load(pkg, backend, tmp_path / name)
           for name, pkg in PKGS.items()}
    assert_same(out)
    _, health, _, lt, _, tables = out["port"]
    assert health == []
    np.testing.assert_array_equal(lt[0], tables[0] + 1)


# ------------------------------------------------------ mux and shm -------
MUX_SIZES = (4_000, 1_000)


def _await_poison(fleet, shard, deadline_s=15.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        fleet.check_health()
        if shard in fleet.failed:
            return True
        time.sleep(0.05)
    return False


def _disk(root):
    out = {}
    for dirpath, _, files in os.walk(str(root)):
        for fn in files:
            p = os.path.join(dirpath, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, str(root))] = f.read()
    return out


def _mux_fault(pkg, directory, fault):
    """A mux fleet (groups of 2) takes a stamped save, then ``fault`` on
    group {0, 1}'s shared connection: which shards poison, whether the
    stamped directory stayed as it was, the next fence's errors, and the
    image a reload gives."""
    rng = np.random.default_rng(0)
    tables = [rng.normal(size=(n, DIM)).astype(np.float32)
              for n in MUX_SIZES]
    accs = [np.zeros(n, np.float32) for n in MUX_SIZES]
    n_shards = 2 if fault == "raw bytes" else 4
    spec = pkg.Spec(MUX_SIZES, n_shards)
    fleet = pkg.Writer(tables, accs, spec, directory=str(directory),
                       backend="socket", delta_saves=False,
                       drain_timeout=15.0,
                       transport_options={"mux_group": 2})
    shared = fleet.procs[0].pid == fleet.procs[1].pid
    fleet.save_full([t + 1 for t in tables], [a + 1 for a in accs], step=1)
    fleet.fence()
    frozen = _disk(directory)
    mux = fleet.procs[0]._chan._conn._chan
    if fault == "junk inner":
        mux.send(("mx", 0, "not-a-frame"))
        targets = [0]
    elif fault == "bad envelope":
        mux.send(("mx", "zero", ("ping", 1, "t")))
        targets = [0, 1]
    else:
        mux._sock.sendall(struct.pack(">Q", 64) + b"\x93garbage")
        targets = [0, 1]
    poisoned = [_await_poison(fleet, j) for j in targets]
    failed = sorted(fleet.failed)
    untouched = _disk(directory) == frozen
    errors = None
    if n_shards > 2:
        fleet.save_full([t + 2 for t in tables], [a + 2 for a in accs],
                        step=2)
        try:
            fleet.fence()
        except pkg.sc.ShardSaveError as e:
            errors = sorted(e.shard_errors)
    fleet.close()
    lt, la, _ = pkg.Writer.load_latest(str(directory), tables, accs,
                                       spec).restore_all()
    return shared, poisoned, failed, untouched, errors, lt, la


@pytest.mark.parametrize("fault", ["junk inner", "bad envelope",
                                   "raw bytes"])
def test_mux_faults_poison_only_their_connection(tmp_path, fault):
    """A junk inner frame poisons its one shard; a malformed envelope or
    raw garbage severs the shared connection and poisons its group; the
    stamped directory is left as it was and each shard reloads to its own
    last stamp."""
    out = {name: _mux_fault(pkg, tmp_path / name, fault)
           for name, pkg in PKGS.items()}
    assert_same(out)
    shared, poisoned, failed, untouched, errors, lt, _ = out["port"]
    assert shared and all(poisoned) and untouched
    rng = np.random.default_rng(0)
    tables = [rng.normal(size=(n, DIM)).astype(np.float32)
              for n in MUX_SIZES]
    if fault == "junk inner":
        assert failed == [0] and errors == [0]
        lo, hi = t_checkpoint.EmbShardSpec(MUX_SIZES, 4).shard_range(0, 1)
        np.testing.assert_array_equal(lt[0][lo:hi], tables[0][lo:hi] + 2)
    elif fault == "bad envelope":
        assert failed == [0, 1] and errors == [0, 1]
    else:
        assert failed == [0, 1]
        np.testing.assert_array_equal(lt[0], tables[0] + 1)


def _shm(pkg):
    rng = np.random.default_rng(1)
    tables = [rng.normal(size=(n, 16)).astype(np.float16).astype(np.float32)
              for n in MUX_SIZES]
    accs = [np.zeros(n, np.float32) for n in MUX_SIZES]
    out = []
    for handoff in (False, True):
        fleet = pkg.Writer(tables, accs, pkg.Spec(MUX_SIZES, 2),
                           backend="socket", delta_saves=False,
                           transport_options={"shm_handoff": handoff})
        fleet.save_full(tables, accs, step=0)
        fleet.fence()
        wt, wa, _ = fleet.restore_all()
        out.append((fleet.wire_stats["wire_sent"],
                    all(getattr(ep, "shm_ok", False)
                        for ep in fleet.transport.endpoints), wt, wa))
        fleet.close()
    return out, tables


def test_shm_full_handoff_ships_a_name_not_the_rows():
    out = both(_shm)
    assert_same(out)
    (streamed, shm), tables = out["port"]
    assert shm[1] and shm[0] < streamed[0]
    for img in (streamed, shm):
        np.testing.assert_array_equal(img[2][0], tables[0])


# -------------------------------------------------------------- fuzz ------
@pytest.mark.parametrize("frames,seed", [(200, 0), (100, 20260808)])
def test_protocol_fuzz_against_each_packages_server(tmp_path, frames, seed):
    """Each package's spec-derived fuzzer fires the same hostile frames
    (derived from its own spec) at a live server of its own package,
    holding a stamped, parked fleet of its own (the port's tables on the
    CPU): the stamped directory stays byte-identical, the loaded image
    equals the pre-attack one and the server still answers a handshake
    (``run_fuzz`` asserts these), with the same stats and replies."""
    want = r_fuzz.run_fuzz(frames=frames, seed=seed,
                           root=str(tmp_path / "reference"))
    got = t_fuzz.run_fuzz(frames=frames, seed=seed,
                          root=str(tmp_path / "port"), device="cpu")
    assert got == want
    assert got["ok"] and got["frames"] >= frames
    assert got["replies"].get("stale", 0) > 0
