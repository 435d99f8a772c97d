"""Spec-derived protocol fuzzer: poison-not-corrupt, demonstrated.

The port's own copy of ``repro.analysis.protocol.fuzz``: the port's shard
server and writer fleet, whose tables are torch tensors on ``device``
(``cuda`` unless the caller asks for the CPU).  On the card the fleet
snapshots its CUDA tables into page-locked host memory; the stamped image
it loads back must equal what was saved, as well as survive the attacks.

Boots one real ``shard_server`` (in-process thread), runs a real
two-shard socket fleet against it through one save + fence (so the run
directory holds a stamped manifest), severs the coordinator (sessions
park, exactly as after a coordinator SIGKILL), then fires hundreds of
hostile frames derived *from the wire spec* at the live server:

* wrong-state frames (session commands as connection openers, handshake
  frames mid-session),
* arity mutations (one slot short / one slot extra),
* type confusion in int/str slots,
* stale-epoch handshakes (attach with an epoch the session already
  outran),
* truncated frame bodies and lying length prefixes,
* length-prefix bombs and zlib decompression bombs,
* malformed mux envelopes and inner frames,
* raw random bytes.

The oracle is the CPR durability contract: whatever the fuzzer does,
the stamped run directory must stay byte-identical, ``load_latest``
must return the stamped image, and the server must still answer a
legitimate handshake afterwards.  Sessions are allowed (expected!) to
poison — they must never corrupt.

Needs numpy and torch (it runs a real fleet): deliberately NOT imported
by ``repro_torch.analysis.protocol`` itself, so the stdlib-only analysis
path stays importable without them.

Run: ``PYTHONPATH=src python -m repro_torch.analysis.protocol --fuzz
[--device cpu]``
"""
from __future__ import annotations

import hashlib
import os
import random
import socket
import struct
import tempfile
import threading
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.analysis.protocol import spec as wire
from repro_torch.core.checkpoint import (EmbShardSpec, host_copy,
                                         resolve_run_dir)
from repro_torch.core.sharded_checkpoint import ShardedCheckpointWriter
from repro_torch.core.transport import SockChannel, pack_msg
from repro_torch.launch import shard_server

SIZES = (4_000, 1_000)
DIM = 8
N_SHARDS = 2

# session-creating kinds are only ever generated with junk directories
# and out-of-range shard ids: a fuzz frame must never be able to name
# the oracle's run directory or adopt the real shards' sessions
_JUNK_DIR = "/nonexistent/cpr-fuzz-junk"
_JUNK_SHARD_BASE = 100


def _start_server() -> Tuple[str, int]:
    ready = threading.Event()
    box: Dict[str, Tuple[str, int]] = {}

    def ready_cb(h, p):
        box["hp"] = (h, p)
        ready.set()

    t = threading.Thread(target=shard_server.serve,
                         args=("127.0.0.1", 0, ready_cb),
                         name="cpr-fuzz-shard-server", daemon=True)
    t.start()
    if not ready.wait(10.0):
        raise RuntimeError("shard server failed to bind")
    return box["hp"]


def _snapshot_dir(root: str) -> Dict[str, str]:
    """relpath -> sha256 of every file under the run directory tree."""
    out: Dict[str, str] = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            full = os.path.join(dirpath, name)
            with open(full, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            out[os.path.relpath(full, root)] = digest
    return out


# ---------------------------------------------------------------------
# attack grammar (derived from the spec, never hand-listed)

def _junk_value(rng: random.Random):
    return rng.choice([
        None, -1, 2**40, "junk", b"\x00\xff" * 3, 3.14, True,
        ("nested",), [1, 2], {"k": "v"},
    ])


def _fill(fspec: wire.FrameSpec, rng: random.Random, arity: int) -> tuple:
    """A frame of ``arity`` slots for ``fspec`` whose typed slots are
    *well*-typed (so only the mutation under test is hostile)."""
    out = [fspec.kind]
    for i in range(1, arity):
        t = fspec.types[i] if i < len(fspec.types) else "any"
        if t == "int":
            out.append(rng.randrange(0, 1000))
        elif t == "str":
            out.append("full" if fspec.kind == "parity" else "x")
        else:
            out.append(_junk_value(rng))
    if fspec.kind == "spawn":
        if arity > 4:
            out[4] = _JUNK_DIR                  # never the oracle's dir
        if arity > 1:
            out[1] = _JUNK_SHARD_BASE + rng.randrange(50)
    if fspec.kind in ("reconcile", "rebuild") and arity > 2:
        out[2] = _JUNK_DIR
    if fspec.kind == "attach" and arity > 2:
        out[2] = _JUNK_SHARD_BASE + rng.randrange(50)
    return tuple(out)


def _c2w_specs():
    return [f for f in wire.FRAMES.values()
            if f.direction in (wire.C2W, wire.BOTH)]


def _attack_wrong_state(rng: random.Random) -> tuple:
    """A structurally valid frame that is illegal as a connection
    opener (serving-only command) or mid-session (handshake kind)."""
    serving_only = [f for f in _c2w_specs() if "start" not in f.states]
    f = rng.choice(serving_only)
    return _fill(f, rng, f.min_arity)


def _attack_arity(rng: random.Random) -> tuple:
    f = rng.choice(_c2w_specs())
    if rng.random() < 0.5 and f.min_arity > 1:
        return _fill(f, rng, f.min_arity - 1)
    return _fill(f, rng, f.max_arity) + (_junk_value(rng),)


def _attack_type_confusion(rng: random.Random) -> Optional[tuple]:
    typed = [f for f in _c2w_specs()
             if any(t in ("int", "str") for t in f.types[1:])]
    f = rng.choice(typed)
    msg = list(_fill(f, rng, f.min_arity))
    slots = [i for i in range(1, f.min_arity)
             if f.types[i] in ("int", "str")]
    i = rng.choice(slots)
    msg[i] = b"\xde\xad" if f.types[i] == "str" else "not-an-int"
    return tuple(msg)


def _attack_unknown_kind(rng: random.Random) -> tuple:
    kind = rng.choice(["flush", "sync", "xyzzy", "", "mx2", "ack"])
    return (kind,) + tuple(_junk_value(rng) for _ in range(rng.randrange(4)))


def _attack_not_a_tuple(rng: random.Random):
    return rng.choice([None, 42, "spawn", ["spawn", 1], {"kind": "ping"}, ()])


class _Conn:
    """One hostile TCP connection (bounded lifetime, errors swallowed:
    dying on a reset peer is the *server's* success, not ours)."""

    def __init__(self, addr, timeout=2.0):
        self.sock = socket.create_connection(addr, timeout=timeout)
        self.sock.settimeout(timeout)

    def send_frame(self, msg):
        body = pack_msg(msg)
        self.sock.sendall(struct.pack(">Q", len(body)) + body)

    def send_raw(self, data: bytes):
        self.sock.sendall(data)

    def recv_frame(self):
        chan = SockChannel(self.sock)
        return chan.recv()

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def _hello(conn: _Conn, epoch=1, opts=None):
    conn.send_frame(("hello", epoch, opts or {}))
    return conn.recv_frame()


def run_fuzz(frames: int = 500, seed: int = 0,
             root: Optional[str] = None, device=None) -> Dict[str, object]:
    """Fire ``frames`` hostile frames at a live shard_server; assert
    the stamped run directory survives byte-identical and the loaded
    image matches the pre-attack oracle.  The fleet's tables lie on
    ``device`` (``cuda`` unless the caller asks for the CPU).  Returns a
    stats dict."""
    dev = resolve_device(device)
    rng = random.Random(seed)
    addr = _start_server()
    if root is None:
        root = tempfile.mkdtemp(prefix="cpr-fuzz-")

    # -- oracle: one stamped save through the real fleet ---------------
    np_rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(np_rng.normal(size=(n, DIM))
                               .astype(np.float32)).to(dev) for n in SIZES]
    accs = [torch.zeros((n, DIM), dtype=torch.float32, device=dev)
            for n in SIZES]
    espec = EmbShardSpec(SIZES, N_SHARDS)
    fleet = ShardedCheckpointWriter(
        tables, accs, espec, directory=root, backend="socket",
        addresses=[addr] * N_SHARDS, delta_saves=False,
        drain_timeout=30.0)
    v1_t = [t + 1 for t in tables]
    v1_a = [a + 1 for a in accs]
    fleet.save_full(v1_t, v1_a, step=1)
    fleet.fence()                       # durable: CURRENT now points at v1
    live_epoch = fleet.epoch if isinstance(
        getattr(fleet, "epoch", None), int) else 1
    for p in fleet.procs:               # coordinator "dies": sessions park
        p.sever()

    run_dir = resolve_run_dir(root)
    assert run_dir is not None, "fence did not advance CURRENT"
    oracle_fs = _snapshot_dir(root)
    lt, la, _ = ShardedCheckpointWriter.load_latest(
        root, tables, accs, espec).restore_all()
    oracle_tables = [t.copy() for t in lt]
    oracle_accs = [a.copy() for a in la]
    # the stamped image is the one saved (on the card: through the
    # page-locked snapshots of the device tables)
    for got, want in zip(oracle_tables + oracle_accs, v1_t + v1_a):
        assert np.array_equal(got, host_copy(want)), (
            "the stamped image differs from the saved tables")

    # -- the attacks ---------------------------------------------------
    stats: Dict[str, int] = {}
    replies: Dict[str, int] = {}

    def note(category: str):
        stats[category] = stats.get(category, 0) + 1

    def fold_reply(conn: _Conn):
        try:
            msg = conn.recv_frame()
            kind = msg[0] if isinstance(msg, tuple) and msg else "?"
            replies[str(kind)] = replies.get(str(kind), 0) + 1
        except Exception:       # lint: allow[exception-hygiene] hostile
            # peer: EOF/reset/timeout are all acceptable server answers
            replies["<dead>"] = replies.get("<dead>", 0) + 1

    sent = 0
    while sent < frames:
        kind = rng.randrange(10)
        try:
            conn = _Conn(addr)
        except OSError:
            break               # server gone: the post-checks will fail
        try:
            if kind == 0:       # wrong-state opener
                conn.send_frame(_attack_wrong_state(rng))
                note("wrong-state")
            elif kind == 1:     # arity mutation as opener
                conn.send_frame(_attack_arity(rng))
                note("arity")
            elif kind == 2:     # type confusion as opener
                conn.send_frame(_attack_type_confusion(rng))
                note("type-confusion")
            elif kind == 3:     # unknown kind / non-tuple opener
                if rng.random() < 0.5:
                    conn.send_frame(_attack_unknown_kind(rng))
                else:
                    conn.send_frame(_attack_not_a_tuple(rng))
                note("unknown-kind")
            elif kind == 4:     # stale-epoch attach at a REAL shard
                conn.send_frame(("attach", 0, rng.randrange(N_SHARDS)))
                note("stale-epoch")
                fold_reply(conn)
            elif kind == 5:     # truncated body / lying prefix
                body = pack_msg(_fill(rng.choice(_c2w_specs()), rng, 3))
                if rng.random() < 0.5:
                    cut = rng.randrange(1, max(2, len(body)))
                    conn.send_raw(struct.pack(">Q", len(body))
                                  + body[:cut])
                else:
                    conn.send_raw(struct.pack(">Q", len(body) + 7)
                                  + body)
                note("truncated")
            elif kind == 6:     # length-prefix bomb
                conn.send_raw(struct.pack(">Q", 1 << 40) + b"\x00" * 64)
                note("prefix-bomb")
            elif kind == 7:     # zlib bomb behind the compressed bit
                blob = zlib.compress(b"\x00" * (1 << 22), 9)
                n = len(blob) | (1 << 63)
                conn.send_raw(struct.pack(">Q", n) + blob)
                note("zlib-bomb")
            elif kind == 8:     # mux: hostile envelopes + inner frames
                try:
                    _hello(conn, epoch=live_epoch,
                           opts={"mux": True})
                except Exception:   # lint: allow[exception-hygiene]
                    # handshake refused is a pass, not a failure
                    note("mux-garbage")
                    continue
                choice = rng.randrange(4)
                if choice == 0:
                    conn.send_frame(("mx",))                # short
                elif choice == 1:
                    conn.send_frame(("mx", "shard?", 1))    # bad shard
                elif choice == 2:
                    conn.send_frame(("mx", _JUNK_SHARD_BASE,
                                     _attack_not_a_tuple(rng)))
                else:
                    conn.send_frame(("not-mx", 1, 2))
                note("mux-garbage")
            else:               # raw random bytes
                conn.send_raw(rng.randbytes(rng.randrange(1, 64)))
                note("raw-bytes")
            sent += 1
        except OSError:
            sent += 1           # peer reset us mid-attack: acceptable
        finally:
            conn.close()

    # -- the oracle holds ----------------------------------------------
    after_fs = _snapshot_dir(root)
    assert after_fs == oracle_fs, (
        "fuzzing mutated the stamped run directory: "
        f"{sorted(set(after_fs.items()) ^ set(oracle_fs.items()))[:4]}")

    lt, la, _ = ShardedCheckpointWriter.load_latest(
        root, tables, accs, espec).restore_all()
    for got, want in zip(lt, oracle_tables):
        assert np.array_equal(got, want), "loaded table drifted"
    for got, want in zip(la, oracle_accs):
        assert np.array_equal(got, want), "loaded accumulator drifted"

    # server still answers a legitimate handshake
    conn = _Conn(addr)
    try:
        reply = _hello(conn, epoch=live_epoch + 1)
        assert isinstance(reply, tuple) and reply[0] == "hello-ok", (
            f"server no longer speaks the protocol: {reply!r}")
    finally:
        conn.close()

    return {
        "frames": sent,
        "categories": dict(sorted(stats.items())),
        "replies": dict(sorted(replies.items())),
        "disk_files": len(oracle_fs),
        "ok": True,
    }
