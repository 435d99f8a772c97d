"""Remote shard-writer host: Emb-PS shard checkpoint writers over TCP.

Runs the same writer apply loop as the in-process / pipe transports
(``repro_torch.core.transport.WriterSession``), but behind a TCP listener
speaking the length-prefixed frame protocol — so shard writers on *other
hosts* join the coordinator's DRAIN/STAMP fence.

**Sessions outlive connections.**  Each accepted connection either
``spawn``s a fresh writer incarnation or ``attach``es to one the server
already holds: the server keeps a per-shard session registry, and a
session whose coordinator connection drops (trainer crash, partition) is
*parked* — image, durable watermark and latched-error state intact — until
a successor coordinator adopts it with the ``attach``/``reconcile``
handshake (``ShardedCheckpointWriter.attach``).  Takeover is guarded by
the monotonic coordinator **epoch**: an ``attach`` (or ``spawn``) carrying
an epoch no newer than the session's is answered ``("stale", ...)``, and a
still-connected stale coordinator's commands are rejected the same way —
an old coordinator that un-hangs can never submit or drain over its
successor.  Plain re-admission after a crash or partition by the *same*
coordinator remains a fresh connection + ``spawn`` with a fresh seed
(``SocketEndpoint.respawn``).

Sessions are also **donor/receiver endpoints for online fleet resize**
(``ShardedCheckpointWriter.resize``): inside a fence window the
coordinator streams row ranges out of donors with ``export`` frames,
swaps each retained session's store to the new layout epoch with a
``reshard`` frame (session and connection survive the resize), and ships
the stamped image back as a normal ``full`` save.  A coordinator that
cannot read a shard's directory at takeover sends ``rebuild`` instead of
``reconcile`` — the session then replays the shipped stamped-event plan
from its *own* local files (see ``repro_torch.core.transport`` for the frames).

Sessions also hold the fleet's **XOR parity stripes** (``parity`` /
``parity-get`` frames): a session designated holder for a parity group
keeps the running XOR of its peer shards' images as soft in-memory state
— seeded by a ``("parity", epoch, seq, step, "full", ...)`` frame,
folded forward by ``"delta"`` frames shipped alongside row saves, and
read back by a recovering coordinator with ``parity-get`` to reconstruct
a crashed peer's *current* image from survivors (zero rollback).  Parity
state is deliberately not durable and not part of the stamped manifest:
it dies with the session, and the coordinator reseeds holders at
adoption/readmission.  All of this rides the shared ``WriterSession``
loop, so the frames behave identically over inproc, pipe and socket.

The port's copy of ``repro.launch.shard_server``; either server serves
either coordinator (the frames are the same bytes).  The server never
touches the GPU: it is numpy + sockets only, so a trainer-side
accelerator wedge cannot corrupt it.

CLI (one per writer host; the coordinator is pointed at them with
``train.py --transport socket --shard-servers host:port,...``)::

    PYTHONPATH=src python -m repro_torch.launch.shard_server --host 0.0.0.0 \
        --port 7070

With ``--port 0`` the kernel picks a free port, printed on stdout as
``listening on <host>:<port>``.  The per-shard checkpoint directory named
in the ``spawn`` / ``reconcile`` message is a *server-local* path: in a
multi-host fleet, point it at storage the recovery job can read (shared
fs), or ship the shard directories before running ``load_latest``
(docs/recovery.md).
"""
from __future__ import annotations

import argparse
import queue
import socket
import threading
from typing import Dict, Optional

from repro_torch.analysis.protocol.spec import violation as _spec_violation
from repro_torch.core.checkpoint import EmbShardSpec
from repro_torch.core.transport import (ProtocolError, SockChannel,
                                  WriterSession, verify_shm_probe)


class SessionRegistry:
    """Per-server-process registry of live/parked writer sessions, keyed
    by shard id.  One host typically serves several shards of one fleet;
    the registry is what lets a successor coordinator adopt them."""

    def __init__(self):
        self.lock = threading.Lock()
        self.sessions: Dict[int, WriterSession] = {}  # guarded by: lock

    def spawn(self, shard: int, session: WriterSession,
              epoch: int) -> Optional[WriterSession]:
        """Install a fresh incarnation for ``shard`` (evicting any prior
        session's serve loops).  Returns None — or the existing session
        when the spawn is stale (its epoch is older than the session's:
        a superseded coordinator trying to respawn its lost writer)."""
        with self.lock:
            old = self.sessions.get(shard)
            if old is not None:
                if old.epoch > epoch:
                    return old
                old.evict()
            self.sessions[shard] = session
            return None

    def get(self, shard: int) -> Optional[WriterSession]:
        with self.lock:
            return self.sessions.get(shard)


def _serve_spawn(chan: SockChannel, registry: SessionRegistry, msg):
    """Handle a ``spawn`` command: fresh writer incarnation (stale spawns
    from a superseded coordinator are rejected)."""
    (_, shard, table_sizes, n_shards, directory,
     seed_t, seed_a, seed_tr, fsync) = msg[:9]
    epoch = msg[9] if len(msg) > 9 else 0
    boundaries = msg[10] if len(msg) > 10 else None
    old = registry.get(shard)
    if old is not None and old.epoch > epoch:
        # cheap pre-check before materializing the seed store (the
        # install below re-checks under the registry lock for the race)
        chan.send(("stale", "spawn", epoch, old.epoch))
        return
    spec = EmbShardSpec(table_sizes, n_shards, boundaries=boundaries)
    session = WriterSession(shard, spec, directory,
                            (seed_t, seed_a, seed_tr),
                            fsync_payloads=fsync, epoch=epoch)
    stale = registry.spawn(shard, session, epoch)
    if stale is not None:
        chan.send(("stale", "spawn", epoch, stale.epoch))
        return
    session.serve(chan, session.gen)


def _serve_attach(chan: SockChannel, registry: SessionRegistry, msg):
    """Handle the coordinator-failover handshake: adopt the shard's
    session for the (strictly newer) epoch, reconcile it against the last
    stamp, then serve.  Falls through to a plain spawn when the server
    holds no session for the shard (server restarted since)."""
    _, epoch, shard = msg
    session = registry.get(shard)
    if session is None:
        chan.send(("no-writer",))
        try:
            follow = chan.recv()
        except (EOFError, OSError, ProtocolError):
            return
        if _spec_violation(follow, state="attaching") is None \
                and follow[0] == "spawn":
            _serve_spawn(chan, registry, follow)
        return
    with session.lock:
        if session.epoch >= epoch:
            chan.send(("stale", "attach", epoch, session.epoch))
            return
        gen = session.claim(epoch)
        wm, err = session.watermark, session.err
    chan.send(("attach-ok", wm, err))
    try:
        rec = chan.recv()
    except (EOFError, OSError, ProtocolError):
        return                          # adopter vanished mid-handshake
    if _spec_violation(rec, state="attaching") is not None:
        return                          # hostile follow-up: drop, stay parked
    if rec[0] not in ("reconcile", "rebuild") or rec[1] != epoch:
        return
    with session.lock:
        if session.gen != gen or session.epoch != epoch:
            # an even newer coordinator claimed the session between our
            # attach-ok and this reconcile: this adopter is already stale
            chan.send(("stale", rec[0], epoch, session.epoch))
            return
        if rec[0] == "rebuild":
            # remote-disk reconcile: the adopter could not read this
            # shard's directory coordinator-side, so it ships the stamped
            # event plan and the session replays it from its OWN local
            # files (the same command the serve loop accepts)
            reply, _ = session._handle(rec)
        else:
            _, _, directory, watermark, seed_t, seed_a, seed_tr = rec
            seed = None if seed_t is None else (seed_t, seed_a, seed_tr)
            wm = session.reconcile(directory, watermark, seed)
            reply = ("reconciled", wm)
    chan.send(reply)
    session.serve(chan, gen)


class _ServerVirtChan:
    """Server side of one shard's virtual channel on a multiplexed
    connection: ``recv`` drains an inbox fed by the connection's demux
    loop, ``send`` wraps the reply in the ("mx", shard, frame) envelope
    (the shared channel's send lock serializes members).  Presents the
    same surface as ``SockChannel`` to the unchanged ``WriterSession``
    serve loop — so one shard blocked in a long apply cannot
    head-of-line-block a peer's DRAIN ack."""

    _EOF = object()

    def __init__(self, chan: SockChannel, shard: int):
        self._chan = chan
        self.shard = shard
        self._inbox: "queue.Queue" = queue.Queue()

    def deliver(self, msg):
        self._inbox.put(msg)

    def deliver_eof(self):
        self._inbox.put(self._EOF)

    def recv(self):
        msg = self._inbox.get()
        if msg is self._EOF:
            self._inbox.put(self._EOF)      # EOF is sticky
            raise EOFError("mux connection closed")
        return msg

    def send(self, msg):
        self._chan.send(("mx", self.shard, msg))

    def close(self):
        pass                                # lifetime == the connection's


def _serve_virtual(vchan: _ServerVirtChan, registry: SessionRegistry):
    """One shard's serve loop on a multiplexed connection — the first
    inner frame is the ordinary ``spawn`` / ``attach``."""
    try:
        msg = vchan.recv()
    except EOFError:
        return
    if _spec_violation(msg, state="negotiated") is not None:
        return      # hostile opener: this shard never gets a session
    if msg[0] == "spawn":
        _serve_spawn(vchan, registry, msg)
    elif msg[0] == "attach":
        _serve_attach(vchan, registry, msg)


def _serve_mux(chan: SockChannel, registry: SessionRegistry):
    """Demux loop for one multiplexed connection: routes each inbound
    ("mx", shard, frame) envelope to that shard's virtual channel,
    spinning up a per-shard serve thread on first sight.  Connection EOF
    parks every shard riding it (exactly the co-resident set)."""
    vchans: Dict[int, _ServerVirtChan] = {}
    threads = []
    try:
        while True:
            msg = chan.recv()
            if not (isinstance(msg, tuple) and msg and msg[0] == "mx"):
                continue                    # unknown envelope: drop
            if len(msg) != 3 or not isinstance(msg[1], int):
                # torn mx envelope: the whole connection is suspect —
                # sever it, parking exactly the co-resident shards
                raise ProtocolError(
                    f"malformed mx envelope (arity {len(msg)})")
            shard, inner = msg[1], msg[2]
            vc = vchans.get(shard)
            if vc is None:
                vc = _ServerVirtChan(chan, shard)
                vchans[shard] = vc
                t = threading.Thread(target=_serve_virtual,
                                     args=(vc, registry),
                                     name=f"cpr-shard-mux-{shard}",
                                     daemon=True)
                threads.append(t)
                t.start()
            vc.deliver(inner)
    except (EOFError, OSError, ValueError):
        pass
    finally:
        for vc in vchans.values():
            vc.deliver_eof()
        for t in threads:
            t.join(timeout=5.0)


def _handle_conn(sock: socket.socket, registry: SessionRegistry):
    """One connection == one coordinator's view of one shard writer (or,
    multiplexed, of several): an optional ``hello`` negotiates the
    per-frame codec / multiplexing / shm handoff, then the opening
    ``spawn`` / ``attach`` runs the apply loop until the peer goes away
    (parking the session) or a successor supersedes it."""
    chan = SockChannel(sock)
    try:
        msg = chan.recv()
    except (EOFError, OSError, ProtocolError):
        chan.close()
        return
    if _spec_violation(msg, state="start") is not None:
        # a frame that is not a legal opener (garbage bytes, session
        # command without a handshake): drop the connection before any
        # session state exists to damage
        chan.close()
        return
    try:
        if msg[0] == "hello":
            opts = msg[2] if len(msg) > 2 and isinstance(msg[2], dict) \
                else {}
            # shm handoff: prove we share the coordinator's machine by
            # attaching its probe segment and matching the nonce
            shm_ok = verify_shm_probe(opts.get("shm"))
            level = int(opts.get("codec_level") or 0)
            if level:
                floor = int(opts.get("codec_floor") or 0)
                chan.enable_codec(level, floor or None)
            chan.send(("hello-ok", {"shm": shm_ok}))
            if opts.get("mux"):
                _serve_mux(chan, registry)
                return
            try:
                msg = chan.recv()
            except (EOFError, OSError, ProtocolError):
                return
            if _spec_violation(msg, state="negotiated") is not None:
                return
        if msg[0] == "spawn":
            _serve_spawn(chan, registry, msg)
        elif msg[0] == "attach":
            _serve_attach(chan, registry, msg)
    # lint: allow[exception-hygiene] hostile handshake payloads (e.g.
    # codec_level="x") must drop the connection, not kill the accept
    # thread; sessions poison themselves inside serve()
    except (ProtocolError, ValueError, TypeError):
        pass
    finally:
        chan.close()


def serve(host: str = "127.0.0.1", port: int = 0, ready_cb=None,
          _accept_forever: bool = True) -> None:
    """Bind, listen, and serve writer connections until killed.  Each
    connection runs in its own thread (a host typically serves several
    shards of one fleet, plus re-admission reconnects and coordinator
    takeovers — all sharing this process's session registry)."""
    registry = SessionRegistry()
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind((host, port))
    srv.listen(64)
    bound = srv.getsockname()
    if ready_cb is not None:
        ready_cb(bound[0], bound[1])
    while True:
        try:
            conn, _ = srv.accept()
        except OSError:
            return
        t = threading.Thread(target=_handle_conn, args=(conn, registry),
                             name="cpr-shard-conn", daemon=True)
        t.start()
        if not _accept_forever:         # test hook: serve one connection
            return


def spawned_server_main(conn, host: str):
    """Auto-spawn entry point (``SocketEndpoint`` launches one loopback
    server per shard): bind port 0 and report the real address back over
    the bootstrap pipe before serving."""
    def ready(h, p):
        conn.send((h, p))
        conn.close()

    serve(host, 0, ready_cb=ready)


def main():
    ap = argparse.ArgumentParser(
        description="host remote CPR shard checkpoint writers")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=7070,
                    help="TCP port (0 = pick a free one)")
    args = ap.parse_args()

    def ready(h, p):
        print(f"listening on {h}:{p}", flush=True)

    serve(args.host, args.port, ready_cb=ready)


if __name__ == "__main__":
    main()
