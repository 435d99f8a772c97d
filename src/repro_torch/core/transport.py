"""Pluggable shard-transport layer for the checkpoint writer fleet.

The port of ``repro.core.transport``: framework-free (numpy, sockets,
``multiprocessing``), with its imports pointed at the port.  Frames are
byte-identical to the reference's, so a port coordinator and a reference
``shard_server`` (or the reverse) fence together.  Writers only ever see
host numpy: the pipe and socket endpoints copy any tensor seed to the
host before it crosses the process boundary, and no writer process
creates a CUDA context.

The coordinator (``repro_torch.core.sharded_checkpoint.ShardedCheckpointWriter``)
used to special-case two writer backends — an in-process applier thread and
a ``multiprocessing`` pipe worker — in every submit/fence/restore path.
This module turns the writer-fleet communication into an abstraction so the
same DRAIN/STAMP protocol runs over any carrier, per the Check-N-Run /
Chameleon observation that fault-tolerance *policy* should be selectable
per deployment without rewriting the engine:

  * :class:`ShardEndpoint` — the per-shard handle the coordinator routes
    through: ``submit_full`` / ``submit_rows`` / ``submit_trainer``,
    the two-phase ``begin_drain`` / ``finish_drain`` barrier with durable
    seq watermarks, ``fetch_image`` for restores, ``probe`` for heartbeat
    liveness, and the ``kill`` / ``respawn`` re-admission lifecycle.
    Failures latch fail-stop exactly as before: one bad endpoint poisons
    one shard, never the trainer.

  * :class:`ShardTransport` — the fleet-level factory: it owns the
    endpoints and the **snapshot shipping strategy** for ``save_full``
    (one shared payload per save event, sliced per shard off the critical
    path).  Three implementations:

      - :class:`InprocTransport` (``backend="inproc"``, alias ``thread``):
        each shard's :class:`_ShardStore` runs under an in-process
        ``AsyncApplier`` thread (or inline in sync mode); snapshots are
        shared host arrays.
      - :class:`PipeTransport` (``backend="pipe"``, alias ``process``):
        each shard's store runs the same apply loop behind a spawned OS
        process fed over a duplex pipe.  ``save_full`` snapshots ship
        **zero-copy via ``multiprocessing.shared_memory``** — the one
        remaining per-save disk write (the uncompressed spool ``.npz``)
        is off the save-event critical path; the spool file remains as an
        explicit fallback (``snapshot="spool"``) and for hosts without a
        usable ``/dev/shm``.
      - :class:`SocketTransport` (``backend="socket"``): the same
        length-prefixed message protocol over TCP, so shard writers on
        *other hosts* join the DRAIN/STAMP fence.  Workers are hosted by
        the ``repro_torch.launch.shard_server`` entrypoint (or auto-spawned
        locally when no addresses are given).  Submits go through a
        bounded outbound queue + sender thread so a partitioned writer
        can only poison its own shard — it can never stall the trainer.

Wire protocol (logical messages; the pipe carries them as pickled tuples,
the socket as length-prefixed binary frames via :func:`pack_msg`).  Every
coordinator command carries the coordinator **epoch** — the monotonic
ownership token persisted in the root directory's ``COORDINATOR`` record —
and a writer rejects any command from an epoch older than the one it last
adopted (reply ``("stale", ...)``), so a hung-then-resumed coordinator can
never submit, drain, or (transitively) stamp over its successor:

  coordinator -> worker                    worker -> coordinator
  ("spawn", shard, table_sizes, n_shards,  ("ack",     seq, event_dict)
   directory, seed_t, seed_a, seed_tr,     ("error",   seq, err_string)
   fsync, epoch)         [socket only]     ("drained", token, watermark, err)
  ("full",    epoch, seq, step, payload)   ("image",   tables, accs, trainer)
  ("rows",    epoch, seq, step, t, r,v,a)  ("pong",    token)
  ("trainer", epoch, seq, step, tree)      ("stale",   kind, epoch, current)
  ("drain",   epoch, token)
  ("image",   epoch)                       coordinator-failover handshake
  ("ping",    epoch, token)                (socket only; shard_server):
  ("close",   epoch)                       ("attach-ok", watermark, err)
  ("attach",  epoch, shard)                ("no-writer",)
  ("reconcile", epoch, dir, wm,            ("reconciled", watermark)
   seed_t|None, seed_a|None, seed_tr)

Elastic-fleet (online split/merge) peer-transfer frames — issued inside a
fence window by ``ShardedCheckpointWriter.resize`` and by the takeover
remote-disk reconcile path:

  ("export",  epoch, ranges)               ("rows-out", shard, tabs, accs)
      donor read: ship the rows of the writer's image overlapping the
      requested global ``[lo, hi)`` ranges (one pair per table).
  ("reshard", epoch, table_sizes,          ("resharded", shard, watermark)
   n_shards, boundaries, dir,
   seed_t, seed_a, seed_tr)
      receiver rebuild: swap the session's store to the new layout epoch
      (the session and its connection survive the resize); the stamped
      image follows as a normal ``full`` save.
  ("rebuild", epoch, dir, wm,              ("rebuilt", watermark)
   seed_t, seed_a, seed_tr, plan)
      remote-disk reconcile: reset to the init seed, then replay the
      shipped stamped-event ``plan`` from the *writer's* local files
      (used when the coordinator cannot read the shard's directory).

Parity-redundancy frames (ECRM-style XOR striping, enabled by
``ShardedCheckpointWriter(parity_group_size=...)``): the coordinator
ships each parity group's XOR stripe to the group's **holder** writer —
a shard *outside* the group — so a poisoned member's current image can
be rebuilt from surviving peers (the ``reconstruct`` readmit path)
instead of replayed from its last stamp.  Parity is soft in-memory
state: applies produce **no manifest events and no disk payloads**
(power-loss recovery still replays the stamped chain); they do advance
the session watermark like any other apply:

  ("parity",  epoch, seq, step, "full",    ("parity-ok", seq, nbytes)
   group, tables, accs)
      seed/replace the group's full XOR stripe — one array pair per
      table; stripe row ``i`` is the bytewise XOR of every member's
      local row ``i`` (members with fewer rows contribute implicit
      zeros, so empty shard slices yield identity parity).
  ("parity",  epoch, seq, step, "delta",   ("parity-ok", seq, nbytes)
   group, table, stripe_rows, xvals, xaccs)
      fold a row update into the stripe: bytewise-XOR ``xvals`` /
      ``xaccs`` (old-bytes XOR new-bytes of the member's rows) into
      ``stripe_rows``.  A delta for a group the holder was never seeded
      with is an apply error — fail-stop; the coordinator reseeds the
      stripe with a fresh "full" at the holder's readmit.
  ("parity-get", epoch, group)             ("parity-out", group, tabs, accs)
      reconstruction read: the holder's current stripe for ``group``
      (a ``(group, None, None)`` reply when it holds no such group).

``save_full`` payloads are one of ``("spool", path)``, ``("shm", name,
meta)`` or ``("slices", tables, accs)`` — every worker applies them through
the same :class:`_ShardStore`, so manifests and images are byte-identical
across transports (the backend-parity tests assert it).

Durability: workers batch-fsync their persisted ``.npz`` payloads (file
data + directory entry) *before* answering DRAIN, so the durable watermark
the coordinator stamps into the cycle record is power-loss-true, not just
crash-true.  Replies arrive in command order; after sending DRAIN the
coordinator simply consumes replies until the matching ``drained`` token.
"""
from __future__ import annotations

import os
import queue
import socket as _socket
import struct
import threading
import time
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# the machine-readable wire spec (stdlib-only, safe for workers) is the
# single source of truth for frame shapes and the max frame size
from repro_torch.analysis.protocol.spec import MAX_FRAME_BYTES
from repro_torch.analysis.protocol.spec import violation as _spec_violation
from repro_torch.tree import tree_map
from repro_torch.core.checkpoint import (AsyncApplier, EmbShardSpec, _leaves,
                                   load_trainer_tree, save_trainer_tree)

# Default seconds the coordinator waits for a shard's DRAIN ack before
# declaring the writer dead.  Generous: a healthy worker only has bounded
# queued work, so a miss here means a real wedge or a network partition.
DRAIN_TIMEOUT_S = 60.0
# Seconds a socket submit may wait for outbound-queue space before the
# shard is declared stalled (poisoned).  The queue only fills when the
# peer stops reading — a partition — so this bounds trainer-side blocking.
SUBMIT_TIMEOUT_S = 30.0
# Seconds without ANY inbound reply (pong, ack, drained...) before a
# probed socket endpoint is latched.  Matches the DRAIN deadline: a worker
# busy inside one long apply is silent but alive, and must not be
# heartbeat-poisoned while a fence would still have waited for it.
HEARTBEAT_TIMEOUT_S = 60.0
# Outbound submit-queue depth per socket endpoint.
SUBMIT_QUEUE_DEPTH = 64
# Per-frame zlib codec floor (negotiated in the connection "hello"): only
# bodies at least this large are compressed — below it the codec costs
# more CPU than the bytes it saves, and control frames (ping, drain, ack)
# must stay cheap on the fence critical path.
CODEC_FLOOR_BYTES = 1 << 10
# Contiguous ndarray payloads at least this large are appended to the
# outgoing frame as memoryviews (zero-copy) instead of ``tobytes()``
# copies; below it the bookkeeping outweighs the copy.
ZEROCOPY_MIN_BYTES = 1 << 12
# High bit of the 8-byte length prefix marks a zlib-compressed frame body.
# The receive side is stateless: it inflates flagged frames whether or not
# it negotiated a codec, so each direction can enable compression
# independently and control replies never depend on handshake ordering.
_FRAME_COMPRESSED = 1 << 63

def _host_array(a) -> np.ndarray:
    """``a`` as host numpy; a torch tensor (on any device) is copied to
    the host."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _host_seed(seed_tables, seed_accs, trainer_image=None):
    """A writer's seed as host numpy only, before it crosses to a writer
    process (``np.asarray`` raises on a CUDA tensor)."""
    return ([_host_array(t) for t in seed_tables],
            [_host_array(a) for a in seed_accs],
            None if trainer_image is None
            else tree_map(_host_array, trainer_image))


TRANSPORTS = ("inproc", "pipe", "socket")
TRANSPORT_ALIASES = {"thread": "inproc", "process": "pipe"}


def normalize_transport(name: str) -> str:
    """Map legacy backend names (thread/process) onto transport names."""
    out = TRANSPORT_ALIASES.get(name, name)
    if out not in TRANSPORTS:
        raise ValueError(f"unknown transport {name!r} "
                         f"(expected one of {TRANSPORTS + tuple(TRANSPORT_ALIASES)})")
    return out


class WriterProcError(RuntimeError):
    """A shard's writer failed: an apply raised inside the worker, the
    process died (crash, OOM-kill, SIGKILL), or the connection to a remote
    writer was lost / timed out."""


class StaleEpochError(WriterProcError):
    """A writer rejected this coordinator's command because it has been
    adopted by a successor coordinator with a newer epoch.  Fail-stop for
    the *coordinator*: once latched, this coordinator must not stamp (its
    fence's ownership check will refuse) — the writer fleet now belongs to
    the successor."""


class ProtocolError(ValueError):
    """An inbound wire frame violates the protocol spec: a hostile or
    corrupt length prefix (over ``MAX_FRAME_BYTES``), a truncated body,
    a malformed tag stream, or a compression bomb.  The channel that
    produced it is desynchronized by definition and must be severed —
    never retried.

    Subclasses ``ValueError`` so the demux/reader loops that already
    treat a malformed frame as connection death (``except (EOFError,
    OSError, ValueError)``) handle it without new plumbing, while
    callers that care can still distinguish it."""


# =========================================================================
# wire codec: length-prefixed binary frames for the socket transport
# =========================================================================
# msgpack-style tagged encoding of the protocol's value universe: None,
# bool, int, float, str, bytes, list, tuple, dict, numpy ndarray.  No
# external dependency; arrays travel as raw dtype bytes.

_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_U64 = struct.Struct(">Q")


def _pack_into(o, out: List[bytes]):
    if o is None:
        out.append(b"n")
    elif o is True:
        out.append(b"T")
    elif o is False:
        out.append(b"F")
    elif isinstance(o, np.ndarray):
        dt = np.ascontiguousarray(o)
        ds = dt.dtype.str.encode()
        out.append(b"a" + _U32.pack(len(ds)) + ds +
                   _U32.pack(dt.ndim) +
                   b"".join(_U64.pack(s) for s in dt.shape) +
                   _U64.pack(dt.nbytes))
        if dt.nbytes >= ZEROCOPY_MIN_BYTES:
            # zero-copy: the view aliases the array (or the contiguous
            # staging copy ``ascontiguousarray`` made); ``send`` writes it
            # to the socket synchronously before returning, so the caller
            # cannot mutate it mid-frame.
            out.append(memoryview(dt).cast("B"))
        else:
            out.append(dt.tobytes())
    elif isinstance(o, (np.generic,)):
        _pack_into(o.item(), out)
    elif isinstance(o, bool):            # pragma: no cover (caught above)
        out.append(b"T" if o else b"F")
    elif isinstance(o, int):
        out.append(b"i" + _I64.pack(o))
    elif isinstance(o, float):
        out.append(b"f" + _F64.pack(o))
    elif isinstance(o, str):
        b = o.encode()
        out.append(b"s" + _U32.pack(len(b)) + b)
    elif isinstance(o, (bytes, bytearray, memoryview)):
        b = bytes(o)
        out.append(b"b" + _U32.pack(len(b)) + b)
    elif isinstance(o, tuple):
        out.append(b"t" + _U32.pack(len(o)))
        for v in o:
            _pack_into(v, out)
    elif isinstance(o, list):
        out.append(b"l" + _U32.pack(len(o)))
        for v in o:
            _pack_into(v, out)
    elif isinstance(o, dict):
        out.append(b"d" + _U32.pack(len(o)))
        for k, v in o.items():
            _pack_into(k, out)
            _pack_into(v, out)
    else:
        raise TypeError(f"cannot encode {type(o).__name__} on the wire")


def pack_msg_parts(o) -> List[Union[bytes, memoryview]]:
    """Encode one protocol message as a list of frame-body parts.

    Large contiguous ndarray payloads appear as **memoryviews over the
    caller's array** — no intermediate ``tobytes()`` copy — so a
    ``save_full`` slice travels coordinator-memory → socket with a single
    kernel copy.  Callers that need one buffer join the parts
    (:func:`pack_msg`); the socket channel sends them individually."""
    out: List[Union[bytes, memoryview]] = []
    _pack_into(o, out)
    return out


def pack_msg(o) -> bytes:
    """Encode one protocol message as a self-delimited binary frame body."""
    return b"".join(pack_msg_parts(o))


def _need(buf: memoryview, pos: int, n: int, what: str) -> None:
    """Truncation guard: a length field inside the frame must never
    claim more bytes than the frame actually holds.  Without this a
    hostile u32/u64 length makes the decoder return silently-short data
    (or loop over billions of phantom elements); with it the frame dies
    as a clean :class:`ProtocolError` before any allocation."""
    if n < 0 or n > len(buf) - pos:
        raise ProtocolError(
            f"wire frame truncated: {what} claims {n} bytes but only "
            f"{len(buf) - pos} remain")


def _unpack_from(buf: memoryview, pos: int):
    tag = buf[pos:pos + 1].tobytes()
    pos += 1
    if tag == b"n":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"i":
        return _I64.unpack_from(buf, pos)[0], pos + 8
    if tag == b"f":
        return _F64.unpack_from(buf, pos)[0], pos + 8
    if tag in (b"s", b"b"):
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        _need(buf, pos, n, "str/bytes length")
        raw = buf[pos:pos + n].tobytes()
        return (raw.decode() if tag == b"s" else raw), pos + n
    if tag in (b"t", b"l"):
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        _need(buf, pos, n, "collection element count")  # >=1 byte each
        items = []
        for _ in range(n):
            v, pos = _unpack_from(buf, pos)
            items.append(v)
        return (tuple(items) if tag == b"t" else items), pos
    if tag == b"d":
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        _need(buf, pos, 2 * n, "dict entry count")      # >=2 bytes each
        d = {}
        for _ in range(n):
            k, pos = _unpack_from(buf, pos)
            v, pos = _unpack_from(buf, pos)
            d[k] = v
        return d, pos
    if tag == b"a":
        n = _U32.unpack_from(buf, pos)[0]
        pos += 4
        _need(buf, pos, n, "dtype string length")
        dtype = np.dtype(buf[pos:pos + n].tobytes().decode())
        pos += n
        ndim = _U32.unpack_from(buf, pos)[0]
        pos += 4
        _need(buf, pos, 8 * ndim, "array ndim")
        shape = tuple(_U64.unpack_from(buf, pos + 8 * i)[0]
                      for i in range(ndim))
        pos += 8 * ndim
        nbytes = _U64.unpack_from(buf, pos)[0]
        pos += 8
        _need(buf, pos, nbytes, "array byte length")
        arr = np.frombuffer(buf[pos:pos + nbytes].tobytes(),
                            dtype=dtype).reshape(shape)
        return arr, pos + nbytes
    raise ProtocolError(f"bad wire tag {tag!r}")


def unpack_msg(body: bytes):
    """Decode one frame body produced by :func:`pack_msg`.

    Any malformation — truncated length fields, bad tags, dtype/shape
    garbage, short struct reads — surfaces as :class:`ProtocolError`,
    never a MemoryError, an over-allocation, or a silent short read."""
    try:
        obj, pos = _unpack_from(memoryview(body), 0)
    except ProtocolError:
        raise
    except (struct.error, ValueError, TypeError, IndexError,
            OverflowError, UnicodeDecodeError) as e:
        raise ProtocolError(f"malformed wire frame: {e}") from e
    if pos != len(body):
        raise ProtocolError("trailing bytes in wire frame")
    return obj


# =========================================================================
# channels: one logical duplex message stream per shard
# =========================================================================
class PipeChannel:
    """``multiprocessing.Connection`` carrier (messages travel pickled)."""

    def __init__(self, conn):
        self._conn = conn

    def send(self, msg):
        self._conn.send(msg)

    def recv(self):
        return self._conn.recv()

    def poll(self, timeout: float = 0.0) -> bool:
        return self._conn.poll(timeout)

    def close(self):
        try:
            self._conn.close()
        except OSError:
            pass


class SockChannel:
    """Length-prefixed binary frames over a TCP socket.

    Frame = 8-byte big-endian body length + :func:`pack_msg` body.
    ``poll`` only reports True once a *complete* frame is buffered, so
    ``recv`` after a successful poll never blocks mid-frame.

    The socket stays in blocking mode for its whole life; the recv side
    waits with ``select`` instead of ``settimeout``.  This matters: a
    sender thread may be inside ``sendall`` on the same socket, and
    flipping the socket's timeout/blocking mode under it could truncate an
    in-flight frame and desync the protocol.

    **Partial sends poison the channel.**  Any error out of ``sendall`` —
    a timeout, a signal, a transient ``OSError`` — may have left a partial
    frame on the wire; reusing the connection after that would append the
    next frame mid-body and desynchronize the stream (the peer would
    decode garbage lengths and read forever).  So the first send failure
    latches ``_broken`` and severs the socket: every later ``send`` fails
    fast, and the peer sees EOF instead of a torn stream.

    **Optional per-frame zlib codec** (negotiated in the connection
    ``hello``): when ``enable_codec`` has been called, bodies of at least
    ``codec_floor`` raw bytes are deflated and flagged with the high bit
    of the length prefix; the receive side *always* inflates flagged
    frames, so the two directions negotiate independently.  Raw-vs-wire
    byte counters feed ``report()``.
    """

    def __init__(self, sock: _socket.socket, codec_level: int = 0,
                 codec_floor: int = CODEC_FLOOR_BYTES):
        self._sock = sock
        self._buf = bytearray()
        self._send_lock = threading.Lock()
        self._broken = False        # guarded by: _send_lock
        self._codec_level = int(codec_level)
        self._codec_floor = int(codec_floor)
        # raw = pack_msg bytes; wire = bytes on the socket incl. prefixes.
        self.raw_bytes_sent = 0     # guarded by: _send_lock
        self.wire_bytes_sent = 0    # guarded by: _send_lock
        self.raw_bytes_rcvd = 0
        self.wire_bytes_rcvd = 0
        sock.settimeout(None)           # blocking forever; see class doc
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except OSError:
            pass                        # AF_UNIX (tests) has no Nagle

    def enable_codec(self, level: int, floor: Optional[int] = None):
        """Turn on send-side compression (after a ``hello`` handshake)."""
        self._codec_level = int(level)
        if floor is not None:
            self._codec_floor = int(floor)

    def wire_stats(self) -> Dict[str, int]:
        with self._send_lock:
            return {"raw_sent": self.raw_bytes_sent,
                    "wire_sent": self.wire_bytes_sent,
                    "raw_rcvd": self.raw_bytes_rcvd,
                    "wire_rcvd": self.wire_bytes_rcvd}

    # ------------------------------------------------------------- send ---
    def send(self, msg):
        parts = pack_msg_parts(msg)     # encode errors leave no bytes sent
        raw_len = sum(len(p) for p in parts)
        if self._codec_level and raw_len >= self._codec_floor:
            co = zlib.compressobj(self._codec_level)
            body = b"".join([co.compress(p) for p in parts] + [co.flush()])
            bufs: List[Union[bytes, memoryview]] = [
                _U64.pack(len(body) | _FRAME_COMPRESSED), body]
            wire_len = len(body)
        else:
            # coalesce small parts into one buffer; large memoryview parts
            # (array payloads) go to sendall directly, zero-copy.
            bufs = []
            small: List[bytes] = [_U64.pack(raw_len)]
            for p in parts:
                if isinstance(p, memoryview):
                    if small:
                        bufs.append(b"".join(small))
                        small = []
                    bufs.append(p)
                else:
                    small.append(p)
            if small:
                bufs.append(b"".join(small))
            wire_len = raw_len
        with self._send_lock:
            if self._broken:
                raise BrokenPipeError(
                    "channel poisoned by an earlier partial send")
            try:
                for b in bufs:
                    self._sock.sendall(b)
            except Exception as e:      # incl. socket.timeout mid-sendall
                self._broken = True
                self._sever()           # peer sees EOF, never a torn frame
                raise BrokenPipeError(str(e)) from e
            self.raw_bytes_sent += raw_len
            self.wire_bytes_sent += wire_len + 8

    def _sever(self):
        try:
            self._sock.shutdown(_socket.SHUT_RDWR)
        except OSError:
            pass

    # ------------------------------------------------------------- recv ---
    def _frame_len(self) -> Optional[int]:
        if len(self._buf) < 8:
            return None
        n = _U64.unpack_from(self._buf, 0)[0] & (_FRAME_COMPRESSED - 1)
        if n > MAX_FRAME_BYTES:
            # hostile/corrupt prefix: fail as soon as the 8 prefix bytes
            # arrive — never buffer toward a multi-exabyte claim
            self._sever()
            raise ProtocolError(
                f"frame length prefix {n} exceeds MAX_FRAME_BYTES "
                f"{MAX_FRAME_BYTES}: hostile or desynchronized stream")
        return n

    def _has_frame(self) -> bool:
        n = self._frame_len()
        return n is not None and len(self._buf) >= 8 + n

    def _fill(self, timeout: Optional[float]) -> bool:
        """Read whatever is available within ``timeout``; False on timeout,
        EOFError when the peer closed.  Waits with ``select`` (never
        ``settimeout`` — the socket's blocking mode is shared with the
        sender thread); after a readable select, recv returns promptly."""
        import select
        try:
            readable, _, _ = select.select([self._sock], [], [], timeout)
            if not readable:
                return False
            chunk = self._sock.recv(1 << 20)
        except (ConnectionError, OSError, ValueError) as e:
            raise EOFError(str(e)) from e
        if not chunk:
            raise EOFError("connection closed by peer")
        self._buf.extend(chunk)
        return True

    def poll(self, timeout: float = 0.0) -> bool:
        if self._has_frame():
            return True
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if not self._fill(max(remaining, 0.0)):
                return self._has_frame()    # nothing arrived in time
            if self._has_frame():
                return True
            if remaining <= 0:
                return False                # partial frame; don't spin

    def recv(self):
        while not self._has_frame():
            self._fill(None)
        n = self._frame_len()
        compressed = bool(_U64.unpack_from(self._buf, 0)[0]
                          & _FRAME_COMPRESSED)
        body = bytes(self._buf[8:8 + n])
        del self._buf[:8 + n]
        self.wire_bytes_rcvd += n + 8
        if compressed:
            body = self._inflate(body)
        self.raw_bytes_rcvd += len(body)
        try:
            return unpack_msg(body)
        except ProtocolError:
            self._sever()               # stream desynchronized for good
            raise

    def _inflate(self, body: bytes) -> bytes:
        """Bounded inflate: a tiny deflate stream can claim gigabytes
        (zlib bomb), so inflation is capped at MAX_FRAME_BYTES and any
        excess, trailing garbage, or zlib error severs the channel."""
        try:
            do = zlib.decompressobj()
            out = do.decompress(body, MAX_FRAME_BYTES + 1)
            if len(out) > MAX_FRAME_BYTES:
                raise ProtocolError(
                    f"compressed frame inflates past MAX_FRAME_BYTES "
                    f"{MAX_FRAME_BYTES}: compression bomb")
            if not do.eof or do.unconsumed_tail or do.unused_data:
                raise ProtocolError(
                    "compressed frame body is truncated or carries "
                    "trailing garbage")
            return out
        except ProtocolError:
            self._sever()
            raise
        except zlib.error as e:
            self._sever()
            raise ProtocolError(f"compressed frame is corrupt: {e}") from e

    def close(self):
        self._sever()
        try:
            self._sock.close()
        except OSError:
            pass


# =========================================================================
# connection-level negotiation (hello) + shard multiplexing
# =========================================================================
# These are *connection*-scoped frames, not coordinator->writer commands:
# ("hello", epoch, opts) / ("hello-ok", opts) negotiate the per-frame
# codec, multiplexing and the shm save_full handoff before any spawn or
# attach travels; ("mx", shard, frame) is the mux envelope wrapping every
# per-shard frame on a shared connection.  The inner frames are the
# ordinary epoch-fenced protocol, unchanged.

_LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")


def is_loopback_address(address) -> bool:
    return bool(address) and str(address[0]) in _LOOPBACK_HOSTS


class ShmProbe:
    """Same-machine proof for the shm ``save_full`` handoff.

    The coordinator allocates a tiny shared-memory segment holding a
    random nonce and offers ``(name, nonce)`` in the connection ``hello``;
    the server attaches the segment *by name* and confirms the bytes
    match.  Only a process on the same machine (same /dev/shm namespace)
    can pass, so a loopback-forwarded remote server can never be handed a
    segment name it cannot open."""

    def __init__(self):
        from multiprocessing import shared_memory
        self.nonce = os.urandom(16)
        self._shm = shared_memory.SharedMemory(create=True, size=16)
        self._shm.buf[:16] = self.nonce

    def payload(self):
        return [self._shm.name, bytes(self.nonce)]

    def close(self):
        try:
            self._shm.close()
            self._shm.unlink()
        except (FileNotFoundError, OSError):
            pass


def verify_shm_probe(probe_payload) -> bool:
    """Server side of :class:`ShmProbe`: attach by name, compare nonces."""
    if not probe_payload:
        return False
    from multiprocessing import shared_memory
    name, nonce = probe_payload[0], probe_payload[1]
    try:
        seg = shared_memory.SharedMemory(name=name)
    except (FileNotFoundError, OSError, ValueError):
        return False
    try:
        return bytes(seg.buf[:len(nonce)]) == bytes(nonce)
    finally:
        # Attaching registered the name with OUR resource tracker; close
        # only — unlinking is the coordinator's job (it owns the probe).
        seg.close()


def client_hello(chan: SockChannel, epoch: int, *, codec_level: int = 0,
                 codec_floor: int = CODEC_FLOOR_BYTES, mux: bool = False,
                 shm_probe: Optional[ShmProbe] = None,
                 timeout: float = 20.0) -> dict:
    """Send the connection ``hello`` and wait for ``hello-ok``.

    Returns the server's option dict (``{"shm": bool}``).  On success the
    client's send-side codec is enabled at ``codec_level`` (the server
    enabled its own side when it read the hello)."""
    opts = {"codec_level": int(codec_level), "codec_floor": int(codec_floor),
            "mux": bool(mux)}
    if shm_probe is not None:
        opts["shm"] = shm_probe.payload()
    chan.send(("hello", epoch, opts))
    if not chan.poll(timeout):
        raise WriterProcError("hello handshake timed out")
    reply = chan.recv()
    if not (isinstance(reply, tuple) and reply and reply[0] == "hello-ok"):
        raise WriterProcError(f"hello handshake got {reply!r}")
    if codec_level:
        chan.enable_codec(codec_level, codec_floor)
    return dict(reply[1]) if len(reply) > 1 and reply[1] else {}


class _MuxChan:
    """One shard's virtual channel over a shared :class:`MuxConnection`.

    Same ``send/recv/poll/close`` surface as :class:`SockChannel`; sends
    wrap the frame in an ("mx", shard, frame) envelope (serialized by the
    underlying channel's send lock), receives drain a per-shard inbox fed
    by the connection's reader thread — so one slow shard's traffic never
    head-of-line-blocks a peer's DRAIN ack."""

    def __init__(self, conn: "MuxConnection", shard: int):
        self._conn = conn
        self.shard = shard
        self._cv = threading.Condition()
        self._inbox: List[tuple] = []   # guarded by: _cv
        self._eof = False               # guarded by: _cv

    def send(self, msg):
        self._conn.send_for(self.shard, msg)

    def _deliver(self, msg):
        with self._cv:
            self._inbox.append(msg)
            self._cv.notify_all()

    def _deliver_eof(self):
        with self._cv:
            self._eof = True
            self._cv.notify_all()

    def poll(self, timeout: float = 0.0) -> bool:
        deadline = time.monotonic() + timeout
        with self._cv:
            while not self._inbox:
                if self._eof:           # mirror SockChannel.poll-on-EOF
                    raise EOFError("mux connection closed")
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def recv(self):
        with self._cv:
            while not self._inbox:
                if self._eof:
                    raise EOFError("mux connection closed")
                self._cv.wait()
            return self._inbox.pop(0)

    def close(self):
        """Detach this shard from the shared connection (the connection
        itself closes when its last member detaches)."""
        self._conn.member_close(self.shard)

    def sever_connection(self):
        """Hard-kill the *whole* shared connection — the crash-drill
        equivalent of closing a dedicated per-shard socket: every
        co-resident shard sees EOF and is poisoned together."""
        self._conn.sever()

    def wire_stats(self) -> Dict[str, int]:
        return self._conn.wire_stats()


class MuxConnection:
    """One TCP connection carrying several shards' channels to a single
    ``shard_server`` (``--shard-servers host:port*k`` addressing).

    Owns the :class:`SockChannel` and a reader thread that demuxes
    inbound ("mx", shard, frame) envelopes to per-shard :class:`_MuxChan`
    inboxes.  Failure granularity is the connection: losing it (or
    ``sever()``) delivers EOF to every member, poisoning exactly the
    shards riding this connection — the same partition surface as k
    dedicated sockets to one dead host."""

    def __init__(self, address, epoch: int = 0, connect_timeout: float = 20.0,
                 codec_level: int = 0, codec_floor: int = CODEC_FLOOR_BYTES,
                 shm_probe: Optional[ShmProbe] = None, server_proc=None):
        self.address = tuple(address)
        self.server_proc = server_proc      # owned auto-spawned server
        sock = _socket.create_connection(
            (self.address[0], int(self.address[1])), timeout=connect_timeout)
        self._chan = SockChannel(sock)
        self.hello = client_hello(
            self._chan, epoch, codec_level=codec_level,
            codec_floor=codec_floor, mux=True, shm_probe=shm_probe,
            timeout=connect_timeout)
        self.shm_ok = bool(self.hello.get("shm"))
        self._lock = threading.Lock()
        self._members: Dict[int, _MuxChan] = {}     # guarded by: _lock
        self._reader = threading.Thread(
            target=self._reader_loop,
            name=f"cpr-mux-recv-{self.address[0]}-{self.address[1]}",
            daemon=True)
        self._reader.start()

    def channel(self, shard: int) -> _MuxChan:
        ch = _MuxChan(self, shard)
        with self._lock:
            self._members[shard] = ch
        return ch

    def send_for(self, shard: int, msg):
        self._chan.send(("mx", shard, msg))

    def _reader_loop(self):
        try:
            while True:
                msg = self._chan.recv()
                if not (isinstance(msg, tuple) and msg
                        and msg[0] == "mx"):
                    continue            # unknown envelope: drop, stay up
                with self._lock:
                    ch = self._members.get(msg[1])
                if ch is not None:
                    ch._deliver(msg[2])
        except (EOFError, OSError, ValueError):
            pass
        finally:
            with self._lock:
                members = list(self._members.values())
            for ch in members:
                ch._deliver_eof()

    def member_close(self, shard: int):
        with self._lock:
            self._members.pop(shard, None)
            last = not self._members
        if last:
            self.sever()

    def sever(self):
        self._chan.close()

    def wire_stats(self) -> Dict[str, int]:
        return self._chan.wire_stats()


# =========================================================================
# the worker-side apply engine (shared by every transport)
# =========================================================================
def xor_arrays(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Bytewise XOR of two same-shape, same-dtype arrays, returned with
    the original dtype.  XOR over the raw bytes is lossless for any dtype
    (floats included) and self-inverse — exactly the two properties an
    XOR parity stripe needs.  Empty arrays XOR to empty arrays (identity
    parity for zero-row shard slices)."""
    a = np.ascontiguousarray(a)
    b = np.ascontiguousarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        raise ValueError(
            f"parity xor shape/dtype mismatch: {a.shape}/{a.dtype} vs "
            f"{b.shape}/{b.dtype}")
    out = np.bitwise_xor(a.view(np.uint8), b.view(np.uint8))
    return out.view(a.dtype).reshape(a.shape)


def xor_into(dst: np.ndarray, src: np.ndarray) -> None:
    """XOR ``src`` into contiguous ``dst`` in place, bytewise."""
    dv = dst.view(np.uint8)
    sv = np.ascontiguousarray(src).view(np.uint8)
    if dv.shape != sv.shape:
        raise ValueError(
            f"parity xor shape mismatch: {dst.shape} vs {src.shape}")
    np.bitwise_xor(dv, sv, out=dv)


class _ShardStore:
    """Image + disk persistence for one shard's row ranges.

    ``apply_*`` methods run on the shard's (single) applier thread — or
    inside the shard's writer process / remote server for the pipe and
    socket transports; the completed-event list is only read by the
    coordinator after that queue has been drained, so no locking is needed.

    With ``fsync_payloads`` (default) every persisted ``.npz`` path is
    tracked and :meth:`sync_payloads` batch-fsyncs file data + directory —
    the workers call it when answering DRAIN, so an acked watermark means
    the payloads survive power loss, not just a process crash.
    """

    def __init__(self, shard: int, spec: EmbShardSpec, tables, accs,
                 directory: Optional[str] = None, sliced: bool = False,
                 fsync_payloads: bool = True):
        self.shard = shard
        self.spec = spec
        self.ranges = [spec.shard_range(t, shard)
                       for t in range(len(spec.table_sizes))]
        if sliced:
            # ``tables``/``accs`` are already this shard's row slices (the
            # worker is seeded with only its own rows)
            self.image_tables = [np.array(np.asarray(t)) for t in tables]
            self.image_accs = [np.array(np.asarray(a)) for a in accs]
        else:
            self.image_tables = [np.array(np.asarray(t)[lo:hi])
                                 for t, (lo, hi) in zip(tables, self.ranges)]
            self.image_accs = [np.array(np.asarray(a)[lo:hi])
                               for a, (lo, hi) in zip(accs, self.ranges)]
        self.trainer_image = None              # populated on shard 0 only
        self.directory = directory
        self.fsync_payloads = fsync_payloads
        self._pending_fsync: List[str] = []
        self.bytes_written = 0
        self.save_events = 0
        self.applied: List[dict] = []          # completed events, in order
        # XOR parity stripes this writer *holds* for other shards' parity
        # groups (ECRM redundancy).  Soft state: never persisted, never
        # recorded in ``applied`` — a holder crash only costs redundancy
        # (the coordinator reseeds the stripe), never durability.
        self.parity_tables: Dict[int, List[np.ndarray]] = {}
        self.parity_accs: Dict[int, List[np.ndarray]] = {}
        self.parity_bytes = 0
        self.parity_events = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    def _record(self, ev, fname: Optional[str] = None):
        ev["shard"] = self.shard
        ev["time"] = time.time()
        self.bytes_written += ev["bytes"]
        self.save_events += 1
        self.applied.append(ev)
        if fname and self.fsync_payloads:
            self._pending_fsync.append(os.path.join(self.directory, fname))

    def apply_full(self, tables, accs, step: int, seq: int):
        """``tables``/``accs`` are immutable full-table snapshots shared
        with the other shards' workers (read-only); slice out our ranges."""
        self._apply_full([tables[t][lo:hi]
                          for t, (lo, hi) in enumerate(self.ranges)],
                         [accs[t][lo:hi]
                          for t, (lo, hi) in enumerate(self.ranges)],
                         step, seq)

    def apply_full_sliced(self, table_slices, acc_slices, step: int,
                          seq: int):
        """Like :meth:`apply_full` but the payload is already this shard's
        row slices (the socket transport streams only the shard's rows)."""
        self._apply_full(table_slices, acc_slices, step, seq)

    def _apply_full(self, t_slices, a_slices, step: int, seq: int):
        nbytes = 0
        for t in range(len(self.image_tables)):
            self.image_tables[t][...] = t_slices[t]
            self.image_accs[t][...] = a_slices[t]
            nbytes += self.image_tables[t].nbytes + self.image_accs[t].nbytes
        fname = None
        if self.directory:
            arrs = {}
            for t in range(len(self.image_tables)):
                arrs[f"table_{t}"] = self.image_tables[t]
                arrs[f"acc_{t}"] = self.image_accs[t]
            fname = f"full_e{seq}.npz"
            np.savez_compressed(os.path.join(self.directory, fname), **arrs)
        self._record({"kind": "full", "step": step, "seq": seq,
                      "bytes": nbytes}, fname)

    def apply_rows(self, table: int, rows: np.ndarray, values: np.ndarray,
                   acc_values: np.ndarray, step: int, seq: int):
        """``rows`` are global ids, already routed to (and owned by) us."""
        lo, _ = self.ranges[table]
        local = np.asarray(rows) - lo
        self.image_tables[table][local] = values
        self.image_accs[table][local] = acc_values
        nbytes = values.nbytes + acc_values.nbytes + np.asarray(rows).nbytes
        fname = None
        if self.directory:
            fname = f"partial_t{table}_e{seq}.npz"
            np.savez_compressed(os.path.join(self.directory, fname),
                                rows=rows, values=values, accs=acc_values,
                                table=table, step=step)
        self._record({"kind": "partial", "table": table, "step": step,
                      "seq": seq, "bytes": nbytes, "file": fname}, fname)

    def apply_trainer(self, tree, step: int, seq: int):
        self.trainer_image = tree
        nbytes = sum(np.asarray(a).nbytes for a in _leaves(tree))
        fname = None
        if self.directory:
            fname = f"trainer_e{seq}.npz"
            save_trainer_tree(os.path.join(self.directory, fname), tree)
        self._record({"kind": "trainer", "step": step, "seq": seq,
                      "bytes": nbytes, "file": fname}, fname)

    def apply_parity_full(self, group: int, tables, accs, step: int,
                          seq: int) -> int:
        """Seed/replace the full XOR stripe we hold for ``group``.  The
        stripe is stored as-shipped (one contiguous array pair per table);
        returns the stripe byte size for the ``parity-ok`` ack."""
        # np.array (not ascontiguousarray): the stripe must be an owned
        # WRITABLE copy — socket frames deserialize to read-only buffers,
        # and inproc ships the coordinator's own arrays
        self.parity_tables[int(group)] = [np.array(t) for t in tables]
        self.parity_accs[int(group)] = [np.array(a) for a in accs]
        nbytes = sum(t.nbytes for t in self.parity_tables[int(group)])
        nbytes += sum(a.nbytes for a in self.parity_accs[int(group)])
        self.parity_bytes += nbytes
        self.parity_events += 1
        return nbytes

    def apply_parity_delta(self, group: int, table: int, stripe_rows,
                           xvals, xaccs, step: int, seq: int) -> int:
        """Fold a member's row update into the held stripe: bytewise-XOR
        ``xvals``/``xaccs`` into ``stripe_rows``.  A delta for a group we
        were never seeded with raises (fail-stop latch; the coordinator
        reseeds at readmit).  Zero-row deltas are identity parity."""
        group = int(group)
        if group not in self.parity_tables:
            raise ValueError(
                f"parity delta for unseeded group {group} on shard "
                f"{self.shard}")
        rows = np.asarray(stripe_rows)
        nbytes = (np.asarray(xvals).nbytes + np.asarray(xaccs).nbytes +
                  rows.nbytes)
        if rows.size:
            dst_t = self.parity_tables[group][int(table)]
            dst_a = self.parity_accs[group][int(table)]
            # fancy-indexed reads are fresh contiguous copies: XOR into
            # the copy, then scatter it back
            tmp = dst_t[rows]
            xor_into(tmp, xvals)
            dst_t[rows] = tmp
            tmp = dst_a[rows]
            xor_into(tmp, xaccs)
            dst_a[rows] = tmp
        self.parity_bytes += nbytes
        self.parity_events += 1
        return nbytes

    def parity_stripe(self, group: int):
        """The held stripe for ``group`` as copies (safe to serialize
        outside the session lock), or ``(None, None)`` when unheld."""
        group = int(group)
        if group not in self.parity_tables:
            return None, None
        return ([t.copy() for t in self.parity_tables[group]],
                [a.copy() for a in self.parity_accs[group]])

    def sync_payloads(self):
        """Batch-fsync every payload persisted since the last DRAIN (file
        data, then the directory entry) so the watermark acked back to the
        coordinator is power-loss-durable.  Off the save critical path:
        runs at DRAIN time, in the worker."""
        if not self._pending_fsync:
            return
        for path in self._pending_fsync:
            fsync_path(path)
        fsync_path(self.directory)
        self._pending_fsync = []


def fsync_path(path: str):
    """fsync one file or directory by path (no-op if it vanished)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# =========================================================================
# save_full snapshot shipping
# =========================================================================
class SnapshotRef:
    """One ``save_full`` host snapshot, shipped fleet-wide.  Endpoints call
    :meth:`payload_for` to get their wire payload; the coordinator calls
    :meth:`release` once a fence confirmed every healthy shard consumed it.

    Only a snapshot that ``holds_resource`` (a spool file, a shared-memory
    segment) is tracked until that fence.  One made of plain host arrays
    is kept alive by whoever still reads it (an applier queue, a sender
    queue); tracking it as well would pin every full snapshot taken
    between two fences — ~2.3 GB each at full Criteo-Kaggle width, for a
    whole ``full``-mode run without a directory, which never fences.
    """

    holds_resource = False

    def __init__(self, seq: int):
        self.seq = seq

    def payload_for(self, shard: int):
        raise NotImplementedError

    def release(self):
        pass


class InlineSnapshot(SnapshotRef):
    """In-process: the immutable host arrays themselves are the payload."""

    def __init__(self, seq, snap_t, snap_a):
        super().__init__(seq)
        self.tables = snap_t
        self.accs = snap_a

    def payload_for(self, shard: int):
        return self.tables, self.accs


class SpoolSnapshot(SnapshotRef):
    """Pipe fallback: ONE uncompressed ``.npz`` on disk that every worker
    slices locally.  Costs a disk write on the save-event critical path —
    which is exactly what :class:`ShmSnapshot` removes."""

    holds_resource = True

    def __init__(self, seq, spool_dir, snap_t, snap_a):
        super().__init__(seq)
        os.makedirs(spool_dir, exist_ok=True)
        self.path = os.path.join(spool_dir, f"spool_e{seq}.npz")
        arrs = {}
        for t, (tab, acc) in enumerate(zip(snap_t, snap_a)):
            arrs[f"table_{t}"] = np.asarray(tab)
            arrs[f"acc_{t}"] = np.asarray(acc)
        np.savez(self.path, **arrs)

    def payload_for(self, shard: int):
        return ("spool", self.path)

    def release(self):
        try:
            os.remove(self.path)
        except OSError:
            pass


class ShmSnapshot(SnapshotRef):
    """One ``multiprocessing.shared_memory`` segment holding the full
    (tables, accs) snapshot; workers attach and slice zero-copy.  Removes
    the last per-save disk write from the save-event critical path."""

    holds_resource = True

    def __init__(self, seq, snap_t, snap_a):
        super().__init__(seq)
        from multiprocessing import shared_memory
        arrs = []
        for t, a in enumerate(snap_t):
            arrs.append((f"table_{t}", np.ascontiguousarray(a)))
        for t, a in enumerate(snap_a):
            arrs.append((f"acc_{t}", np.ascontiguousarray(a)))
        total = max(1, sum(a.nbytes for _, a in arrs))
        self._shm = shared_memory.SharedMemory(create=True, size=total)
        self.meta = []                 # (key, dtype_str, shape, offset)
        off = 0
        for key, a in arrs:
            view = np.ndarray(a.shape, a.dtype, buffer=self._shm.buf,
                              offset=off)
            view[...] = a
            self.meta.append((key, a.dtype.str, tuple(a.shape), off))
            off += a.nbytes
        del view

    def payload_for(self, shard: int):
        return ("shm", self._shm.name, self.meta)

    def release(self):
        try:
            self._shm.close()
            self._shm.unlink()
        except (OSError, FileNotFoundError):
            pass


class SliceSnapshot(SnapshotRef):
    """Socket streaming fallback: shared memory cannot cross hosts, so each
    shard is sent exactly its own row slices (total wire bytes across the
    fleet = one snapshot).  Slicing happens lazily on the sender thread —
    off the trainer's critical path."""

    def __init__(self, seq, snap_t, snap_a, ranges):
        super().__init__(seq)
        self.tables = snap_t
        self.accs = snap_a
        self.ranges = ranges           # ranges[shard][table] = (lo, hi)

    def payload_for(self, shard: int):
        r = self.ranges[shard]
        return ("slices",
                [np.ascontiguousarray(t[lo:hi])
                 for t, (lo, hi) in zip(self.tables, r)],
                [np.ascontiguousarray(a[lo:hi])
                 for a, (lo, hi) in zip(self.accs, r)])


class ShmHandoffSnapshot(SnapshotRef):
    """Socket transport with co-hosted, shm-verified servers: the full
    snapshot lives in ONE shared-memory segment (exactly
    :class:`ShmSnapshot`), and a verified shard's ``full`` frame carries
    just the segment *name* — the pipe transport's zero-copy payload,
    unified with the socket protocol.  Shards whose connection failed the
    :class:`ShmProbe` (remote, or a different mount namespace) fall back
    to streamed row slices from the same snapshot arrays."""

    holds_resource = True

    def __init__(self, seq, snap_t, snap_a, ranges, shm_shards):
        super().__init__(seq)
        self._slices = SliceSnapshot(seq, snap_t, snap_a, ranges)
        self._shm = ShmSnapshot(seq, snap_t, snap_a)
        self.shm_shards = frozenset(shm_shards)

    def payload_for(self, shard: int):
        if shard in self.shm_shards:
            return self._shm.payload_for(shard)
        return self._slices.payload_for(shard)

    def release(self):
        self._shm.release()


def _apply_full_payload(store: _ShardStore, spec: EmbShardSpec, payload,
                        step: int, seq: int):
    """Worker side: apply one ``save_full`` payload, whichever way it was
    shipped.  All three payload kinds produce the identical event record."""
    kind = payload[0]
    if kind == "slices":
        store.apply_full_sliced(payload[1], payload[2], step, seq)
        return
    if kind == "spool":
        with np.load(payload[1]) as z:
            tabs = [z[f"table_{t}"] for t in range(len(spec.table_sizes))]
            accs = [z[f"acc_{t}"] for t in range(len(spec.table_sizes))]
        store.apply_full(tabs, accs, step, seq)
        return
    if kind == "shm":
        from multiprocessing import shared_memory
        name, meta = payload[1], payload[2]
        # NOTE: attaching registers the name with the resource tracker
        # (idempotent set-add; workers share the coordinator's tracker via
        # the spawn fd).  Do NOT unregister here — that would remove the
        # coordinator's own registration and break its unlink at release.
        seg = shared_memory.SharedMemory(name=name)
        try:
            views = {key: np.ndarray(shape, np.dtype(dt), buffer=seg.buf,
                                     offset=off)
                     for key, dt, shape, off in meta}
            tabs = [views[f"table_{t}"]
                    for t in range(len(spec.table_sizes))]
            accs = [views[f"acc_{t}"]
                    for t in range(len(spec.table_sizes))]
            store.apply_full(tabs, accs, step, seq)   # copies our slices
        finally:
            del views, tabs, accs     # release buffer exports before close
            seg.close()
        return
    raise ValueError(f"unknown save_full payload kind {kind!r}")


def replay_plan_into_store(store: _ShardStore, plan) -> None:
    """Worker-side cross-epoch replay, restricted to the store's rows.

    ``plan`` is the stamped-event script a coordinator ships with the
    ``rebuild`` frame when it cannot read this shard's directory itself
    (remote disk): an ordered list of ops

      * ``("layout", n_shards, boundaries)`` — switch the active layout
        epoch the following events' shard ids are resolved through,
      * ``("full", shard, path)`` — a full event of ``shard`` *under the
        active layout*; only the rows overlapping our ranges are applied,
      * ``("partial", shard, path)`` — a partial event (global row ids;
        rows outside our ranges are dropped),
      * ``("trainer", path)`` — trainer replica (applied on shard 0).

    Paths are server-local (shared fs in a multi-host fleet — the same
    contract the ``spawn`` directory already has).  The caller resets the
    image to the init seed first; replaying every stamped event in
    manifest order then reproduces exactly the stamped image.
    """
    active: Optional[EmbShardSpec] = None
    sizes = store.spec.table_sizes
    for op in plan:
        kind = op[0]
        if kind == "layout":
            active = EmbShardSpec(sizes, int(op[1]), boundaries=op[2])
        elif kind == "full":
            jj, path = int(op[1]), op[2]
            with np.load(path) as z:
                for t, (slo, shi) in enumerate(store.ranges):
                    lo, hi = active.shard_range(t, jj)
                    a, b = max(lo, slo), min(hi, shi)
                    if a < b:
                        store.image_tables[t][a - slo:b - slo] = \
                            z[f"table_{t}"][a - lo:b - lo]
                        store.image_accs[t][a - slo:b - slo] = \
                            z[f"acc_{t}"][a - lo:b - lo]
        elif kind == "partial":
            with np.load(op[2]) as z:
                t = int(z["table"])
                rows = np.asarray(z["rows"])
                slo, shi = store.ranges[t]
                keep = (rows >= slo) & (rows < shi)
                if np.any(keep):
                    store.image_tables[t][rows[keep] - slo] = \
                        np.asarray(z["values"])[keep]
                    store.image_accs[t][rows[keep] - slo] = \
                        np.asarray(z["accs"])[keep]
        elif kind == "trainer":
            if store.shard == 0:
                store.trainer_image = load_trainer_tree(op[1], None)
        else:
            raise ValueError(f"unknown rebuild-plan op {kind!r}")


# =========================================================================
# the unified worker loop (pipe children and socket servers both run this)
# =========================================================================
class WriterSession:
    """One shard writer *incarnation*: the :class:`_ShardStore` plus the
    protocol state (adopted coordinator epoch, durable watermark, latched
    apply error) that must outlive any single connection.

    ``shard_server`` parks a session when its coordinator's connection
    drops (coordinator crash, partition) and a successor coordinator
    re-adopts it with the ``attach``/``reconcile`` handshake instead of
    respawning the writer — the pipe transport's child process, whose
    bootstrap pipe cannot be re-opened by a new process, simply runs one
    session for its whole life via :func:`serve_shard`.

    Epoch guard: every coordinator command carries the coordinator epoch;
    a command older than the session's adopted epoch is answered with
    ``("stale", kind, cmd_epoch, session_epoch)`` and **not executed** —
    submit, DRAIN and (transitively) STAMP from a superseded coordinator
    are rejected.  Takeover (:meth:`claim`) additionally bumps a serve
    *generation* so a still-connected stale coordinator's serve loop exits
    (after a best-effort stale notification) instead of racing the
    successor's connection for the store.
    """

    def __init__(self, shard: int, spec: EmbShardSpec,
                 directory: Optional[str], seed,
                 fsync_payloads: bool = True, epoch: int = 0):
        seed_t, seed_a, seed_tr = seed
        self.shard = shard
        self.spec = spec
        self.store = _ShardStore(shard, spec, seed_t, seed_a,
                                 directory=directory, sliced=True,
                                 fsync_payloads=fsync_payloads)
        self.store.trainer_image = seed_tr
        self.epoch = epoch              # guarded by: lock
        self.err: Optional[str] = None  # guarded by: lock
        self.watermark = 0              # guarded by: lock
        self.lock = threading.RLock()
        self.gen = 0                    # guarded by: lock (adoption bump)

    # ------------------------------------------------------- takeover -----
    def claim(self, epoch: int) -> int:
        """Adopt this session for a newer coordinator epoch.  Returns the
        new serve generation; any serve loop holding an older generation
        exits at its next command instead of touching the store."""
        with self.lock:
            self.gen += 1
            self.epoch = epoch
            return self.gen

    def evict(self):
        """Invalidate every live serve loop (the session is being replaced
        by a fresh spawn)."""
        with self.lock:
            self.gen += 1

    def reconcile(self, directory: Optional[str], watermark: int, seed):
        """Successor-coordinator reconciliation: move the store's persist
        directory to the new run, reset the durable watermark to the last
        *stamped* seq, and — when ``seed`` is given — discard the gap by
        resetting the image to the stamped state (a kept image means the
        coordinator verified watermark == stamp).  Returns the watermark.
        """
        with self.lock:
            self.store.directory = directory
            if directory:
                os.makedirs(directory, exist_ok=True)
            self.store._pending_fsync = []
            self.store.applied = []
            self.watermark = watermark
            if seed is not None:
                seed_t, seed_a, seed_tr = seed
                for t in range(len(self.store.image_tables)):
                    self.store.image_tables[t][...] = seed_t[t]
                    self.store.image_accs[t][...] = seed_a[t]
                self.store.trainer_image = seed_tr
                self.err = None         # the reseed re-bases a latched err
            return self.watermark

    # ----------------------------------------------------------- serve ----
    def serve(self, chan, gen: int) -> str:
        """Apply loop over one connection.  Returns ``"parked"`` when the
        peer vanished (the session stays adoptable), ``"closed"`` on a
        clean close command, ``"superseded"`` when a takeover invalidated
        this connection's generation.

        Fail-stop: the first apply error is latched and reported; later
        apply commands are dropped (never applied out of order around the
        hole) while control commands (drain / image / ping) keep answering
        so the coordinator can fence.  DRAIN fsyncs the pending payloads
        before acking, making the returned watermark power-loss-durable.
        """
        while True:
            try:
                msg = chan.recv()
            except (EOFError, OSError, ProtocolError):
                return "parked"         # coordinator gone: await adoption
            # Runtime spec conformance BEFORE dispatch: a frame that is
            # not well-formed for the serving state (unknown kind, bad
            # arity, wrong field types, handshake frame mid-session) is
            # never executed — the shard poisons with a clean error
            # reply instead of an IndexError killing this thread.
            why = _spec_violation(msg, state="serving")
            if why is not None:
                why = f"protocol violation: {why}"
                with self.lock:
                    if self.err is None:
                        self.err = why
                try:
                    chan.send(("error", -1, why))
                except (BrokenPipeError, OSError):
                    return "parked"
                continue
            try:
                with self.lock:
                    if self.gen != gen:
                        # a successor adopted the session: tell the stale
                        # coordinator explicitly (it latches StaleEpoch),
                        # then hand the connection's thread back
                        try:
                            chan.send(("stale", "superseded", msg[1]
                                       if len(msg) > 1 else -1, self.epoch))
                        except (BrokenPipeError, OSError):
                            pass
                        return "superseded"
                    reply, done = self._handle(msg)
                if reply is not None:
                    chan.send(reply)
                if done:
                    return "closed"
            except (BrokenPipeError, OSError):
                return "parked"         # coordinator gone mid-reply
            except BaseException as e:
                # spec-shaped but semantically hostile payload (e.g. a
                # scalar where a range list belongs): poison, never die
                why = f"protocol violation: {type(e).__name__}: {e}"
                with self.lock:
                    if self.err is None:
                        self.err = why
                try:
                    chan.send(("error", -1, why))
                except (BrokenPipeError, OSError):
                    return "parked"

    def _handle(self, msg):         # holds: lock
        """Execute one command under ``self.lock``; returns (reply, done).
        Stale-epoch commands are rejected before any effect."""
        kind = msg[0]
        cmd_epoch = msg[1] if len(msg) > 1 else self.epoch
        if isinstance(cmd_epoch, int) and cmd_epoch < self.epoch:
            return ("stale", kind, cmd_epoch, self.epoch), False
        if kind == "close":
            return None, True
        if kind == "ping":
            return ("pong", msg[2]), False
        if kind == "drain":
            try:
                self.store.sync_payloads()      # power-loss-true watermark
            except BaseException as e:
                if self.err is None:
                    self.err = f"{type(e).__name__}: {e}"
            return ("drained", msg[2], self.watermark, self.err), False
        if kind == "image":
            # copies, not live refs: the reply is serialized after the
            # lock is released, and a concurrent takeover reconcile could
            # otherwise mutate the arrays mid-serialization
            return ("image", [t.copy() for t in self.store.image_tables],
                    [a.copy() for a in self.store.image_accs],
                    self.store.trainer_image), False
        if kind == "parity-get":
            # reconstruction read of a held XOR stripe; copies for the
            # same serialize-outside-the-lock reason as "image"
            tabs, accs = self.store.parity_stripe(msg[2])
            return ("parity-out", msg[2], tabs, accs), False
        if kind == "export":
            # reshard donor read: the rows of our image overlapping the
            # requested global [lo, hi) ranges, one pair per table
            t_out, a_out = [], []
            for t, r in enumerate(msg[2]):
                lo, hi = int(r[0]), int(r[1])
                slo, shi = self.store.ranges[t]
                a, b = max(lo, slo), min(hi, shi)
                if a < b:
                    t_out.append(self.store.image_tables[t]
                                 [a - slo:b - slo].copy())
                    a_out.append(self.store.image_accs[t]
                                 [a - slo:b - slo].copy())
                else:
                    t_out.append(self.store.image_tables[t][:0].copy())
                    a_out.append(self.store.image_accs[t][:0].copy())
            return ("rows-out", self.shard, t_out, a_out), False
        if kind == "reshard":
            # receiver rebuild for an online fleet resize: swap the store
            # to the new layout epoch, keeping the session (and its
            # connection, counters, watermark) alive.  The store is seeded
            # with pristine init slices; the stamped image follows as a
            # normal full save, so a previously latched error is cleared —
            # the post-reshard state is fully determined by that seed.
            try:
                _, _, sizes, n_sh, bounds, directory, s_t, s_a, s_tr = msg
                spec = EmbShardSpec(sizes, int(n_sh), boundaries=bounds)
                old = self.store
                store = _ShardStore(self.shard, spec, s_t, s_a,
                                    directory=directory or None, sliced=True,
                                    fsync_payloads=old.fsync_payloads)
                store.trainer_image = s_tr
                store.bytes_written = old.bytes_written
                store.save_events = old.save_events
                self.store = store
                self.spec = spec
                self.err = None
                return ("resharded", self.shard, self.watermark), False
            except BaseException as e:
                self.err = f"{type(e).__name__}: {e}"
                return ("error", -1, self.err), False
        if kind == "rebuild":
            # remote-disk reconcile: reset to the shipped init seed, then
            # replay the stamped-event plan from OUR local files (the
            # coordinator could not read this shard's directory).  Clears
            # a latched error like a reconcile reseed does.
            try:
                _, _, directory, watermark, s_t, s_a, s_tr, plan = msg
                self.store.directory = directory
                if directory:
                    os.makedirs(directory, exist_ok=True)
                self.store._pending_fsync = []
                self.store.applied = []
                for t in range(len(self.store.image_tables)):
                    self.store.image_tables[t][...] = s_t[t]
                    self.store.image_accs[t][...] = s_a[t]
                self.store.trainer_image = s_tr
                replay_plan_into_store(self.store, plan)
                self.watermark = watermark
                self.err = None
                return ("rebuilt", self.watermark), False
            except BaseException as e:
                self.err = f"{type(e).__name__}: {e}"
                return ("error", -1, self.err), False
        if self.err is not None:        # fail-stop: drop applies
            return None, False
        seq, step = msg[2], msg[3]
        try:
            if kind == "full":
                _apply_full_payload(self.store, self.spec, msg[4], step, seq)
            elif kind == "rows":
                table, rows, vals, avs = msg[4:]
                self.store.apply_rows(table, rows, vals, avs, step, seq)
            elif kind == "trainer":
                self.store.apply_trainer(msg[4], step, seq)
            elif kind == "parity":
                # soft in-memory stripe update: no manifest event, no disk
                # payload — acked with "parity-ok" instead of popping
                # ``applied`` (it never pushed one)
                op = msg[4]
                if op == "full":
                    nbytes = self.store.apply_parity_full(
                        msg[5], msg[6], msg[7], step, seq)
                elif op == "delta":
                    nbytes = self.store.apply_parity_delta(
                        msg[5], msg[6], msg[7], msg[8], msg[9], step, seq)
                else:
                    raise ValueError(f"unknown parity op {op!r}")
                self.watermark = seq
                return ("parity-ok", seq, nbytes), False
            else:
                raise ValueError(f"unknown command {kind!r}")
            self.watermark = seq        # durable at the next DRAIN fsync
            return ("ack", seq, self.store.applied.pop()), False
        except BaseException as e:      # latch + report, keep serving
            self.err = f"{type(e).__name__}: {e}"
            return ("error", seq, self.err), False


def serve_shard(chan, shard: int, spec: EmbShardSpec,
                directory: Optional[str], seed,
                fsync_payloads: bool = True, epoch: int = 0):
    """One shard writer's apply loop over a :class:`PipeChannel` /
    :class:`SockChannel` — one :class:`WriterSession` for the connection's
    whole life.  ``seed`` is ``(table_slices, acc_slices, trainer_image)``
    — only this shard's rows ever cross the transport at spawn."""
    session = WriterSession(shard, spec, directory, seed,
                            fsync_payloads=fsync_payloads, epoch=epoch)
    session.serve(chan, session.gen)


def _pipe_worker_main(conn, shard: int, spec: EmbShardSpec,
                      directory: Optional[str], seed, fsync_payloads: bool,
                      epoch: int = 0):
    """Pipe-transport child entry point (host numpy only; never creates a
    CUDA context)."""
    serve_shard(PipeChannel(conn), shard, spec, directory, seed,
                fsync_payloads, epoch=epoch)


# =========================================================================
# endpoints
# =========================================================================
class ShardEndpoint:
    """Per-shard handle the coordinator routes through.  Subclasses latch
    failures into ``_exc`` (fail-stop: it never clears except in a
    successful ``respawn``)."""

    #: True when the shard's image remains readable in the coordinator
    #: process even after the endpoint is poisoned (inproc: the store
    #: lives here; its image stays frozen at the last successful apply).
    image_survives_failure = False

    #: coordinator epoch carried on this endpoint's frames (remote
    #: transports); takeover bookkeeping read by ``attach_report``
    epoch = 0
    adopted = False
    reconciled: Optional[str] = None

    #: XOR-stripe accounting (soft state, separate from bytes_written)
    parity_bytes = 0
    parity_events = 0

    def __init__(self, shard: int):
        self.shard = shard
        self.applied: List[dict] = []   # acked events since last collect
        self.durable_seq = 0            # last drain-confirmed watermark
        self._exc: Optional[BaseException] = None

    @property
    def error(self) -> Optional[BaseException]:
        """The latched failure, if any (fail-stop: it never clears)."""
        return self._exc

    def poison(self, exc: BaseException):
        """Latch an externally observed failure (e.g. a failed respawn must
        leave the shard unambiguously out of the fleet)."""
        if self._exc is None:
            self._exc = exc

    # lifecycle hooks every transport implements ---------------------------
    def submit_full(self, ref: SnapshotRef, step: int, seq: int):
        raise NotImplementedError

    def submit_rows(self, table, rows, values, acc_values, step, seq):
        raise NotImplementedError

    def submit_trainer(self, tree, step, seq):
        raise NotImplementedError

    def submit_parity_full(self, group, tables, accs, step, seq):
        """Seed/replace the XOR stripe this writer holds for ``group``
        (soft in-memory redundancy state; see the parity frames in the
        module docstring)."""
        raise NotImplementedError

    def submit_parity_delta(self, group, table, stripe_rows, xvals,
                            xaccs, step, seq):
        """Fold a member row update (old-bytes XOR new-bytes) into the
        held stripe at ``stripe_rows``."""
        raise NotImplementedError

    def fetch_parity(self, group, timeout: float = DRAIN_TIMEOUT_S):
        """Reconstruction read: the writer's current stripe for
        ``group`` as ``(table_stripes, acc_stripes)``, or None when the
        writer is unreachable or holds no such group."""
        raise NotImplementedError

    def begin_drain(self, token: int) -> bool:
        raise NotImplementedError

    def finish_drain(self, token: int, timeout: float) -> bool:
        raise NotImplementedError

    def collect_applied(self) -> List[dict]:
        out, self.applied = self.applied, []
        return out

    def pump(self):
        pass

    def probe(self):
        """Heartbeat hook: cheaply verify liveness, latching on death.
        Never blocks the caller for long."""

    def fetch_image(self, timeout: float):
        raise NotImplementedError

    def export_rows(self, ranges, timeout: float = DRAIN_TIMEOUT_S):
        """Reshard donor read: the writer's image rows overlapping the
        global ``[lo, hi)`` ``ranges`` (one pair per table).  Returns
        ``(table_slices, acc_slices)`` or None when the writer is
        unreachable (the caller falls back to disk replay)."""
        raise NotImplementedError

    def reshard(self, spec: EmbShardSpec, seed, directory,
                timeout: float = DRAIN_TIMEOUT_S):
        """Swap the writer's store to a new layout epoch in place (the
        writer keeps its shard id, connection and counters).  ``seed`` is
        ``(table_slices, acc_slices, trainer_image)`` under the NEW
        layout.  Raises on failure — the transport then replaces the
        endpoint with a fresh spawn."""
        raise NotImplementedError

    def kill(self):
        raise NotImplementedError

    def respawn(self, seed_tables, seed_accs, trainer_image=None):
        raise NotImplementedError

    def close(self):
        raise NotImplementedError


class _InlineApplier:
    """Same surface as :class:`AsyncApplier`, applied on the caller thread
    (sync mode) with the same fail-stop latch semantics."""

    def __init__(self):
        self._exc: Optional[BaseException] = None

    @property
    def error(self) -> Optional[BaseException]:
        return self._exc

    def submit(self, fn, *args, **kw):
        """Apply inline; raises on the latching call (parity with
        ``AsyncApplier.submit`` raising once an error is latched) so the
        router never counts a failed apply as saved."""
        if self._exc is not None:              # fail-stop after error
            raise RuntimeError("shard writer failed") from self._exc
        try:
            fn(*args, **kw)
        except BaseException as e:
            self._exc = e
            raise RuntimeError("checkpoint apply failed") from e

    def fence(self):
        if self._exc is not None:
            raise RuntimeError("checkpoint apply failed") from self._exc

    def close(self):
        pass


class InprocEndpoint(ShardEndpoint):
    """The absorbed thread backend: one :class:`_ShardStore` under an
    in-process :class:`AsyncApplier` worker thread (or inline in sync
    mode).  A crash here takes the trainer down with it — that is the
    deal the inproc transport offers (zero isolation, zero IPC cost)."""

    image_survives_failure = True

    def __init__(self, shard: int, spec: EmbShardSpec, seed_tables,
                 seed_accs, trainer_image=None,
                 directory: Optional[str] = None, async_save: bool = True,
                 max_inflight: int = 2, fsync_payloads: bool = True):
        super().__init__(shard)
        self.async_save = async_save
        self.max_inflight = max_inflight
        self.store = _ShardStore(shard, spec, seed_tables, seed_accs,
                                 directory=directory, sliced=True,
                                 fsync_payloads=fsync_payloads)
        self.store.trainer_image = trainer_image
        self.applier = self._new_applier()

    # accounting reads the store live (exact immediately after an apply,
    # like the absorbed thread backend — remote endpoints count acks)
    @property
    def bytes_written(self) -> int:
        return self.store.bytes_written

    @property
    def save_events(self) -> int:
        return self.store.save_events

    def _new_applier(self):
        return (AsyncApplier(name=f"cpr-shard-ckpt-{self.shard}",
                             max_inflight=self.max_inflight)
                if self.async_save else _InlineApplier())

    @property
    def error(self):
        return self._exc or self.applier.error

    # -------------------------------------------------------- submits -----
    def submit_full(self, ref: SnapshotRef, step: int, seq: int):
        snap_t, snap_a = ref.payload_for(self.shard)
        # late-bind the store method so tests can monkeypatch apply_*
        self.applier.submit(lambda *a: self.store.apply_full(*a),
                            snap_t, snap_a, step, seq)

    def submit_rows(self, table, rows, values, acc_values, step, seq):
        self.applier.submit(lambda *a: self.store.apply_rows(*a),
                            table, rows, values, acc_values, step, seq)

    def submit_trainer(self, tree, step, seq):
        self.applier.submit(lambda *a: self.store.apply_trainer(*a),
                            tree, step, seq)

    def submit_parity_full(self, group, tables, accs, step, seq):
        self.applier.submit(lambda *a: self.store.apply_parity_full(*a),
                            group, tables, accs, step, seq)

    def submit_parity_delta(self, group, table, stripe_rows, xvals,
                            xaccs, step, seq):
        self.applier.submit(lambda *a: self.store.apply_parity_delta(*a),
                            group, table, stripe_rows, xvals, xaccs,
                            step, seq)

    def fetch_parity(self, group, timeout: float = DRAIN_TIMEOUT_S):
        # remote transports get read-after-submit consistency from the
        # channel FIFO; inproc reads bypass the applier queue, so drain
        # it first (an error here means the writer is poisoned -> unheld)
        try:
            self.applier.fence()
        except RuntimeError:
            return None
        tabs, accs = self.store.parity_stripe(group)
        if tabs is None:
            return None
        return tabs, accs

    # in-process applies land straight in the store; mirror its counters
    @property
    def parity_bytes(self):
        return self.store.parity_bytes

    @property
    def parity_events(self):
        return self.store.parity_events

    # ---------------------------------------------------------- drain -----
    def begin_drain(self, token: int) -> bool:
        return self.error is None

    def finish_drain(self, token: int, timeout: float) -> bool:
        try:
            self.applier.fence()
        except RuntimeError:
            return False
        try:
            self.store.sync_payloads()      # payloads durable before stamp
        except OSError as e:
            # an fsync failure (EIO, ENOSPC) poisons this shard only —
            # same per-shard fail-stop the remote workers' serve loop
            # gives it, never a fence-wide crash
            self.poison(e)
            return False
        return True

    def collect_applied(self) -> List[dict]:
        out, self.store.applied = self.store.applied, []
        for e in out:
            self.durable_seq = max(self.durable_seq, e["seq"])
        return out

    # --------------------------------------------------------- queries ----
    def fetch_image(self, timeout: float):
        # drain queued applies first so a healthy read is linearized with
        # submits (parity reconstruction XORs this against the holder
        # stripe); a poisoned applier keeps the frozen-image contract —
        # the image as of the last successful apply
        if self.error is None:
            try:
                self.applier.fence()
            except RuntimeError:
                pass
        return (self.store.image_tables, self.store.image_accs,
                self.store.trainer_image)

    def export_rows(self, ranges, timeout: float = DRAIN_TIMEOUT_S):
        if self.error is not None:
            return None
        out_t, out_a = [], []
        for t, (lo, hi) in enumerate(ranges):
            slo, shi = self.store.ranges[t]
            a, b = max(int(lo), slo), min(int(hi), shi)
            if a < b:
                out_t.append(self.store.image_tables[t][a - slo:b - slo]
                             .copy())
                out_a.append(self.store.image_accs[t][a - slo:b - slo]
                             .copy())
            else:
                out_t.append(self.store.image_tables[t][:0].copy())
                out_a.append(self.store.image_accs[t][:0].copy())
        return out_t, out_a

    def reshard(self, spec: EmbShardSpec, seed, directory,
                timeout: float = DRAIN_TIMEOUT_S):
        self.applier.fence()            # raises on a latched apply error
        old = self.store
        store = _ShardStore(self.shard, spec, seed[0], seed[1],
                            directory=directory, sliced=True,
                            fsync_payloads=old.fsync_payloads)
        store.trainer_image = seed[2]
        # the store carries the accounting (remote endpoints count acks
        # instead): carry it across the swap so resize doesn't reset it
        store.bytes_written = old.bytes_written
        store.save_events = old.save_events
        self.store = store

    # ----------------------------------------------------------- admin ----
    def kill(self):
        err = RuntimeError(f"shard {self.shard} writer killed (drill)")
        self.applier._exc = err         # same latch a worker error sets

    def respawn(self, seed_tables, seed_accs, trainer_image=None):
        """Fresh applier over the surviving store (the image lives in this
        process, so no reseed copy is needed — the caller ships a fresh
        full to cover anything the poisoned applier dropped)."""
        self.applier.close()
        self.applier = self._new_applier()
        self._exc = None

    def close(self):
        self.applier.close()


class RemoteEndpoint(ShardEndpoint):
    """Shared parent-side machinery for channel-backed workers (pipe +
    socket): reply pump, ordered DRAIN collection, image fetch, accounting
    from acks.  Accounting is exact only after a fence, like the inproc
    applier.  Subclasses provide the channel, liveness, spawn/respawn."""

    def __init__(self, shard: int, epoch: int = 0):
        super().__init__(shard)
        self.epoch = epoch              # carried on every outbound frame
        self.adopted = False            # True when attach() re-used a live
        self.reconciled = None          # writer: "kept" | "reseeded"
        self.bytes_written = 0          # fed by acks; exact after a fence
        self.save_events = 0
        self.parity_bytes = 0           # fed by parity-ok acks
        self.parity_events = 0
        self._chan = None
        self._io_lock = threading.RLock()
        self._last_activity = time.monotonic()  # guarded by: _io_lock

    # ------------------------------------------------------ liveness ------
    def _alive(self) -> bool:
        raise NotImplementedError

    def _latch(self, why: str):
        if self._exc is None:
            self._exc = WriterProcError(
                f"shard {self.shard} writer {why}")

    # --------------------------------------------------------- pump -------
    def _dispatch_reply(self, msg) -> str:  # holds: _io_lock
        """Fold one worker reply into parent-side state; returns its kind."""
        self._last_activity = time.monotonic()
        kind = msg[0]
        if kind == "ack":
            ev = msg[2]
            self.bytes_written += ev["bytes"]
            self.save_events += 1
            self.applied.append(dict(ev))
        elif kind == "error":
            if self._exc is None:
                self._exc = WriterProcError(
                    f"shard {self.shard} writer apply failed "
                    f"(seq {msg[1]}): {msg[2]}")
        elif kind == "stale":
            if self._exc is None or not isinstance(self._exc,
                                                   StaleEpochError):
                self._exc = StaleEpochError(
                    f"shard {self.shard} writer rejected {msg[1]!r}: "
                    f"coordinator epoch {msg[2]} superseded by epoch "
                    f"{msg[3]}")
        elif kind == "parity-ok":
            # stripe updates are soft state: counted, never in ``applied``
            self.parity_bytes += msg[2]
            self.parity_events += 1
        elif kind == "pong":
            self._last_pong = (msg[1], time.monotonic())
        return kind

    def pump(self):
        """Fold every already-available reply without blocking (keeps the
        worker's reply stream from filling between fences).  Safe on a dead
        worker: its buffered acks — saves it durably applied+persisted
        before dying — are still folded, so the fence can stamp them."""
        with self._io_lock:
            try:
                while self._chan is not None and self._chan.poll(0):
                    self._dispatch_reply(self._chan.recv())
            except ProtocolError as e:
                self._latch(f"protocol violation: {e}")
            except (EOFError, OSError):
                self._latch("died")

    def _recv_until(self, want: str, timeout: float):
        """Consume replies until one of kind ``want`` arrives; None on
        worker death or timeout (the caller poisons the shard)."""
        deadline = time.monotonic() + timeout
        with self._io_lock:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._latch(f"missed {want} deadline ({timeout:.0f}s)")
                    return None
                try:
                    if self._chan.poll(min(remaining, 0.05)):
                        msg = self._chan.recv()
                        kind = self._dispatch_reply(msg)
                        if kind == want:
                            return msg
                        if kind == "stale":
                            # the writer belongs to a successor now: it
                            # will never answer this coordinator's command
                            return None
                    elif not self._alive():
                        # dead — but the stream may still hold buffered
                        # replies the worker sent before dying
                        while self._chan.poll(0):
                            msg = self._chan.recv()
                            if self._dispatch_reply(msg) == want:
                                return msg
                        self._latch("died")
                        return None
                except ProtocolError as e:
                    self._latch(f"protocol violation: {e}")
                    return None
                except (EOFError, OSError):
                    self._latch("died")
                    return None

    # -------------------------------------------------------- submits -----
    def _send(self, msg):
        if self._exc is not None:
            raise RuntimeError("shard writer failed") from self._exc
        self.pump()
        try:
            self._send_raw(msg)
        except (BrokenPipeError, OSError) as e:
            self._latch("died")
            raise RuntimeError("shard writer died") from e
        if self._exc is not None:
            raise RuntimeError("shard writer failed") from self._exc

    def _send_raw(self, msg):
        self._chan.send(msg)

    def submit_full(self, ref: SnapshotRef, step: int, seq: int):
        self._send(("full", self.epoch, seq, step, self._full_payload(ref)))

    def _full_payload(self, ref: SnapshotRef):
        return ref.payload_for(self.shard)

    def submit_rows(self, table, rows, values, acc_values, step, seq):
        self._send(("rows", self.epoch, seq, step, int(table),
                    np.asarray(rows), np.asarray(values),
                    np.asarray(acc_values)))

    def submit_trainer(self, tree, step, seq):
        self._send(("trainer", self.epoch, seq, step, tree))

    def submit_parity_full(self, group, tables, accs, step, seq):
        self._send(("parity", self.epoch, seq, step, "full", int(group),
                    [np.ascontiguousarray(t) for t in tables],
                    [np.ascontiguousarray(a) for a in accs]))

    def submit_parity_delta(self, group, table, stripe_rows, xvals,
                            xaccs, step, seq):
        self._send(("parity", self.epoch, seq, step, "delta", int(group),
                    int(table), np.asarray(stripe_rows),
                    np.ascontiguousarray(xvals),
                    np.ascontiguousarray(xaccs)))

    def fetch_parity(self, group, timeout: float = DRAIN_TIMEOUT_S):
        try:
            self._send(("parity-get", self.epoch, int(group)))
        except RuntimeError:
            return None
        msg = self._recv_until("parity-out", timeout)
        if msg is None or msg[2] is None:
            return None
        return list(msg[2]), list(msg[3])

    # ---------------------------------------------------------- drain -----
    def begin_drain(self, token: int) -> bool:
        """Phase-1 broadcast half: enqueue the DRAIN marker.  Returns False
        (and latches) when the worker is already unreachable."""
        try:
            self._send(("drain", self.epoch, token))
            return True
        except RuntimeError:
            return False

    def finish_drain(self, token: int,
                     timeout: float = DRAIN_TIMEOUT_S) -> bool:
        """Phase-1 collect half: block until the worker acks the DRAIN
        marker (all prior applies done, persisted **and fsynced**), folding
        every in-flight ack on the way.  Updates ``durable_seq`` from the
        acked watermark.  False — with the shard latched poisoned — on
        worker death, apply error, or deadline miss."""
        while True:
            msg = self._recv_until("drained", timeout)
            if msg is None:
                return False
            _, got_token, watermark, err = msg
            self.durable_seq = max(self.durable_seq, watermark)
            if err is not None and self._exc is None:
                self._exc = WriterProcError(
                    f"shard {self.shard} writer apply failed: {err}")
            if got_token == token:
                return self._exc is None
            # stale token from an earlier aborted fence: keep consuming

    # --------------------------------------------------------- queries ----
    def fetch_image(self, timeout: float = DRAIN_TIMEOUT_S):
        """Pull (image_tables, image_accs, trainer_image) back from the
        worker; None when the worker is unreachable."""
        try:
            self._send(("image", self.epoch))
        except RuntimeError:
            return None
        msg = self._recv_until("image", timeout)
        if msg is None:
            return None
        return list(msg[1]), list(msg[2]), msg[3]

    def export_rows(self, ranges, timeout: float = DRAIN_TIMEOUT_S):
        try:
            self._send(("export", self.epoch,
                        [[int(lo), int(hi)] for lo, hi in ranges]))
        except RuntimeError:
            return None
        msg = self._recv_until("rows-out", timeout)
        if msg is None:
            return None
        return list(msg[2]), list(msg[3])

    def reshard(self, spec: EmbShardSpec, seed, directory,
                timeout: float = DRAIN_TIMEOUT_S):
        seed = _host_seed(*seed)
        # the spec types the directory slot str: a fleet without a
        # directory sends "" (the reference sends None, which its servers
        # refuse, so its donors time out and respawn instead)
        self._send(("reshard", self.epoch, list(spec.table_sizes),
                    spec.n_shards, [b.tolist() for b in spec.boundaries],
                    directory or "", seed[0], seed[1], seed[2]))
        msg = self._recv_until("resharded", timeout)
        if msg is None or self._exc is not None:
            raise WriterProcError(
                f"shard {self.shard} writer reshard failed"
            ) from self._exc
        self.spec = spec
        self.directory = directory

    def close(self):
        """Best-effort shutdown; never raises."""
        try:
            self._send_raw(("close", self.epoch))
        except (BrokenPipeError, OSError, RuntimeError):
            pass
        self._teardown(graceful=True)
        if self._chan is not None:
            self._chan.close()

    def _teardown(self, graceful: bool):
        pass


class PipeEndpoint(RemoteEndpoint):
    """One shard writer behind an OS process boundary, fed over a duplex
    ``multiprocessing`` pipe (spawn context: no fork — the trainer holds
    CUDA state and threads/locks a fork
    would clone).  Worker death (any crash, incl.
    SIGKILL) latches the handle fail-stop — one dead writer poisons one
    shard, never the trainer."""

    def __init__(self, shard: int, spec: EmbShardSpec, seed_tables,
                 seed_accs, trainer_image=None,
                 directory: Optional[str] = None,
                 fsync_payloads: bool = True, epoch: int = 0):
        super().__init__(shard, epoch=epoch)
        self.spec = spec
        self.directory = directory
        self.fsync_payloads = fsync_payloads
        self._spawn(seed_tables, seed_accs, trainer_image)

    def _spawn(self, seed_tables, seed_accs, trainer_image):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        parent, child = ctx.Pipe()
        seed = _host_seed(seed_tables, seed_accs, trainer_image)
        self.proc = ctx.Process(
            target=_pipe_worker_main,
            args=(child, self.shard, self.spec, self.directory, seed,
                  self.fsync_payloads, self.epoch),
            name=f"cpr-shard-writer-{self.shard}", daemon=True)
        self.proc.start()
        child.close()                   # child's end lives in the child now
        self._chan = PipeChannel(parent)
        self._conn = parent             # crash drills poke the raw pipe

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid

    def _alive(self) -> bool:
        return self.proc.is_alive()

    def _latch(self, why: str):
        if self._exc is None:
            code = self.proc.exitcode
            self._exc = WriterProcError(
                f"shard {self.shard} writer process (pid {self.proc.pid}) "
                f"{why}" + (f" [exitcode {code}]"
                            if code is not None else ""))

    def probe(self):
        """Heartbeat: a writer process that died between saves is latched
        here instead of at the next submit/fence.  Buffered acks are NOT
        consumed (the fence pump still collects them for stamping)."""
        if self._exc is None and not self.proc.is_alive():
            self._latch("died (heartbeat)")

    def kill(self):
        """Hard-kill the worker (SIGKILL) — the crash-injection surface the
        recovery suite drives; also usable as an operator failure drill."""
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join(timeout=5.0)
        self._latch("was killed")

    def respawn(self, seed_tables, seed_accs, trainer_image=None):
        """Re-admission: replace a dead/poisoned worker with a fresh process
        seeded from the caller's last-good image slices.  Atomic: the latch
        clears only after the fresh worker is up — a spawn failure re-latches
        and re-raises, leaving the shard unambiguously poisoned."""
        self._teardown(graceful=False)
        try:
            self._spawn(seed_tables, seed_accs, trainer_image)
        except BaseException as e:
            self._exc = WriterProcError(
                f"shard {self.shard} writer respawn failed: "
                f"{type(e).__name__}: {e}")
            raise
        self._exc = None
        self.applied = []

    def _teardown(self, graceful: bool):
        if self._chan is not None:
            self._chan.close()
        if getattr(self, "proc", None) is None:
            return
        if self.proc.is_alive() and not graceful:
            self.proc.kill()
        self.proc.join(timeout=5.0)
        if self.proc.is_alive():
            self.proc.kill()
            self.proc.join(timeout=5.0)


def _start_loopback_server(name: str):
    """Start a loopback ``shard_server`` process: (bootstrap pipe, proc)."""
    import multiprocessing as mp

    from repro_torch.launch import shard_server
    ctx = mp.get_context("spawn")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=shard_server.spawned_server_main,
                       args=(child, "127.0.0.1"),
                       name=name, daemon=True)
    proc.start()
    child.close()
    return parent, proc


def _await_loopback_server(parent, proc, connect_timeout: float, name: str):
    """The started server's ``((host, port), proc)``: the child binds port
    0 and reports the real port back over the bootstrap pipe."""
    if not parent.poll(connect_timeout):
        proc.kill()
        raise WriterProcError(f"{name} failed to report its port")
    host, port = parent.recv()
    parent.close()
    return (host, port), proc


def spawn_loopback_server(connect_timeout: float, name: str):
    """Launch a loopback ``shard_server`` process and return
    ``((host, port), proc)``.  Re-admission and the attach fallback spawn
    one at a time; a new fleet starts its servers together
    (``spawn_loopback_servers``)."""
    return _await_loopback_server(*_start_loopback_server(name),
                                  connect_timeout, name)


def spawn_loopback_servers(connect_timeout: float, names: Sequence[str]):
    """``spawn_loopback_server`` for every name, the processes started
    together (a server takes seconds to import its modules; one at a time
    a fleet pays that once per shard).  If one fails to report, every
    server started here is killed."""
    started = [_start_loopback_server(name) for name in names]
    out = []
    try:
        for (parent, proc), name in zip(started, names):
            out.append(_await_loopback_server(parent, proc, connect_timeout,
                                              name))
    except BaseException:
        for parent, proc in started:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=5.0)
            parent.close()
        raise
    return out


class SocketEndpoint(RemoteEndpoint):
    """One shard writer on the far side of a TCP connection, speaking the
    length-prefixed frame protocol.

    Two modes: connect to an external ``repro_torch.launch.shard_server``
    (``address=(host, port)`` — the multi-host deployment), or auto-spawn a
    loopback server process per shard (tests, benchmarks, drills).

    Submits are enqueued to a bounded outbound queue drained by a sender
    thread: a partitioned or wedged remote writer fills the queue and gets
    poisoned after ``submit_timeout`` — it never blocks the trainer.
    Heartbeats ride the same connection (``ping``/``pong``); a missed pong
    for ``heartbeat_timeout`` latches the endpoint.

    **Coordinator failover:** with ``attach_watermark`` set, the first
    connection attempts the ``attach`` handshake instead of ``spawn``: a
    writer session the server parked when the previous coordinator died is
    adopted (epoch takeover), reconciled against the last stamped
    watermark (kept in place when they match, reseeded from the provided
    stamped image otherwise), and resumes serving — without respawning
    the remote writer or re-shipping its whole state."""

    _CLOSE = object()

    def __init__(self, shard: int, spec: EmbShardSpec, seed_tables,
                 seed_accs, trainer_image=None,
                 directory: Optional[str] = None,
                 address: Optional[Tuple[str, int]] = None,
                 fsync_payloads: bool = True,
                 connect_timeout: float = 20.0,
                 submit_timeout: float = SUBMIT_TIMEOUT_S,
                 heartbeat_timeout: float = HEARTBEAT_TIMEOUT_S,
                 epoch: int = 0,
                 attach_watermark: Optional[int] = None,
                 attach_seed_ok: bool = True,
                 attach_fallback_spawn: bool = False,
                 attach_rebuild_plan=None,
                 codec_level: int = 0,
                 codec_floor: int = CODEC_FLOOR_BYTES,
                 shm_probe: Optional[ShmProbe] = None,
                 mux_conn: Optional[MuxConnection] = None,
                 server=None):
        super().__init__(shard, epoch=epoch)
        self.spec = spec
        self.directory = directory
        self.fsync_payloads = fsync_payloads
        self.address = tuple(address) if address else None
        self.effective_address: Optional[Tuple[str, int]] = None
        self.connect_timeout = connect_timeout
        self.submit_timeout = submit_timeout
        self.heartbeat_timeout = heartbeat_timeout
        self._attach_watermark = attach_watermark   # first connect only
        self._attach_seed_ok = attach_seed_ok
        self._attach_fallback = attach_fallback_spawn
        self._rebuild_plan = attach_rebuild_plan    # remote-disk reconcile
        self.codec_level = int(codec_level)
        self.codec_floor = int(codec_floor)
        self._shm_probe = shm_probe     # transport-owned; offered in hello
        self._mux = mux_conn            # shared connection (first spawn)
        # the mux group's auto-spawned server is transport-owned: visible
        # for liveness checks + crash drills, never killed by _teardown
        self._shared_server = mux_conn.server_proc if mux_conn else None
        self.shm_ok = False             # hello verified same-machine shm
        self._server_proc = None        # auto-spawned server (owned)
        # an owned server the transport already started for the first
        # spawn: ((host, port), proc)
        self._server_ready = server
        self._outq: Optional[queue.Queue] = None
        self._sender: Optional[threading.Thread] = None
        self._ping_token = 0
        self._ping_sent_at = 0.0
        self._last_pong = (0, 0.0)
        try:
            self._spawn(seed_tables, seed_accs, trainer_image)
        except (WriterProcError, OSError) as e:
            if attach_watermark is None:
                raise
            # a failed adoption poisons this one shard — the successor
            # coordinator still takes over the rest of the fleet; readmit
            # can revive the shard at a later boundary
            self.poison(e if isinstance(e, WriterProcError) else
                        WriterProcError(f"shard {shard} attach failed: {e}"))

    # ------------------------------------------------------------ spawn ---
    def _spawn_server(self) -> Tuple[str, int]:
        """Auto-spawn this shard's own loopback ``shard_server`` (the first
        time, take the one the transport started for it)."""
        if self._server_ready is not None:
            (addr, proc), self._server_ready = self._server_ready, None
        else:
            addr, proc = spawn_loopback_server(
                self.connect_timeout, f"cpr-shard-server-{self.shard}")
        self._server_proc = proc
        return addr

    def _spawn(self, seed_tables, seed_accs, trainer_image):
        seed = _host_seed(seed_tables, seed_accs, trainer_image)
        if self._mux is not None:
            # first spawn over a shared mux connection: the transport
            # already ran the hello (codec + shm negotiation) for the
            # whole group.  Later respawns open a dedicated connection —
            # re-admission deliberately leaves the failed group.
            mux, self._mux = self._mux, None
            chan = mux.channel(self.shard)
            self.shm_ok = mux.shm_ok
            addr = mux.address
            if self._attach_watermark is not None:
                self._attach(chan, seed)
                self._attach_watermark = None
            else:
                chan.send(("spawn", self.shard,
                           list(self.spec.table_sizes),
                           self.spec.n_shards, self.directory,
                           seed[0], seed[1], seed[2], self.fsync_payloads,
                           self.epoch,
                           [b.tolist() for b in self.spec.boundaries]))
        else:
            addr = self.address
            if addr is None:
                addr = self._spawn_server()
            try:
                sock = _socket.create_connection(
                    addr, timeout=self.connect_timeout)
            except OSError:
                if not (self._attach_watermark is not None and
                        self._attach_fallback and self.address is not None):
                    raise
                # the recorded loopback server died with the previous
                # coordinator (it owned the process): nothing is left to
                # adopt, so degrade to a fresh auto-spawned writer seeded
                # with the stamped image instead of poisoning the shard
                self.address = None
                self._attach_watermark = None
                addr = self._spawn_server()
                sock = _socket.create_connection(
                    addr, timeout=self.connect_timeout)
            chan = SockChannel(sock)
            if self.codec_level or self._shm_probe is not None:
                hello = client_hello(
                    chan, self.epoch, codec_level=self.codec_level,
                    codec_floor=self.codec_floor,
                    shm_probe=(self._shm_probe
                               if is_loopback_address(addr) else None),
                    timeout=self.connect_timeout)
                self.shm_ok = bool(hello.get("shm"))
            if self._attach_watermark is not None:
                self._attach(chan, seed)
                self._attach_watermark = None   # later respawns spawn fresh
            else:
                chan.send(("spawn", self.shard,
                           list(self.spec.table_sizes),
                           self.spec.n_shards, self.directory,
                           seed[0], seed[1], seed[2], self.fsync_payloads,
                           self.epoch,
                           [b.tolist() for b in self.spec.boundaries]))
        self.effective_address = tuple(addr)
        self._chan = chan
        self._outq = queue.Queue(maxsize=SUBMIT_QUEUE_DEPTH)
        self._sender = threading.Thread(
            target=self._sender_loop, args=(chan, self._outq),
            name=f"cpr-sock-send-{self.shard}", daemon=True)
        self._sender.start()
        self._ping_token = 0
        self._ping_sent_at = 0.0
        self._last_pong = (0, time.monotonic())

    def _attach(self, chan: SockChannel, seed):
        """Coordinator-failover handshake: adopt the parked (or still
        nominally-connected) writer session on the far side instead of
        spawning a fresh one.  Falls back to a normal spawn — seeded with
        the stamped image — when the server has no session for this shard
        (server restarted, or the writer never existed)."""
        wm = self._attach_watermark
        chan.send(("attach", self.epoch, self.shard))
        reply = self._handshake_recv(chan)
        if reply[0] == "no-writer":
            chan.send(("spawn", self.shard, list(self.spec.table_sizes),
                       self.spec.n_shards, self.directory,
                       seed[0], seed[1], seed[2], self.fsync_payloads,
                       self.epoch,
                       [b.tolist() for b in self.spec.boundaries]))
            if self._rebuild_plan is not None:
                # the seed we just spawned with is only the init image
                # (the stamped one was unreadable coordinator-side): have
                # the fresh writer replay the stamped plan from its disk
                chan.send(("rebuild", self.epoch, self.directory, wm,
                           seed[0], seed[1], seed[2], self._rebuild_plan))
                reply = self._handshake_recv(chan)
                if reply[0] != "rebuilt":
                    raise WriterProcError(
                        f"shard {self.shard} spawn-rebuild got "
                        f"{reply[0]!r}: {reply[1:]}")
                self.durable_seq = max(self.durable_seq, wm)
                self.reconciled = "rebuilt"
            return
        if reply[0] == "stale":
            raise StaleEpochError(
                f"shard {self.shard} attach rejected: epoch {self.epoch} "
                f"superseded by {reply[3]}")
        if reply[0] != "attach-ok":
            raise WriterProcError(
                f"shard {self.shard} attach handshake got {reply[0]!r}")
        _, writer_wm, writer_err = reply
        keep = writer_wm == wm and writer_err is None
        if keep:
            # the writer's durable watermark is exactly the last stamp:
            # adopt its image in place, no state crosses the wire
            chan.send(("reconcile", self.epoch, self.directory, wm,
                       None, None, None))
        elif self._rebuild_plan is not None:
            # the stamped image could not be replayed coordinator-side
            # (unreadable shard directory / remote disk): reset the writer
            # to the init seed and have it replay the stamped plan from
            # its OWN local files instead of poisoning the shard
            chan.send(("rebuild", self.epoch, self.directory, wm,
                       seed[0], seed[1], seed[2], self._rebuild_plan))
            reply = self._handshake_recv(chan)
            if reply[0] == "stale":
                raise StaleEpochError(
                    f"shard {self.shard} rebuild rejected: epoch "
                    f"{self.epoch} superseded by {reply[3]}")
            if reply[0] != "rebuilt":
                raise WriterProcError(
                    f"shard {self.shard} rebuild got {reply[0]!r}: "
                    f"{reply[1:]}")
            self.durable_seq = max(self.durable_seq, wm)
            self.adopted = True
            self.reconciled = "rebuilt"
            return
        else:
            # a gap (applied-but-unstamped work, a lost writer tail, or a
            # latched apply error): discard it by reseeding the stamped
            # image — which needs the coordinator-side disk replay
            if not self._attach_seed_ok:
                raise WriterProcError(
                    f"shard {self.shard} writer watermark {writer_wm} != "
                    f"stamp {wm} and its stamped image could not be "
                    f"replayed coordinator-side (remote-only storage?)")
            chan.send(("reconcile", self.epoch, self.directory, wm,
                       seed[0], seed[1], seed[2]))
        reply = self._handshake_recv(chan)
        if reply[0] == "stale":
            raise StaleEpochError(
                f"shard {self.shard} reconcile rejected: epoch "
                f"{self.epoch} superseded by {reply[3]}")
        if reply[0] != "reconciled":
            raise WriterProcError(
                f"shard {self.shard} reconcile got {reply[0]!r}")
        self.durable_seq = max(self.durable_seq, wm)
        self.adopted = True
        self.reconciled = "kept" if keep else "reseeded"

    def _handshake_recv(self, chan: SockChannel):
        if not chan.poll(self.connect_timeout):
            raise WriterProcError(
                f"shard {self.shard} attach handshake timed out "
                f"({self.connect_timeout:.0f}s)")
        return chan.recv()

    def _sender_loop(self, chan: SockChannel, q: queue.Queue):
        """Drain the outbound queue onto the socket.  ``save_full``
        payloads are materialized here — slicing the snapshot and packing
        it happen off the trainer's critical path.  A send failure latches
        the endpoint but keeps consuming, so producers blocked on a full
        queue are released instead of wedged."""
        while True:
            item = q.get()
            if item is self._CLOSE:
                return
            try:
                if item[0] == "full":   # lazy: (kind, epoch, seq, step, ref)
                    item = ("full", item[1], item[2], item[3],
                            item[4].payload_for(self.shard))
                chan.send(item)
            except (BrokenPipeError, OSError):
                self._latch("connection lost")

    def submit_full(self, ref: SnapshotRef, step: int, seq: int):
        # ship the ref itself; the sender thread slices + packs (the queued
        # frame keeps the ref's arrays alive; a shared-memory ref also
        # stays pending in the transport until the fence releases it)
        self._send(("full", self.epoch, seq, step, ref))

    # ------------------------------------------------------------ wires ---
    def _alive(self) -> bool:
        if self._server_proc is not None:
            return self._server_proc.is_alive()
        if self._shared_server is not None:
            return self._shared_server.is_alive()
        return True                     # external server: trust the stream

    def _send_raw(self, msg):
        if self._outq is None:          # attach never connected
            raise BrokenPipeError("endpoint never connected")
        try:
            self._outq.put(msg, timeout=self.submit_timeout)
        except queue.Full:
            self._latch(f"submit stalled ({self.submit_timeout:.0f}s): "
                        f"outbound queue full")
            raise BrokenPipeError("outbound queue full")
        if self._exc is not None:       # sender latched while we waited
            raise BrokenPipeError("connection lost")

    # -------------------------------------------------------- heartbeat ---
    def probe(self):
        """Heartbeat: detect a dead server / severed connection between
        saves.  Sends a ping and latches when the previous ping went
        unanswered for ``heartbeat_timeout``."""
        if self._exc is not None:
            return
        if not self._alive():
            self._latch("server process died (heartbeat)")
            return
        if self._io_lock.acquire(blocking=False):
            try:
                while self._chan.poll(0):
                    self._dispatch_reply(self._chan.recv())
            except ProtocolError as e:
                self._latch(f"protocol violation: {e}")
                return
            except (EOFError, OSError):
                self._latch("connection lost (heartbeat)")
                return
            finally:
                self._io_lock.release()
        now = time.monotonic()
        answered = self._last_pong[0] >= self._ping_token
        if (not answered and self._ping_sent_at and
                now - self._ping_sent_at > self.heartbeat_timeout and
                # lint: allow[lock-discipline] deliberately lock-free read:
                # worst case is one extra ping before latching, never a
                # false latch (activity timestamps only move forward)
                now - self._last_activity > self.heartbeat_timeout):
            # no pong AND no other reply either: the link (or worker) is
            # truly silent.  A worker busy inside one long apply keeps
            # producing acks — that counts as alive.
            self._latch(f"heartbeat timed out "
                        f"({self.heartbeat_timeout:.0f}s of silence)")
            return
        if answered:
            self._ping_token += 1
            self._ping_sent_at = now
            try:
                self._outq.put_nowait(("ping", self.epoch, self._ping_token))
            except queue.Full:
                pass                    # submit back-pressure covers this

    # ------------------------------------------------------------- admin --
    def sever(self):
        """Failure drill: cut the TCP connection (simulates a network
        partition) without touching the remote server.  On a mux member
        this severs the *shared* connection — the partition surface is the
        connection, so exactly the co-resident shards are poisoned."""
        if self._chan is not None:
            sever = getattr(self._chan, "sever_connection", None)
            (sever if sever is not None else self._chan.close)()

    def kill(self):
        """Hard-kill: SIGKILL the owned server process (crash drill) —
        for a mux member that is the shared group server, taking the whole
        group down — or sever the connection to an external one."""
        if self._server_proc is not None:
            if self._server_proc.is_alive():
                self._server_proc.kill()
            self._server_proc.join(timeout=5.0)
            self._latch("server was killed")
        elif self._shared_server is not None:
            if self._shared_server.is_alive():
                self._shared_server.kill()
            self._shared_server.join(timeout=5.0)
            self._latch("server was killed")
        else:
            self.sever()
            self._latch("connection severed")

    @property
    def pid(self) -> Optional[int]:
        """The owned (or mux-group-shared) server's pid (None for external
        servers) — crash drills SIGKILL it directly."""
        if self._server_proc is not None:
            return self._server_proc.pid
        if self._shared_server is not None:
            return self._shared_server.pid
        return None

    def respawn(self, seed_tables, seed_accs, trainer_image=None):
        """Re-admission: reconnect (re-launching the owned server if it
        died) and seed a fresh writer incarnation over the wire.  Atomic:
        on any failure the latch is (re)set and the error re-raised — the
        shard stays poisoned and can retry at the next boundary."""
        self._teardown(graceful=False)
        self._attach_watermark = None   # re-admission always spawns fresh
        self._mux = None                # readmit leaves the old mux group
        self._shared_server = None
        try:
            self._spawn(seed_tables, seed_accs, trainer_image)
        except BaseException as e:
            self._exc = WriterProcError(
                f"shard {self.shard} writer respawn failed: "
                f"{type(e).__name__}: {e}")
            raise
        self._exc = None
        self.applied = []

    def _teardown(self, graceful: bool):
        if self._outq is not None:
            try:
                self._outq.put_nowait(self._CLOSE)
            except queue.Full:
                pass
        if self._chan is not None:
            self._chan.close()
        if self._sender is not None:
            self._sender.join(timeout=2.0)
            self._sender = None
        if self._server_proc is not None:
            # an owned server serves until it is killed, and the writer
            # fenced before closing: after the close frame nothing is left
            # to wait for (the reference waits 5 s for an exit that never
            # comes)
            if self._server_proc.is_alive():
                self._server_proc.kill()
            self._server_proc.join(timeout=5.0)
            self._server_proc = None

    def close(self):
        try:
            self._send_raw(("close", self.epoch))
        except (BrokenPipeError, OSError, RuntimeError):
            pass
        time.sleep(0)                   # let the sender flush the close
        self._teardown(graceful=True)


# =========================================================================
# transports
# =========================================================================
class ShardTransport:
    """Fleet-level abstraction: owns the per-shard endpoints and the
    ``save_full`` snapshot-shipping strategy.  ``release_pending()`` is
    called by the coordinator at each fence, once every healthy shard has
    acked past the pending snapshots."""

    name = "abstract"
    #: remote transports keep coordinator-side image caches + disk-replay
    #: fallbacks; the inproc transport's images live in this process
    is_remote = True

    def __init__(self, epoch: int = 0):
        self.epoch = epoch
        self.endpoints: List[ShardEndpoint] = []
        self._pending: List[SnapshotRef] = []

    @property
    def addresses(self) -> Optional[list]:
        """The effective per-shard writer addresses (socket transport
        only) — persisted in the coordinator's durable state so a standby
        coordinator can re-attach to the same writer fleet."""
        return None

    def wire_stats(self) -> Optional[Dict[str, int]]:
        """Raw-vs-wire byte counters (socket transport only)."""
        return None

    def make_snapshot(self, seq: int, snap_t, snap_a) -> SnapshotRef:
        ref = self._make_snapshot(seq, snap_t, snap_a)
        if ref.holds_resource:
            self._pending.append(ref)
        return ref

    def _make_snapshot(self, seq, snap_t, snap_a) -> SnapshotRef:
        raise NotImplementedError

    def release_pending(self):
        for ref in self._pending:
            ref.release()
        self._pending = []

    # ------------------------------------------------------ fleet resize --
    def _spawn_endpoint(self, shard: int, spec: EmbShardSpec, seed,
                        shard_dir, address=None) -> ShardEndpoint:
        raise NotImplementedError

    def resize_fleet(self, spec: EmbShardSpec, seeds, shard_dirs,
                     addresses: Optional[Sequence] = None):
        """Rebuild the endpoint fleet for a new layout epoch (called by
        ``ShardedCheckpointWriter.resize`` inside a fence window, after the
        old layout was stamped).  Retained shards (``j < min(old, new)``)
        are resharded *in place* — session, connection and counters survive
        — falling back to a fresh spawn when the in-place swap fails;
        growth shards are spawned fresh; surplus shards are closed.
        ``seeds[j]`` are pristine init slices under the NEW layout (the
        stamped image follows as a normal full save)."""
        old = self.endpoints
        new_n = spec.n_shards
        keep = min(len(old), new_n)
        eps: List[ShardEndpoint] = []
        for j in range(keep):
            ep = old[j]
            ok = False
            if ep.error is None:
                try:
                    ep.reshard(spec, seeds[j], shard_dirs[j])
                    ok = True
                # lint: allow[exception-hygiene] recovery IS the handler:
                # a failed in-place reshard falls through to a fresh spawn
                except Exception:
                    pass                # fall through to a fresh spawn
            if not ok:
                try:
                    ep.close()
                # lint: allow[exception-hygiene] closing a writer we are
                # about to replace; its successor spawn is the recovery
                except Exception:
                    pass
                ep = self._spawn_endpoint(
                    j, spec, seeds[j], shard_dirs[j],
                    address=(addresses[j] if addresses else None))
            eps.append(ep)
        for j in range(keep, new_n):    # growth: fresh receivers
            eps.append(self._spawn_endpoint(
                j, spec, seeds[j], shard_dirs[j],
                address=(addresses[j] if addresses else None)))
        for ep in old[new_n:]:          # shrink: retire surplus donors
            try:
                ep.close()
            # lint: allow[exception-hygiene] retiring surplus donors after
            # their rows were exported; nothing left to surface
            except Exception:
                pass
        self.endpoints = eps

    def close(self):
        for ep in self.endpoints:
            ep.close()
        self.release_pending()


class InprocTransport(ShardTransport):
    name = "inproc"
    is_remote = False

    def __init__(self, spec: EmbShardSpec, seeds, shard_dirs,
                 async_save: bool = True, max_inflight: int = 2,
                 fsync_payloads: bool = True, epoch: int = 0):
        super().__init__(epoch=epoch)
        self.async_save = async_save
        self.max_inflight = max_inflight
        self.fsync_payloads = fsync_payloads
        self.endpoints = [
            self._spawn_endpoint(j, spec, seeds[j], shard_dirs[j])
            for j in range(spec.n_shards)]

    def _spawn_endpoint(self, shard, spec, seed, shard_dir, address=None):
        return InprocEndpoint(shard, spec, seed[0], seed[1],
                              trainer_image=seed[2], directory=shard_dir,
                              async_save=self.async_save,
                              max_inflight=self.max_inflight,
                              fsync_payloads=self.fsync_payloads)

    def _make_snapshot(self, seq, snap_t, snap_a):
        return InlineSnapshot(seq, snap_t, snap_a)


class PipeTransport(ShardTransport):
    name = "pipe"

    def __init__(self, spec: EmbShardSpec, seeds, shard_dirs,
                 snapshot: str = "shm", spool_dir: Optional[str] = None,
                 fsync_payloads: bool = True, epoch: int = 0):
        assert snapshot in ("shm", "spool"), snapshot
        super().__init__(epoch=epoch)
        self.snapshot = snapshot
        self.spool_dir = spool_dir
        self.fsync_payloads = fsync_payloads
        self._owned_spool: Optional[str] = None   # mkdtemp'd by us
        self.endpoints = [
            self._spawn_endpoint(j, spec, seeds[j], shard_dirs[j])
            for j in range(spec.n_shards)]

    def _spawn_endpoint(self, shard, spec, seed, shard_dir, address=None):
        return PipeEndpoint(shard, spec, seed[0], seed[1],
                            trainer_image=seed[2], directory=shard_dir,
                            fsync_payloads=self.fsync_payloads,
                            epoch=self.epoch)

    def _make_snapshot(self, seq, snap_t, snap_a):
        if self.snapshot == "shm":
            try:
                return ShmSnapshot(seq, snap_t, snap_a)
            except (OSError, ValueError):
                pass                    # no usable /dev/shm: spool instead
        if self.spool_dir is None:
            import tempfile
            self.spool_dir = self._owned_spool = \
                tempfile.mkdtemp(prefix="cpr-spool-")
        return SpoolSnapshot(seq, self.spool_dir, snap_t, snap_a)

    def close(self):
        super().close()
        if self._owned_spool is not None:
            import shutil
            shutil.rmtree(self._owned_spool, ignore_errors=True)
            self._owned_spool = None


class SocketTransport(ShardTransport):
    name = "socket"

    def __init__(self, spec: EmbShardSpec, seeds, shard_dirs,
                 addresses: Optional[Sequence[Tuple[str, int]]] = None,
                 fsync_payloads: bool = True,
                 connect_timeout: float = 20.0,
                 submit_timeout: float = SUBMIT_TIMEOUT_S,
                 heartbeat_timeout: float = HEARTBEAT_TIMEOUT_S,
                 epoch: int = 0,
                 attach_watermarks: Optional[Sequence[int]] = None,
                 attach_seed_ok: Optional[Sequence[bool]] = None,
                 attach_fallback_spawn: Optional[Sequence[bool]] = None,
                 attach_rebuild_plans: Optional[Sequence] = None,
                 codec_level: int = 0,
                 codec_floor: int = CODEC_FLOOR_BYTES,
                 mux: bool = False,
                 mux_group: int = 0,
                 shm_handoff: bool = True):
        super().__init__(epoch=epoch)
        if addresses is not None and len(addresses) != spec.n_shards:
            raise ValueError(
                f"socket transport needs one address per shard: got "
                f"{len(addresses)} for n_shards={spec.n_shards}")
        self.fsync_payloads = fsync_payloads
        self.connect_timeout = connect_timeout
        self.submit_timeout = submit_timeout
        self.heartbeat_timeout = heartbeat_timeout
        self.codec_level = int(codec_level)
        self.codec_floor = int(codec_floor)
        self.shm_handoff = bool(shm_handoff)
        self._shm_probe: Optional[ShmProbe] = None
        if self.shm_handoff:
            try:
                self._shm_probe = ShmProbe()
            except (OSError, ValueError):
                self._shm_probe = None  # no usable /dev/shm: stream slices
        self._ranges = self._ranges_for(spec)
        self._mux_conns: List[MuxConnection] = []
        self._owned_group_servers: List = []
        # multiplexing: group shards onto shared connections.  Attach
        # (coordinator failover) always adopts per-shard — the parked
        # sessions are connection-agnostic, and per-shard handshakes keep
        # the takeover path identical across topologies.
        mux_for: Dict[int, MuxConnection] = {}
        groups = (self._mux_groups(spec.n_shards, addresses, mux, mux_group)
                  if attach_watermarks is None else [])
        # the servers this fleet owns (one a mux group, one a shard
        # outside the groups), started together
        grouped = {j for group in groups for j in group}
        names = ([] if addresses else
                 [f"cpr-shard-server-g{group[0]}" for group in groups] +
                 [f"cpr-shard-server-{j}" for j in range(spec.n_shards)
                  if j not in grouped and attach_watermarks is None])
        owned = iter(spawn_loopback_servers(connect_timeout, names))
        if attach_watermarks is None:
            for group in groups:
                addr = addresses[group[0]] if addresses else None
                proc = None
                if addr is None:
                    addr, proc = next(owned)
                    self._owned_group_servers.append(proc)
                conn = MuxConnection(
                    addr, epoch=epoch, connect_timeout=connect_timeout,
                    codec_level=self.codec_level,
                    codec_floor=self.codec_floor,
                    shm_probe=(self._shm_probe
                               if is_loopback_address(addr) else None),
                    server_proc=proc)
                self._mux_conns.append(conn)
                for j in group:
                    mux_for[j] = conn
        self.endpoints = [
            SocketEndpoint(j, spec, seeds[j][0], seeds[j][1],
                           trainer_image=seeds[j][2],
                           directory=shard_dirs[j],
                           address=(addresses[j] if addresses else None),
                           fsync_payloads=fsync_payloads,
                           connect_timeout=connect_timeout,
                           submit_timeout=submit_timeout,
                           heartbeat_timeout=heartbeat_timeout,
                           epoch=epoch,
                           attach_watermark=(attach_watermarks[j]
                                             if attach_watermarks is not None
                                             else None),
                           attach_seed_ok=(attach_seed_ok[j]
                                           if attach_seed_ok is not None
                                           else True),
                           attach_fallback_spawn=(
                               attach_fallback_spawn[j]
                               if attach_fallback_spawn is not None
                               else False),
                           attach_rebuild_plan=(
                               attach_rebuild_plans[j]
                               if attach_rebuild_plans is not None
                               else None),
                           codec_level=self.codec_level,
                           codec_floor=self.codec_floor,
                           shm_probe=self._shm_probe,
                           mux_conn=mux_for.get(j),
                           server=(next(owned) if not addresses
                                   and j not in grouped
                                   and attach_watermarks is None else None))
            for j in range(spec.n_shards)]

    @staticmethod
    def _mux_groups(n_shards: int, addresses, mux: bool,
                    mux_group: int) -> List[List[int]]:
        """Shard groups sharing one connection.  Explicit addresses:
        consecutive runs of the same (host, port) — the ``host:port*k``
        expansion from train.py.  Auto-spawn: chunks of ``mux_group``
        shards per loopback server.  Singleton groups keep the plain
        per-shard path."""
        groups: List[List[int]] = []
        if addresses is not None:
            if not mux:
                return []
            run: List[int] = [0]
            for j in range(1, n_shards):
                if tuple(addresses[j]) == tuple(addresses[run[-1]]):
                    run.append(j)
                else:
                    groups.append(run)
                    run = [j]
            groups.append(run)
        elif mux_group and mux_group > 1:
            groups = [list(range(lo, min(lo + mux_group, n_shards)))
                      for lo in range(0, n_shards, mux_group)]
        return [g for g in groups if len(g) > 1]

    @staticmethod
    def _ranges_for(spec: EmbShardSpec):
        return [[spec.shard_range(t, j)
                 for t in range(len(spec.table_sizes))]
                for j in range(spec.n_shards)]

    def _spawn_endpoint(self, shard, spec, seed, shard_dir, address=None):
        return SocketEndpoint(shard, spec, seed[0], seed[1],
                              trainer_image=seed[2], directory=shard_dir,
                              address=address,
                              fsync_payloads=self.fsync_payloads,
                              connect_timeout=self.connect_timeout,
                              submit_timeout=self.submit_timeout,
                              heartbeat_timeout=self.heartbeat_timeout,
                              epoch=self.epoch,
                              codec_level=self.codec_level,
                              codec_floor=self.codec_floor,
                              shm_probe=self._shm_probe)

    def resize_fleet(self, spec, seeds, shard_dirs, addresses=None):
        # the per-shard slice ranges feed every later SliceSnapshot: swap
        # them before any endpoint exists under the new layout
        self._ranges = self._ranges_for(spec)
        super().resize_fleet(spec, seeds, shard_dirs, addresses=addresses)

    @property
    def addresses(self):
        return [list(ep.effective_address) if ep.effective_address else None
                for ep in self.endpoints]

    def _make_snapshot(self, seq, snap_t, snap_a):
        shm_shards = [j for j, ep in enumerate(self.endpoints)
                      if getattr(ep, "shm_ok", False) and ep.error is None]
        if shm_shards:
            try:
                return ShmHandoffSnapshot(seq, snap_t, snap_a,
                                          self._ranges, shm_shards)
            except (OSError, ValueError):
                pass                    # no usable /dev/shm: stream slices
        return SliceSnapshot(seq, snap_t, snap_a, self._ranges)

    def wire_stats(self) -> Dict[str, int]:
        """Raw-vs-wire byte totals summed over the fleet's live channels
        (mux members share one channel — counted once)."""
        chans: Dict[int, SockChannel] = {}
        for ep in self.endpoints:
            ch = getattr(ep, "_chan", None)
            if isinstance(ch, _MuxChan):
                ch = ch._conn._chan
            if isinstance(ch, SockChannel):
                chans[id(ch)] = ch
        for conn in self._mux_conns:
            chans[id(conn._chan)] = conn._chan
        out = {"raw_sent": 0, "wire_sent": 0, "raw_rcvd": 0, "wire_rcvd": 0}
        for ch in chans.values():
            for k, v in ch.wire_stats().items():
                out[k] += v
        return out

    def close(self):
        super().close()
        for proc in self._owned_group_servers:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=5.0)
        self._owned_group_servers = []
        if self._shm_probe is not None:
            self._shm_probe.close()
            self._shm_probe = None


def make_transport(name: str, spec: EmbShardSpec, seeds, shard_dirs,
                   **opts) -> ShardTransport:
    """Build the named transport.  ``seeds[j]`` is ``(table_slices,
    acc_slices, trainer_image_or_None)`` for shard ``j``; ``opts`` are the
    transport-specific knobs (async_save/max_inflight for inproc,
    snapshot/spool_dir for pipe, addresses/timeouts for socket)."""
    name = normalize_transport(name)
    common = {k: opts[k] for k in ("fsync_payloads", "epoch") if k in opts}
    if name == "inproc":
        kw = {k: opts[k] for k in ("async_save", "max_inflight")
              if k in opts}
        return InprocTransport(spec, seeds, shard_dirs, **kw, **common)
    if name == "pipe":
        kw = {k: opts[k] for k in ("snapshot", "spool_dir") if k in opts}
        return PipeTransport(spec, seeds, shard_dirs, **kw, **common)
    kw = {k: opts[k] for k in ("addresses", "connect_timeout",
                               "submit_timeout", "heartbeat_timeout",
                               "attach_watermarks", "attach_seed_ok",
                               "attach_fallback_spawn",
                               "attach_rebuild_plans",
                               "codec_level", "codec_floor",
                               "mux", "mux_group", "shm_handoff")
          if k in opts}
    return SocketTransport(spec, seeds, shard_dirs, **kw, **common)
