"""Machine-readable wire spec for the writer-fleet protocol.

One declaration per frame kind: name, direction, arity range, field
names and coarse field types, which slot carries the coordinator epoch,
and the connection states in which the frame is legal.  The connection
state machine (socket transport; pipe/inproc skip the handshake states):

    start ──("hello")──> negotiated ──("mx" envelopes)──> (muxed)
      │                     │
      └──────┬──────────────┘
             ├─("spawn")────────────────────> serving
             └─("attach")──> attaching ──("reconcile"/"rebuild")─> serving
                                  │
                                  └─("no-writer" -> "spawn")─────> serving
    serving ──("close" / EOF / protocol violation)──> closed

In ``serving`` the per-shard command set is live: full/rows/trainer
saves, parity stripes, drain fences, image/export/reshard, ping, close.

The port's own copy of ``repro.analysis.protocol.spec``: the port imports
nothing of the JAX package, yet its writers speak the same wire protocol,
so a port coordinator and a reference shard server interoperate in both
directions.  Every consumer of the port's protocol derives from this
module:

* ``repro_torch.analysis.rules.protocol`` — AST conformance of the port's
  frame construction and dispatch sites, and the ``wire-doc-drift`` rule
  (the table between the ``<!-- wire-spec:begin -->`` markers of
  ``docs/recovery.md`` is ``render_wire_table()`` verbatim);
* ``repro_torch.core.transport`` / ``repro_torch.launch.shard_server`` —
  runtime: ``MAX_FRAME_BYTES`` and ``violation``;
* ``repro_torch.analysis.protocol.model`` / ``.fuzz`` — the model
  checker's alphabet and the fuzzer's grammar.

``tests/test_torch_row_hash.py`` holds this copy equal to the reference
frame for frame.  Stdlib only.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Hard ceiling on a single wire frame (length prefix, compressed or
# raw, and post-inflate size).  A hostile 8-byte prefix can claim up to
# 2**63-1 bytes; without this cap the receiver would try to buffer (or
# zlib-inflate) the claim before noticing the stream is garbage.  Large
# enough for any real frame (a full-fleet snapshot shard is << 1 GiB),
# small enough that an allocation bomb dies as a clean ProtocolError.
MAX_FRAME_BYTES = 1 << 31

# Connection states (socket transport; the pipe/inproc transports are
# born in "serving").
STATES = (
    "start",        # raw connection, nothing sent
    "negotiated",   # hello/hello-ok done (codec/mux/shm agreed)
    "attaching",    # attach sent, takeover handshake in flight
    "serving",      # per-shard session live (spawned or reconciled)
    "closed",       # close frame, EOF, or poisoned channel
)

C2W = "c2w"   # coordinator -> worker
W2C = "w2c"   # worker -> coordinator
BOTH = "both"  # connection-level envelope, rides both directions

# Coarse field types for runtime validation.  "any" is unchecked;
# "int"/"str" are enforced by validate_frame (cheap and unambiguous —
# payload buffers, trees, and array lists stay "any").
_T = {"int", "str", "any"}


@dataclass(frozen=True)
class FrameSpec:
    """One wire-frame kind.  ``fields``/``types`` cover ``max_arity``
    slots including slot 0 (the kind tag itself); frames between
    ``min_arity`` and ``max_arity`` simply omit the tail."""

    kind: str
    direction: str                    # C2W | W2C | BOTH
    min_arity: int
    max_arity: int
    fields: Tuple[str, ...]
    types: Tuple[str, ...]
    states: Tuple[str, ...]           # states in which the frame is legal
    epoch_slot: Optional[int] = None  # slot carrying the coordinator epoch
    section: str = "session"          # wire-table grouping
    doc: str = ""

    def __post_init__(self):
        assert self.direction in (C2W, W2C, BOTH), self.kind
        assert 1 <= self.min_arity <= self.max_arity, self.kind
        assert len(self.fields) == self.max_arity, self.kind
        assert len(self.types) == self.max_arity, self.kind
        assert all(t in _T for t in self.types), self.kind
        assert all(s in STATES for s in self.states), self.kind
        if self.epoch_slot is not None:
            assert 0 < self.epoch_slot < self.max_arity, self.kind


def _f(kind, direction, fields, types, states, *, min_arity=None,
       epoch_slot=None, section="session", doc=""):
    fields = tuple(fields)
    return FrameSpec(
        kind=kind, direction=direction,
        min_arity=len(fields) if min_arity is None else min_arity,
        max_arity=len(fields), fields=fields, types=tuple(types),
        states=tuple(states), epoch_slot=epoch_slot, section=section,
        doc=doc)


_SERVING = ("serving",)
_PRE = ("start", "negotiated")

# The spec proper.  Keyed by (kind, direction) because one kind —
# "image" — is both the c2w request and the w2c reply with different
# shapes.  Order here is the wire-table order.
_DECLS = [
    # -- connection negotiation + envelopes ---------------------------
    _f("hello", C2W, ("kind", "epoch", "opts"), ("str", "int", "any"),
       ("start",), epoch_slot=1, section="envelope",
       doc="negotiate codec/mux/shm before any per-shard traffic"),
    _f("hello-ok", W2C, ("kind", "opts"), ("str", "any"),
       ("start",), section="envelope",
       doc="server's accepted options (e.g. shm probe verdict)"),
    _f("mx", BOTH, ("kind", "shard", "inner"), ("str", "int", "any"),
       ("negotiated", "attaching", "serving"), section="envelope",
       doc="mux envelope: every frame of a multiplexed connection"),
    # -- session establishment ----------------------------------------
    _f("spawn", C2W,
       ("kind", "shard", "table_sizes", "n_shards", "directory",
        "seed_t", "seed_a", "seed_tr", "fsync", "epoch", "boundaries"),
       ("str", "int", "any", "int", "any", "any", "any", "any", "any",
        "int", "any"),     # directory is None until the first save
       _PRE + ("attaching",), min_arity=9, epoch_slot=9,
       section="handshake",
       doc="create the shard session (socket only; epoch+boundaries "
           "tails are optional for legacy senders)"),
    _f("attach", C2W, ("kind", "epoch", "shard"), ("str", "int", "int"),
       _PRE, epoch_slot=1, section="handshake",
       doc="takeover: adopt a still-running writer session"),
    _f("attach-ok", W2C, ("kind", "watermark", "err"),
       ("str", "any", "any"), ("attaching",), section="handshake"),
    _f("no-writer", W2C, ("kind",), ("str",), ("attaching",),
       section="handshake",
       doc="no parked session: coordinator falls back to spawn"),
    _f("reconcile", C2W,
       ("kind", "epoch", "directory", "watermark", "seed_t", "seed_a",
        "seed_tr"),
       ("str", "int", "str", "any", "any", "any", "any"),
       ("attaching",), epoch_slot=1, section="handshake",
       doc="adopt the session at the stamped watermark (seeds only if "
           "the image must be rebuilt)"),
    _f("reconciled", W2C, ("kind", "watermark"), ("str", "any"),
       ("attaching",), section="handshake"),
    _f("rebuild", C2W,
       ("kind", "epoch", "directory", "watermark", "seed_t", "seed_a",
        "seed_tr", "plan"),
       ("str", "int", "str", "any", "any", "any", "any", "any"),
       ("attaching", "serving"), epoch_slot=1, section="handshake",
       doc="writer-local replay of a shard chain the coordinator "
           "cannot read"),
    _f("rebuilt", W2C, ("kind", "watermark"), ("str", "any"),
       ("attaching", "serving"), section="handshake"),
    # -- save traffic --------------------------------------------------
    _f("full", C2W, ("kind", "epoch", "seq", "step", "payload"),
       ("str", "int", "int", "int", "any"), _SERVING, epoch_slot=1,
       section="save", doc="full-image save event"),
    _f("rows", C2W,
       ("kind", "epoch", "seq", "step", "table", "rows", "values",
        "accs"),
       ("str", "int", "int", "int", "int", "any", "any", "any"),
       _SERVING, epoch_slot=1, section="save",
       doc="partial (delta) save of one table's row slice"),
    _f("trainer", C2W, ("kind", "epoch", "seq", "step", "tree"),
       ("str", "int", "int", "int", "any"), _SERVING, epoch_slot=1,
       section="save", doc="trainer-state replica (shard 0)"),
    _f("ack", W2C, ("kind", "seq", "event"), ("str", "int", "any"),
       _SERVING, section="save",
       doc="event durable on the writer's disk"),
    _f("error", W2C, ("kind", "seq", "err"), ("str", "int", "any"),
       _SERVING, section="save",
       doc="apply failed; shard poisoned (seq -1: protocol violation)"),
    # -- fence / liveness / image -------------------------------------
    _f("drain", C2W, ("kind", "epoch", "token"), ("str", "int", "any"),
       _SERVING, epoch_slot=1, section="fence",
       doc="DRAIN barrier: reply once everything queued is durable"),
    _f("drained", W2C, ("kind", "token", "watermark", "err"),
       ("str", "any", "any", "any"), _SERVING, section="fence"),
    _f("image", C2W, ("kind", "epoch"), ("str", "int"), _SERVING,
       epoch_slot=1, section="fence",
       doc="request the writer's current in-memory image"),
    _f("image", W2C, ("kind", "tables", "accs", "trainer"),
       ("str", "any", "any", "any"), _SERVING, section="fence"),
    _f("ping", C2W, ("kind", "epoch", "token"), ("str", "int", "any"),
       _SERVING, epoch_slot=1, section="fence",
       doc="heartbeat liveness probe"),
    _f("pong", W2C, ("kind", "token"), ("str", "any"), _SERVING,
       section="fence"),
    _f("stale", W2C, ("kind", "cmd_kind", "cmd_epoch", "epoch"),
       ("str", "str", "any", "int"), ("attaching", "serving"),
       epoch_slot=3, section="fence",
       doc="epoch fence: command older than the session's epoch "
           "(or a superseded generation) — never executed"),
    _f("close", C2W, ("kind", "epoch"), ("str", "int"), _SERVING,
       epoch_slot=1, section="fence",
       doc="park the session (socket) / stop the worker (pipe)"),
    # -- parity stripes (soft state) ----------------------------------
    _f("parity", C2W,
       ("kind", "epoch", "seq", "step", "op", "group", "a6", "a7",
        "a8", "a9"),
       ("str", "int", "int", "int", "str", "int", "any", "any", "any",
        "any"),
       _SERVING, min_arity=8, epoch_slot=1, section="parity",
       doc='op "full": (tables, accs) stripe seed, arity 8; '
           'op "delta": (table, stripe_rows, xvals, xaccs), arity 10'),
    _f("parity-ok", W2C, ("kind", "seq", "nbytes"),
       ("str", "int", "any"), _SERVING, section="parity"),
    _f("parity-get", C2W, ("kind", "epoch", "group"),
       ("str", "int", "int"), _SERVING, epoch_slot=1, section="parity",
       doc="fetch the running stripe for reconstruction"),
    _f("parity-out", W2C, ("kind", "group", "tables", "accs"),
       ("str", "int", "any", "any"), _SERVING, section="parity"),
    # -- elastic resharding -------------------------------------------
    _f("export", C2W, ("kind", "epoch", "ranges"),
       ("str", "int", "any"), _SERVING, epoch_slot=1,
       section="elastic",
       doc="stream out row ranges leaving this shard"),
    _f("rows-out", W2C, ("kind", "shard", "tables", "accs"),
       ("str", "int", "any", "any"), _SERVING, section="elastic"),
    _f("reshard", C2W,
       ("kind", "epoch", "table_sizes", "n_shards", "boundaries",
        "directory", "seed_t", "seed_a", "seed_tr"),
       ("str", "int", "any", "int", "any", "str", "any", "any", "any"),
       _SERVING, epoch_slot=1, section="elastic",
       doc="adopt a new shard layout in place"),
    _f("resharded", W2C, ("kind", "shard", "watermark"),
       ("str", "int", "any"), _SERVING, section="elastic"),
]

# (kind, direction) -> FrameSpec.  Kinds are unique per direction.
FRAMES = {}
for _d in _DECLS:
    _key = (_d.kind, _d.direction)
    assert _key not in FRAMES, _key
    FRAMES[_key] = _d
del _d, _key

KINDS = frozenset(k for k, _ in FRAMES)

_SECTIONS = (
    ("envelope", "Connection negotiation + envelopes (socket only)"),
    ("handshake", "Session establishment / coordinator failover"),
    ("save", "Save traffic"),
    ("fence", "Fence, liveness, image"),
    ("parity", "XOR parity stripes (soft state)"),
    ("elastic", "Elastic resharding"),
)


def frames_for(kind: str, direction: Optional[str] = None):
    """All FrameSpec entries for ``kind`` (one or, for "image", two);
    with ``direction``, only entries legal for that direction (BOTH
    matches either)."""
    out = [f for (k, _), f in sorted(FRAMES.items()) if k == kind]
    if direction is not None:
        out = [f for f in out
               if f.direction == direction or f.direction == BOTH]
    return out


def violation(msg: object, direction: str = C2W,
              state: Optional[str] = None) -> Optional[str]:
    """Why ``msg`` is not a well-formed frame for ``direction`` — or
    None if it conforms.  Structural checks only (tuple-ness, kind
    known, arity in range, int/str slots): cheap enough for the serve
    loop's hot path, strict enough that a conforming frame can never
    index-error a handler.  With ``state``, the frame must also be
    legal in that connection state (e.g. a 'hello' arriving on a
    session already in 'serving' is a violation)."""
    if not isinstance(msg, tuple):
        return f"frame is {type(msg).__name__}, not tuple"
    if not msg:
        return "empty frame"
    kind = msg[0]
    if not isinstance(kind, str):
        return f"frame kind is {type(kind).__name__}, not str"
    specs = frames_for(kind, direction)
    if not specs:
        if frames_for(kind):
            return f"frame kind {kind!r} is not legal in direction " \
                   f"{direction!r}"
        return f"unknown frame kind {kind!r}"
    if state is not None:
        specs = [f for f in specs if state in f.states]
        if not specs:
            return f"frame kind {kind!r} is not legal in connection " \
                   f"state {state!r}"
    why = None
    for spec in specs:
        why = _violation_against(msg, spec)
        if why is None:
            return None
    return why


def _violation_against(msg: tuple, spec: FrameSpec) -> Optional[str]:
    n = len(msg)
    if not spec.min_arity <= n <= spec.max_arity:
        want = (str(spec.min_arity) if spec.min_arity == spec.max_arity
                else f"{spec.min_arity}..{spec.max_arity}")
        return f"{spec.kind!r} frame has arity {n}, spec says {want}"
    for i in range(1, n):
        t, val = spec.types[i], msg[i]
        if t == "int" and not (isinstance(val, int)
                               and not isinstance(val, bool)):
            return f"{spec.kind!r} slot {i} ({spec.fields[i]}) is " \
                   f"{type(val).__name__}, spec says int"
        if t == "str" and not isinstance(val, str):
            return f"{spec.kind!r} slot {i} ({spec.fields[i]}) is " \
                   f"{type(val).__name__}, spec says str"
    if spec.kind == "parity":
        op = msg[4]
        want = {"full": 8, "delta": 10}.get(op)
        if want is None:
            return f"'parity' op {op!r} is neither 'full' nor 'delta'"
        if n != want:
            return f"'parity' op {op!r} has arity {n}, spec says {want}"
    return None


def validate_frame(msg: object, direction: str = C2W) -> bool:
    """True iff ``msg`` is a well-formed frame for ``direction``."""
    return violation(msg, direction) is None


# ---------------------------------------------------------------------
# Wire-table rendering: docs/recovery.md embeds this verbatim between
# "<!-- wire-spec:begin -->" / "<!-- wire-spec:end -->" markers; the
# wire-doc-drift rule fails analysis when they disagree.  Regenerate:
#   PYTHONPATH=src python -m repro_torch.analysis.protocol --write-table
# The table's text names the reference's spec and CLI: the document is
# the reference's, and both specs render it verbatim.

WIRE_TABLE_BEGIN = "<!-- wire-spec:begin -->"
WIRE_TABLE_END = "<!-- wire-spec:end -->"

_DIR_LABEL = {C2W: "coord -> worker", W2C: "worker -> coord",
              BOTH: "both"}


def _sig(spec: FrameSpec) -> str:
    parts = [repr(spec.kind)]
    parts += list(spec.fields[1:spec.min_arity])
    for name in spec.fields[spec.min_arity:]:
        parts.append(f"[{name}]")
    return "(" + ", ".join(parts) + ")"


def render_wire_table() -> str:
    """Deterministic markdown wire table, derived from FRAMES only."""
    lines = [
        "Generated from `repro.analysis.protocol.spec` — edit the spec,",
        "not this table (`python -m repro.analysis.protocol"
        " --write-table`).",
        "",
        "| frame | direction | arity | epoch slot | legal states |",
        "|-------|-----------|-------|------------|--------------|",
    ]
    for section, title in _SECTIONS:
        specs = [f for f in _DECLS if f.section == section]
        if not specs:
            continue
        lines.append(f"| **{title}** | | | | |")
        for spec in specs:
            arity = (str(spec.min_arity)
                     if spec.min_arity == spec.max_arity
                     else f"{spec.min_arity}..{spec.max_arity}")
            ep = "—" if spec.epoch_slot is None else str(spec.epoch_slot)
            states = ", ".join(spec.states)
            lines.append(
                f"| `{_sig(spec)}` | {_DIR_LABEL[spec.direction]} | "
                f"{arity} | {ep} | {states} |")
    lines.append("")
    lines.append(f"Max frame size (prefix, compressed, and inflated): "
                 f"`MAX_FRAME_BYTES = {MAX_FRAME_BYTES}` bytes; "
                 f"oversized or malformed frames raise `ProtocolError` "
                 f"and sever the channel.")
    return "\n".join(lines) + "\n"
