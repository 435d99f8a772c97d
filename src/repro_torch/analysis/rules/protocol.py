"""protocol-conformance + wire-doc-drift: both protocol sides vs the spec.

The wire protocol's single source of truth is
``repro_torch.analysis.protocol.spec``.  These rules keep the implementation
and the docs from drifting away from it:

* **protocol-conformance** — extracts every frame construction site
  (tuple literals reaching ``send``-family calls, plus every
  spec-kind tuple literal inside the two protocol files) and every
  dispatch site (comparisons against ``msg[0]`` / ``kind``,
  ``_recv_until("kind", ...)`` waits) on both sides — client
  ``*Endpoint`` / ``*Connection`` classes and ``client_hello``, server
  ``WriterSession`` / ``shard_server`` demux loop — and verifies each
  against the spec: the kind exists, the arity is inside the spec
  range, the direction matches the side constructing it, and
  coordinator->worker frames thread the epoch through the spec's
  declared slot.  Cross-file, it checks *completeness*: every
  coordinator->worker kind must be constructed client-side and
  dispatched server-side, every worker->coordinator kind constructed
  server-side and dispatched client-side (envelopes on both).  This
  supersedes the epoch-threading rule's frame-drift half: adding,
  renaming, or resizing a frame on one side only fails analysis.
* **wire-doc-drift** — the wire table in ``docs/recovery.md`` between
  the ``<!-- wire-spec:begin/end -->`` markers must be exactly
  ``render_wire_table()``; regenerate with
  ``python -m repro_torch.analysis.protocol --write-table``.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import (Checker, Finding, Source, names_in,
                                       register)
from repro_torch.analysis.protocol import spec as wire

SEND_FUNCS = {"_send", "_send_raw", "send", "send_for", "put",
              "put_nowait"}

# the two files that ARE the protocol implementation
_PROTOCOL_FILES = ("core/transport.py", "launch/shard_server.py")
_SERVER_FILE = "launch/shard_server.py"

CLIENT = "client"
SERVER = "server"


def _is_protocol_file(relpath: str) -> bool:
    return any(relpath.endswith(p) for p in _PROTOCOL_FILES)


def _head_kind(tup: ast.Tuple) -> Optional[str]:
    if tup.elts and isinstance(tup.elts[0], ast.Constant) \
            and isinstance(tup.elts[0].value, str):
        return tup.elts[0].value
    return None


def _side_of(src: Source, node: ast.AST) -> Optional[str]:
    """Which protocol side a construction/dispatch site belongs to —
    None when the site is neither (helpers, payload plumbing)."""
    cls = src.enclosing(node, ast.ClassDef)
    if cls is not None:
        if "Session" in cls.name:
            return SERVER
        if cls.name.endswith(("Endpoint", "Connection")) \
                or cls.name == "_MuxChan":
            return CLIENT
        if src.relpath.endswith(_SERVER_FILE):
            return SERVER
        return None
    if src.relpath.endswith(_SERVER_FILE):
        return SERVER
    fn = src.enclosing(node, (ast.FunctionDef, ast.AsyncFunctionDef))
    if fn is not None and fn.name == "client_hello":
        return CLIENT
    return None


def _specs_for_side(kind: str, side: Optional[str]):
    if side == CLIENT:
        return wire.frames_for(kind, wire.C2W)
    if side == SERVER:
        return wire.frames_for(kind, wire.W2C)
    return wire.frames_for(kind)


@register
class ProtocolConformanceChecker(Checker):
    name = "protocol-conformance"
    description = ("every frame construction and dispatch site on both "
                   "protocol sides conforms to the wire spec (kind, "
                   "arity, epoch slot, direction, completeness)")

    def __init__(self):
        # side -> kind -> [(relpath, line)]
        self.constructed: Dict[str, Dict[str, List[Tuple[str, int]]]] = {
            CLIENT: {}, SERVER: {}}
        self.dispatched: Dict[str, Dict[str, List[Tuple[str, int]]]] = {
            CLIENT: {}, SERVER: {}}
        self._spec_relpath: Optional[str] = None
        self._protocol_files_seen: Set[str] = set()

    # ------------------------------------------------------------ check
    def check(self, src: Source) -> Iterator[Finding]:
        if src.relpath.endswith("analysis/protocol/spec.py"):
            self._spec_relpath = src.relpath
        for p in _PROTOCOL_FILES:
            if src.relpath.endswith(p):
                self._protocol_files_seen.add(p)
        in_proto = _is_protocol_file(src.relpath)
        seen_tuples = set()
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                yield from self._check_send(src, node, seen_tuples)
                self._collect_recv_until(src, node)
            elif isinstance(node, ast.Compare):
                yield from self._check_dispatch(src, node, in_proto)
        if in_proto:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Tuple) \
                        and id(node) not in seen_tuples \
                        and not isinstance(getattr(node, "parent", None),
                                           ast.Compare):
                    yield from self._check_tuple(src, node,
                                                 check_epoch=False)

    # -- constructions --------------------------------------------------
    def _check_send(self, src, call: ast.Call, seen_tuples):
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in SEND_FUNCS and call.args):
            return
        tup = next((a for a in call.args if isinstance(a, ast.Tuple)),
                   None)
        if tup is None:
            return
        seen_tuples.add(id(tup))
        cls = src.enclosing(call, ast.ClassDef)
        endpoint_cls = cls is not None and cls.name.endswith("Endpoint")
        if not (endpoint_cls or _is_protocol_file(src.relpath)):
            return                      # tests/fuzzers send junk on purpose
        kind = _head_kind(tup)
        if kind is None:
            return
        if kind not in wire.KINDS:
            yield Finding(
                rule=self.name, path=src.relpath, line=call.lineno,
                message=(f"frame kind {kind!r} is not in the wire spec "
                         f"(repro_torch.analysis.protocol.spec): declare it "
                         f"there first, then both sides"))
            return
        yield from self._check_tuple(src, tup, check_epoch=True,
                                     line=call.lineno)

    def _check_tuple(self, src, tup: ast.Tuple, check_epoch: bool,
                     line: Optional[int] = None):
        kind = _head_kind(tup)
        if kind is None or kind not in wire.KINDS:
            return
        if any(isinstance(e, ast.Starred) for e in tup.elts):
            return                      # arity unknowable statically
        line = line or tup.lineno
        side = _side_of(src, tup)
        specs = _specs_for_side(kind, side)
        if not specs:
            # the kind exists but not for this side's direction
            legal = ", ".join(s.direction for s in wire.frames_for(kind))
            yield Finding(
                rule=self.name, path=src.relpath, line=line,
                message=(f"frame {kind!r} constructed on the {side} side "
                         f"but the spec declares it {legal}-only"))
            return
        n = len(tup.elts)
        if not any(s.min_arity <= n <= s.max_arity for s in specs):
            want = "/".join(
                (str(s.min_arity) if s.min_arity == s.max_arity
                 else f"{s.min_arity}..{s.max_arity}") for s in specs)
            yield Finding(
                rule=self.name, path=src.relpath, line=line,
                message=(f"frame {kind!r} constructed with arity {n}, "
                         f"spec says {want}"))
            return
        if side is not None:
            self.constructed[side].setdefault(kind, []).append(
                (src.relpath, line))
        if not (check_epoch and side == CLIENT):
            return
        for s in specs:
            if s.epoch_slot is None or s.direction != wire.C2W:
                continue
            if n <= s.epoch_slot or not any(
                    "epoch" in nm for nm in names_in(tup.elts[s.epoch_slot])):
                yield Finding(
                    rule=self.name, path=src.relpath, line=line,
                    message=(f"frame {kind!r} does not thread the "
                             f"coordinator epoch through spec slot "
                             f"{s.epoch_slot} ({s.fields[s.epoch_slot]}): "
                             f"the stale-coordinator fence cannot see it"))

    # -- dispatch sites -------------------------------------------------
    def _check_dispatch(self, src, cmp: ast.Compare, in_proto: bool):
        left = cmp.comparators and cmp.left
        is_kind_expr = (
            (isinstance(left, ast.Name) and left.id in ("kind", "want"))
            or (isinstance(left, ast.Subscript)
                and isinstance(left.slice, ast.Constant)
                and left.slice.value == 0))
        if not is_kind_expr or len(cmp.ops) != 1:
            return
        if not isinstance(cmp.ops[0],
                          (ast.Eq, ast.NotEq, ast.In, ast.NotIn)):
            return
        rhs = cmp.comparators[0]
        kinds: List[str] = []
        if isinstance(rhs, ast.Constant) and isinstance(rhs.value, str):
            kinds = [rhs.value]
        elif isinstance(rhs, (ast.Tuple, ast.List, ast.Set)):
            kinds = [e.value for e in rhs.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str)]
        if not kinds:
            return
        cls = src.enclosing(cmp, ast.ClassDef)
        protocol_cls = cls is not None and (
            "Session" in cls.name
            or cls.name.endswith(("Endpoint", "Connection")))
        # Name-form comparisons outside protocol classes dispatch on
        # payload/manifest kinds, not wire frames — leave them alone.
        if isinstance(left, ast.Name) and not protocol_cls:
            return
        if not (protocol_cls or in_proto):
            return
        side = _side_of(src, cmp)
        for kind in kinds:
            if kind not in wire.KINDS:
                yield Finding(
                    rule=self.name, path=src.relpath, line=cmp.lineno,
                    message=(f"dispatch references frame kind {kind!r} "
                             f"that is not in the wire spec: dead "
                             f"protocol arm or an undeclared frame"))
            elif side is not None and in_proto:
                self.dispatched[side].setdefault(kind, []).append(
                    (src.relpath, cmp.lineno))

    def _collect_recv_until(self, src, call: ast.Call):
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "_recv_until" and call.args
                and isinstance(call.args[0], ast.Constant)
                and isinstance(call.args[0].value, str)):
            return
        if not _is_protocol_file(src.relpath):
            return
        kind = call.args[0].value
        side = _side_of(src, call) or CLIENT   # replies are client waits
        if kind in wire.KINDS:
            self.dispatched[side].setdefault(kind, []).append(
                (src.relpath, call.lineno))

    # -- cross-file completeness ---------------------------------------
    def finalize(self, sources: Sequence[Source]) -> Iterator[Finding]:
        if set(self._protocol_files_seen) != set(_PROTOCOL_FILES):
            return          # partial scan (corpus/unit fixtures): skip
        anchor = self._spec_relpath or _PROTOCOL_FILES[0]
        for key, f in sorted(wire.FRAMES.items()):
            kind, direction = key
            if direction in (wire.C2W, wire.BOTH):
                yield from self._require(
                    anchor, kind, self.constructed[CLIENT],
                    "constructed on the client (*Endpoint) side")
                yield from self._require(
                    anchor, kind, self.dispatched[SERVER],
                    "dispatched on the server "
                    "(WriterSession/shard_server) side")
            if direction in (wire.W2C, wire.BOTH):
                yield from self._require(
                    anchor, kind, self.constructed[SERVER],
                    "constructed on the server side")
                yield from self._require(
                    anchor, kind, self.dispatched[CLIENT],
                    "dispatched on the client (reply) side")

    def _require(self, anchor, kind, table, what):
        if kind not in table:
            yield Finding(
                rule=self.name, path=anchor, line=1,
                message=(f"spec frame {kind!r} is never {what}: "
                         f"protocol drift between the spec and the "
                         f"implementation"))


@register
class WireDocDriftChecker(Checker):
    name = "wire-doc-drift"
    description = ("the wire table in docs/recovery.md matches the "
                   "machine-readable spec verbatim")

    def finalize(self, sources: Sequence[Source]) -> Iterator[Finding]:
        spec_src = next(
            (s for s in sources
             if s.relpath.endswith("analysis/protocol/spec.py")), None)
        if spec_src is None:
            return                      # spec not in this scan: no opinion
        # <repo>/src/repro_torch/analysis/protocol/spec.py -> <repo>/docs/...
        repo = spec_src.abspath
        for _ in range(5):
            repo = os.path.dirname(repo)
        doc = os.path.join(repo, "docs", "recovery.md")
        regen = ("regenerate with `python -m repro_torch.analysis.protocol "
                 "--write-table`")
        if not os.path.exists(doc):
            yield Finding(
                rule=self.name, path=spec_src.relpath, line=1,
                message=f"docs/recovery.md not found at {doc}; {regen}")
            return
        with open(doc, encoding="utf-8") as f:
            text = f.read()
        begin, end = wire.WIRE_TABLE_BEGIN, wire.WIRE_TABLE_END
        if begin not in text or end not in text:
            yield Finding(
                rule=self.name, path=spec_src.relpath, line=1,
                message=(f"docs/recovery.md is missing the "
                         f"{begin} / {end} markers; {regen}"))
            return
        embedded = text.split(begin, 1)[1].split(end, 1)[0].strip("\n")
        want = wire.render_wire_table().strip("\n")
        if embedded != want:
            got_l, want_l = embedded.splitlines(), want.splitlines()
            diff = next(
                (i for i, (a, b) in enumerate(zip(got_l, want_l))
                 if a != b), min(len(got_l), len(want_l)))
            yield Finding(
                rule=self.name, path=spec_src.relpath, line=1,
                message=(f"docs/recovery.md wire table disagrees with "
                         f"the spec (first divergence at embedded table "
                         f"line {diff + 1}); {regen}"))
