"""epoch-threading rule: every frame carries the coordinator epoch.

The coordinator-epoch fence (docs/recovery.md) only works if *every*
coordinator→worker frame carries the coordinator epoch where the worker
expects it: command frames at index 1 (``WriterSession._handle`` reads
``msg[1]``), ``spawn`` in its keyword slot.  A frame constructed without
the epoch is invisible to the stale-coordinator guard — a superseded
coordinator could keep writing through it after a takeover.

One check, over tuple-literal frames constructed inside classes whose
name ends with ``Endpoint`` (the coordinator-side senders): every
command frame's index-1 element (``spawn``: any element) must reference
an ``epoch`` attribute/name.

The former *protocol drift* half of this rule (frame kinds constructed
vs handled) is superseded by ``protocol-conformance``
(``rules/protocol.py``), which checks kinds, arities, epoch slots, and
cross-side completeness against the machine-readable wire spec.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Sequence, Tuple

from repro_torch.analysis.core import (Checker, Finding, Source, names_in,
                                       register)

SEND_FUNCS = {"_send", "_send_raw", "send", "put", "put_nowait"}


def _kind_of(tup: ast.Tuple):
    if tup.elts and isinstance(tup.elts[0], ast.Constant) \
            and isinstance(tup.elts[0].value, str):
        return tup.elts[0].value
    return None


def _mentions_epoch(node: ast.AST) -> bool:
    return any("epoch" in n for n in names_in(node))


@register
class EpochThreadingChecker(Checker):
    name = "epoch-threading"
    description = ("coordinator frames carry the epoch at index 1 "
                   "(frame-kind drift lives in protocol-conformance)")

    def __init__(self):
        # kind -> [(relpath, lineno, epoch_ok)]
        self.sent: Dict[str, List[Tuple[str, int, bool]]] = {}

    def check(self, src: Source) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Call):
                self._collect_send(src, node)
        return iter(())

    # -- frame constructors (coordinator side) --------------------------
    def _collect_send(self, src: Source, call: ast.Call):
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr in SEND_FUNCS and call.args
                and isinstance(call.args[0], ast.Tuple)):
            return
        cls = src.enclosing(call, ast.ClassDef)
        if cls is None or not cls.name.endswith("Endpoint"):
            return
        tup = call.args[0]
        kind = _kind_of(tup)
        if kind is None:
            return
        if kind == "spawn":
            epoch_ok = any(_mentions_epoch(e) for e in tup.elts)
        else:
            epoch_ok = len(tup.elts) >= 2 and _mentions_epoch(tup.elts[1])
        self.sent.setdefault(kind, []).append(
            (src.relpath, call.lineno, epoch_ok))

    # -- reporting ------------------------------------------------------
    def finalize(self, sources: Sequence[Source]) -> Iterator[Finding]:
        for kind, sites in sorted(self.sent.items()):
            for relpath, lineno, epoch_ok in sites:
                if not epoch_ok:
                    yield Finding(
                        rule=self.name, path=relpath, line=lineno,
                        message=(f"frame {kind!r} constructed without the "
                                 f"coordinator epoch at index 1: the "
                                 f"stale-coordinator guard cannot fence "
                                 f"this command"))
