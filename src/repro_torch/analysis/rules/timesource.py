"""time-source rule: wall clock only for persisted records and lease math.

Internal deadlines, back-offs and duration measurements must use
``time.monotonic()`` — ``time.time()`` jumps under NTP step/slew and
would corrupt probe deadlines and fence timeouts (this generalizes the
PR 5 guard test that lived in ``tests/test_transport.py``).

``time.time()`` stays legal in exactly two places:

* values stored under a persisted ``"time"`` / ``"expires"`` key
  (manifest events, lease records) — human-readable provenance and
  cross-process lease expiry must survive restarts, so they must be
  wall-clock;
* lease arithmetic comparing against a persisted ``"expires"`` stamp.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import (Checker, Finding, Source,
                                       is_call_to, register,
                                       str_constants_in)

PERSIST_KEYS = {"time", "expires"}


@register
class TimeSourceChecker(Checker):
    name = "time-source"
    description = ("time.time() only in persisted records and lease math; "
                  "time.monotonic() for deadlines, back-offs, durations")

    def check(self, src: Source) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not is_call_to(node, "time", "time"):
                continue
            if self._allowed(src, node):
                continue
            yield Finding(
                rule=self.name, path=src.relpath, line=node.lineno,
                message=("time.time() outside a persisted record or lease "
                         "math: use time.monotonic() for deadlines and "
                         "durations"))

    def _allowed(self, src: Source, call: ast.Call) -> bool:
        # (a) dict value stored under a persisted key:
        #     {"time": time.time()} / {"expires": time.time() + ttl}
        prev: ast.AST = call
        for anc in src.ancestors(call):
            if isinstance(anc, ast.Dict):
                for key, value in zip(anc.keys, anc.values):
                    if value is prev and isinstance(key, ast.Constant) \
                            and key.value in PERSIST_KEYS:
                        return True
            if isinstance(anc, ast.stmt):
                break
            prev = anc

        stmt = src.enclosing_statement(call)
        # (b) subscript store under a persisted key:
        #     ev["time"] = time.time()
        if isinstance(stmt, ast.Assign):
            for target in stmt.targets:
                if isinstance(target, ast.Subscript):
                    sl = target.slice
                    if isinstance(sl, ast.Constant) \
                            and sl.value in PERSIST_KEYS:
                        return True
        # (c) lease math against a persisted expiry stamp:
        #     rec.get("expires", 0) > time.time()
        if any(c == "expires" for c in str_constants_in(stmt)):
            return True
        return False
