"""lock-discipline rule: annotated fields stay under their lock.

Clang-thread-safety-style lexical checking for the writer fleet's
concurrency conventions:

* A field assignment annotated ``# guarded by: <lock>`` declares that
  every access to ``self.<field>`` in that class (and its subclasses in
  the same file) must happen lexically inside ``with self.<lock>:``.
  Two escape hatches: ``__init__`` (no concurrent readers exist yet)
  and functions whose ``def`` line carries ``# holds: <lock>`` — the
  documented convention for helpers that run with the lock already held
  (e.g. ``WriterSession._handle`` runs under ``self.lock``).
* No blocking call — socket send/recv/accept/connect, ``os.fsync``,
  ``join``, ``sleep`` — lexically inside a ``with self._monitor_lock:``
  block (or a ``# holds: _monitor_lock`` function).  The monitor lock
  serializes probe sweeps against fence/close/resize; blocking under it
  stalls failure detection fleet-wide.

Limitations (by design — this is a lexical check): accesses through a
local alias (``s = self; s.field``), ``acquire()``/``release()`` call
pairs, and blocking work reached *indirectly* through another call are
not tracked.  Suppress genuine cross-thread racy reads explicitly with
``# lint: allow[lock-discipline] <why>`` so they are visibly deliberate.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterator, List, Optional, Set

from repro_torch.analysis.core import Checker, Finding, Source, register

GUARD_RE = re.compile(r"#\s*guarded by:\s*([A-Za-z_]\w*)")
HOLDS_RE = re.compile(r"#\s*holds:\s*([A-Za-z_]\w*)")

MONITOR_LOCKS = {"_monitor_lock"}
BLOCKING_ATTRS = {"send", "sendall", "recv", "recv_into", "accept",
                  "connect", "fsync", "fdatasync", "join", "sleep"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


@register
class LockDisciplineChecker(Checker):
    name = "lock-discipline"
    description = ("'# guarded by: <lock>' fields only touched under "
                   "'with self.<lock>'; no blocking calls while "
                   "_monitor_lock is held")

    def check(self, src: Source) -> Iterator[Finding]:
        guard_lines: Dict[int, str] = {}
        holds_lines: Dict[int, str] = {}
        def code_line(i: int) -> int:
            """A standalone comment annotates the next code line."""
            if not src.lines[i - 1].strip().startswith("#"):
                return i
            j = i + 1
            while j <= len(src.lines) \
                    and src.lines[j - 1].strip().startswith("#"):
                j += 1
            return j

        for i, line in enumerate(src.lines, start=1):
            m = GUARD_RE.search(line)
            if m:
                guard_lines[code_line(i)] = m.group(1)
            m = HOLDS_RE.search(line)
            if m:
                holds_lines[code_line(i)] = m.group(1)

        classes: Dict[str, ast.ClassDef] = {}
        own_guards: Dict[ast.ClassDef, Dict[str, str]] = {}
        holds: Dict[ast.AST, Set[str]] = {}
        for node in ast.walk(src.tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = node
            elif isinstance(node, (ast.Assign, ast.AnnAssign)) \
                    and node.lineno in guard_lines:
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    field = _self_attr(tgt)
                    if field is None:
                        continue
                    cls = src.enclosing(node, ast.ClassDef)
                    if cls is not None:
                        own_guards.setdefault(cls, {})[field] = \
                            guard_lines[node.lineno]
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.lineno in holds_lines:
                holds.setdefault(node, set()).add(holds_lines[node.lineno])

        def effective_guards(cls: ast.ClassDef,
                             seen: Set[str]) -> Dict[str, str]:
            out: Dict[str, str] = {}
            for base in cls.bases:
                if isinstance(base, ast.Name) and base.id in classes \
                        and base.id not in seen:
                    out.update(effective_guards(
                        classes[base.id], seen | {base.id}))
            out.update(own_guards.get(cls, {}))
            return out

        for cls in classes.values():
            guards = effective_guards(cls, {cls.name})
            if not guards:
                continue
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_method(
                        src, guards, holds.get(item, set()), item)

        yield from self._check_monitor_blocking(src, holds)

    # -- guarded-field enforcement --------------------------------------
    def _check_method(self, src: Source, guards: Dict[str, str],
                      held: Set[str], fn) -> Iterator[Finding]:
        if fn.name == "__init__":
            return

        def visit(node: ast.AST, active: Set[str]):
            if isinstance(node, ast.With):
                inner = set(active)
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None:
                        inner.add(attr)
                for item in node.items:
                    yield from visit(item, active)
                for child in node.body:
                    yield from visit(child, inner)
                return
            field = _self_attr(node)
            if field is not None and field in guards:
                lock = guards[field]
                if lock not in active and lock not in held:
                    yield Finding(
                        rule=self.name, path=src.relpath, line=node.lineno,
                        message=(f"self.{field} is '# guarded by: {lock}' "
                                 f"but is accessed outside 'with "
                                 f"self.{lock}' (and {fn.name}() is not "
                                 f"annotated '# holds: {lock}')"))
            for child in ast.iter_child_nodes(node):
                yield from visit(child, active)

        for stmt in fn.body:
            yield from visit(stmt, set())

    # -- no blocking calls under the monitor lock -----------------------
    def _check_monitor_blocking(self, src: Source,
                                holds: Dict[ast.AST, Set[str]]
                                ) -> Iterator[Finding]:
        regions: List[ast.AST] = []
        for node in ast.walk(src.tree):
            if isinstance(node, ast.With):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr in MONITOR_LOCKS:
                        regions.extend(node.body)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if holds.get(node, set()) & MONITOR_LOCKS:
                    regions.extend(node.body)
        for region in regions:
            for node in ast.walk(region):
                if not isinstance(node, ast.Call):
                    continue
                blocked = None
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in BLOCKING_ATTRS:
                    # ", ".join(...) is not thread-blocking
                    if not (isinstance(node.func.value, ast.Constant)
                            and isinstance(node.func.value.value, str)):
                        blocked = node.func.attr
                elif isinstance(node.func, ast.Name) \
                        and node.func.id in ("sleep", "fsync"):
                    blocked = node.func.id
                if blocked is not None:
                    yield Finding(
                        rule=self.name, path=src.relpath, line=node.lineno,
                        message=(f"blocking call '{blocked}(...)' while "
                                 f"holding _monitor_lock: the monitor lock "
                                 f"serializes probe sweeps against fences "
                                 f"-- blocking here stalls failure "
                                 f"detection fleet-wide"))
