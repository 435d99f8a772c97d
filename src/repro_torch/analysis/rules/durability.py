"""durability-ordering rule: control-file writes must be crash-atomic.

CPR's stamped-cycle protocol is only sound if the control files that
name a cycle durable — ``manifest.json``, ``CURRENT``, ``COORDINATOR``,
``LEASE`` — are replaced atomically *after* their bytes are on disk:
write tmp, flush, ``fsync(file)``, ``os.replace``, ``fsync(dir)``
(``repro_torch.core.checkpoint.atomic_write_text`` / ``atomic_json_dump``).
A raw ``open(path, "w")`` on one of these paths can be observed
truncated by a concurrently-recovering coordinator, and an
``os.replace`` without the surrounding fsyncs can survive the rename
while losing the contents (docs/recovery.md, "Durability ordering").

Two checks:

* any writable ``open()`` whose path expression mentions a durable
  control-file name is flagged — route it through the atomic helpers;
* any function calling ``os.replace``/``os.rename`` must also fsync
  before (the tmp file) and after (the directory) the rename, so the
  atomic helpers themselves pass and ad-hoc reimplementations fail.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import (Checker, Finding, Source,
                                       is_call_to, names_in, register,
                                       str_constants_in)

DURABLE_MARKERS = ("manifest.json", "CURRENT", "COORDINATOR", "LEASE")
FSYNC_NAMES = {"fsync", "fdatasync", "fsync_path"}


def _is_durable_path(expr: ast.AST) -> bool:
    for const in str_constants_in(expr):
        if any(marker in const for marker in DURABLE_MARKERS):
            return True
    for name in names_in(expr):
        if name.endswith("_PTR") or name in ("MANIFEST_NAME",):
            return True
    return False


def _write_mode(call: ast.Call) -> bool:
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return False                      # default "r"
    return (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
            and any(c in mode.value for c in "wax+"))


@register
class DurabilityChecker(Checker):
    name = "durability-ordering"
    description = ("durable control files written via atomic_write_text/"
                   "atomic_json_dump, or the full write-fsync-replace-"
                   "fsync(dir) sequence")

    def check(self, src: Source) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.Call):
                continue
            # raw writable open() on a durable control-file path
            if isinstance(node.func, ast.Name) and node.func.id == "open" \
                    and node.args and _write_mode(node) \
                    and _is_durable_path(node.args[0]):
                yield Finding(
                    rule=self.name, path=src.relpath, line=node.lineno,
                    message=("raw writable open() on a durable control "
                             "file: use atomic_write_text/atomic_json_dump "
                             "so recovery never observes a torn write"))
            # os.replace/os.rename without the surrounding fsyncs
            if is_call_to(node, "os", "replace") \
                    or is_call_to(node, "os", "rename"):
                fn = src.enclosing(
                    node, (ast.FunctionDef, ast.AsyncFunctionDef))
                if not self._fsync_bracketed(fn, node):
                    yield Finding(
                        rule=self.name, path=src.relpath, line=node.lineno,
                        message=("os.replace without the full write -> "
                                 "fsync(file) -> replace -> fsync(dir) "
                                 "sequence: rename durability needs both "
                                 "fsyncs (see atomic_write_text)"))

    @staticmethod
    def _fsync_bracketed(fn, replace_call: ast.Call) -> bool:
        """True when the enclosing function fsyncs both before (the tmp
        file's bytes) and after (the directory entry) the rename."""
        if fn is None:
            return False
        before = after = False
        for sub in ast.walk(fn):
            if not isinstance(sub, ast.Call):
                continue
            is_fsync = (isinstance(sub.func, ast.Attribute)
                        and sub.func.attr in FSYNC_NAMES) or \
                       (isinstance(sub.func, ast.Name)
                        and sub.func.id in FSYNC_NAMES)
            if not is_fsync:
                continue
            if sub.lineno <= replace_call.lineno:
                before = True
            if sub.lineno >= replace_call.lineno:
                after = True
        return before and after
