"""exception-hygiene rule: no silent swallowing in the protocol paths.

A broad ``except Exception`` in the fence/stamp/attach paths that
neither re-raises, latches the error (``self.err`` / ``self._exc`` /
``self.failed[...]``), nor poisons the endpoint converts a shard-writer
failure into silent data loss: the coordinator stamps a cycle whose
shard never hit disk.  Narrow the handler, latch the error, or annotate
the handler line with ``# lint: allow[exception-hygiene] <why>`` when
swallowing is the contract (e.g. ``close()`` must never raise).

Scope: the protocol code — ``core/`` and ``launch/shard_server.py``.
Best-effort cleanup in launch scripts and benchmarks is out of scope.
"""
from __future__ import annotations

import ast
from typing import Iterator

from repro_torch.analysis.core import Checker, Finding, Source, register

BROAD = {"Exception", "BaseException"}
LATCH_CALLS = {"poison", "_latch"}
LATCH_TARGETS = {"err", "_exc", "_broken", "failed", "shard_failures",
                 "_pending_poison"}


def _in_scope(relpath: str) -> bool:
    return relpath.startswith("core/") or relpath == "launch/shard_server.py"


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True                       # bare except:
    if isinstance(t, ast.Name) and t.id in BROAD:
        return True
    if isinstance(t, ast.Tuple):
        return any(isinstance(e, ast.Name) and e.id in BROAD for e in t.elts)
    return False


def _handles_error(handler: ast.ExceptHandler) -> bool:
    """Body re-raises, latches, or poisons — the failure stays visible."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) \
                and node.func.attr in LATCH_CALLS:
            return True
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Attribute) \
                            and sub.attr in LATCH_TARGETS:
                        return True
                    if isinstance(sub, ast.Name) and sub.id in LATCH_TARGETS:
                        return True
                    # box["err"] = e: latched for a later join to surface
                    if isinstance(sub, ast.Constant) \
                            and sub.value in ("err", "error", "_exc"):
                        return True
    return False


@register
class ExceptionHygieneChecker(Checker):
    name = "exception-hygiene"
    description = ("broad except in fence/stamp/attach paths must latch, "
                   "poison, or re-raise -- never swallow silently")

    def check(self, src: Source) -> Iterator[Finding]:
        if not _in_scope(src.relpath):
            return
        for node in ast.walk(src.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if _is_broad(node) and not _handles_error(node):
                yield Finding(
                    rule=self.name, path=src.relpath, line=node.lineno,
                    message=("broad except swallows the error without "
                             "latching, poisoning, or re-raising: narrow "
                             "it, latch it, or annotate why swallowing "
                             "is the contract"))
