"""Invariant-linter core: sources, findings, suppressions, baseline, runner.

The port's own copy of ``repro.analysis.core``: the same engine, whose
default scan root is the ``repro_torch`` package, with the port's rules.

The CPR writer fleet's safety argument rests on conventions no general
linter knows about — fsync-before-STAMP ordering, monotonic deadlines,
epoch-fenced frames, ``_monitor_lock`` discipline.  This module is the
engine that project-specific checkers (``repro_torch.analysis.rules``) plug
into:

* ``Source`` — one parsed Python file: text, line table, AST with parent
  links, and the per-line suppression map.
* ``Checker`` — base class; subclasses register with ``@register`` and
  implement ``check`` (per file) and/or ``finalize`` (cross-file, e.g.
  the frame-type drift check needs both sides of the wire protocol).
* ``run_analysis`` — walk a tree, run checkers, apply suppressions and
  an optional findings baseline, return a ``Report``.

Suppression syntax (same line as the finding, or a standalone comment
line directly above it)::

    risky_thing()   # lint: allow[rule-name] why this one is fine

Baseline: a JSON list of ``{rule, path, message}`` records.  Matching
deliberately ignores line numbers so unrelated edits above a grand-
fathered finding do not resurrect it.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import re
from typing import Dict, Iterable, Iterator, List, Optional, Sequence

SUPPRESS_RE = re.compile(
    r"#\s*lint:\s*allow\[([A-Za-z0-9_-]+)\]\s*(.*?)\s*$")


@dataclasses.dataclass
class Finding:
    """One rule violation at a source location."""
    rule: str
    path: str               # relative to the scan root
    line: int
    message: str
    suppressed: bool = False
    suppress_reason: str = ""
    baselined: bool = False

    @property
    def key(self):
        # line numbers churn; identity is (rule, file, message)
        return (self.rule, self.path, self.message)

    def render(self) -> str:
        tags = []
        if self.suppressed:
            tags.append("allowed: " + (self.suppress_reason or "no reason"))
        if self.baselined:
            tags.append("baselined")
        tag = f"  [{'; '.join(tags)}]" if tags else ""
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}{tag}"


class Source:
    """A parsed source file plus the metadata checkers need."""

    def __init__(self, root: str, abspath: str):
        self.root = root
        self.abspath = abspath
        self.relpath = os.path.relpath(abspath, root).replace(os.sep, "/")
        with open(abspath, encoding="utf-8") as f:
            self.text = f.read()
        self.lines = self.text.splitlines()
        self.tree = ast.parse(self.text, filename=self.relpath)
        self._link_parents()
        self._suppressions = self._parse_suppressions()

    def _link_parents(self):
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                child.parent = node  # type: ignore[attr-defined]

    def _parse_suppressions(self) -> Dict[int, Dict[str, str]]:
        """line number -> {rule: reason}.  A suppression comment covers
        its own line; a comment-only line also covers the next line."""
        out: Dict[int, Dict[str, str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if not m:
                continue
            rule, reason = m.group(1), m.group(2)
            out.setdefault(i, {})[rule] = reason
            if line.strip().startswith("#"):
                # a standalone comment covers the next code line, skipping
                # over any continuation comment lines below it
                j = i + 1
                while j <= len(self.lines) \
                        and self.lines[j - 1].strip().startswith("#"):
                    j += 1
                out.setdefault(j, {})[rule] = reason
        return out

    def suppression(self, line: int, rule: str) -> Optional[str]:
        """Reason string if ``line`` carries an allow for ``rule``."""
        rules = self._suppressions.get(line)
        if rules is None:
            return None
        return rules.get(rule)

    # -- AST helpers shared by checkers ---------------------------------
    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = getattr(node, "parent", None)
        while cur is not None:
            yield cur
            cur = getattr(cur, "parent", None)

    def enclosing(self, node: ast.AST, kinds) -> Optional[ast.AST]:
        for anc in self.ancestors(node):
            if isinstance(anc, kinds):
                return anc
        return None

    def enclosing_statement(self, node: ast.AST) -> ast.AST:
        cur = node
        while not isinstance(cur, ast.stmt):
            nxt = getattr(cur, "parent", None)
            if nxt is None:
                break
            cur = nxt
        return cur


class Checker:
    """Base class for invariant checkers.

    ``check`` runs once per file; ``finalize`` runs once per analysis
    with every scanned ``Source`` — use it for cross-file invariants.
    """

    name = ""
    description = ""

    def check(self, src: Source) -> Iterator[Finding]:
        return iter(())

    def finalize(self, sources: Sequence[Source]) -> Iterator[Finding]:
        return iter(())


CHECKERS: Dict[str, type] = {}


def register(cls):
    """Class decorator: add a Checker subclass to the registry."""
    assert cls.name and cls.name not in CHECKERS, cls
    CHECKERS[cls.name] = cls
    return cls


# ---------------------------------------------------------------------------
# helpers commonly needed by rules


def is_call_to(node: ast.AST, modname: str, attr: str) -> bool:
    """True for ``modname.attr(...)`` calls (e.g. ``time.time()``)."""
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == attr
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == modname)


def names_in(node: ast.AST) -> Iterator[str]:
    """Every Name id and Attribute attr in a subtree."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            yield sub.id
        elif isinstance(sub, ast.Attribute):
            yield sub.attr


def str_constants_in(node: ast.AST) -> Iterator[str]:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
            yield sub.value


# ---------------------------------------------------------------------------
# runner


@dataclasses.dataclass
class Report:
    root: str
    findings: List[Finding]
    files_scanned: int = 0

    @property
    def unsuppressed(self) -> List[Finding]:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]

    @property
    def ok(self) -> bool:
        return not self.unsuppressed

    def to_json(self) -> dict:
        return {
            "root": self.root,
            "files_scanned": self.files_scanned,
            "counts": {
                "total": len(self.findings),
                "suppressed": sum(f.suppressed for f in self.findings),
                "baselined": sum(f.baselined for f in self.findings),
                "unsuppressed": len(self.unsuppressed),
            },
            "findings": [dataclasses.asdict(f) for f in self.findings],
        }

    def to_sarif(self) -> dict:
        """SARIF 2.1.0 (the GitHub code-scanning dialect): one run, one
        rule entry per registered checker, one result per finding.
        Suppressed findings carry ``suppressions: [{kind: inSource}]``
        so upload surfaces them as dismissed, not open."""
        rule_ids = sorted({f.rule for f in self.findings}
                          | set(CHECKERS.keys()))
        rules = [{
            "id": rid,
            "shortDescription": {
                "text": getattr(CHECKERS.get(rid), "description", rid)
                or rid},
        } for rid in rule_ids]
        results = []
        for f in self.findings:
            result = {
                "ruleId": f.rule,
                "level": "note" if (f.suppressed or f.baselined)
                         else "error",
                "message": {"text": f.message},
                "locations": [{
                    "physicalLocation": {
                        "artifactLocation": {"uri": f.path},
                        "region": {"startLine": max(1, f.line)},
                    },
                }],
            }
            if f.suppressed:
                result["suppressions"] = [{
                    "kind": "inSource",
                    "justification": f.suppress_reason or "no reason",
                }]
            elif f.baselined:
                result["suppressions"] = [{"kind": "external"}]
            results.append(result)
        return {
            "$schema": ("https://raw.githubusercontent.com/oasis-tcs/"
                        "sarif-spec/master/Schemata/sarif-schema-2.1.0"
                        ".json"),
            "version": "2.1.0",
            "runs": [{
                "tool": {"driver": {
                    "name": "repro-invariant-linter",
                    "rules": rules,
                }},
                "results": results,
            }],
        }

    def baseline_records(self) -> List[dict]:
        keys = sorted({f.key for f in self.findings if not f.suppressed})
        return [{"rule": r, "path": p, "message": m} for (r, p, m) in keys]


def load_baseline(path: str) -> set:
    with open(path, encoding="utf-8") as f:
        records = json.load(f)
    return {(r["rule"], r["path"], r["message"]) for r in records}


def write_baseline(report: Report, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(report.baseline_records(), f, indent=2, sort_keys=True)
        f.write("\n")


def default_root() -> str:
    """The installed ``repro_torch`` package directory (src/repro_torch
    in-tree)."""
    import repro_torch
    return os.path.dirname(os.path.abspath(repro_torch.__file__))


def iter_py_files(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def run_analysis(root: Optional[str] = None,
                 rules: Optional[Iterable[str]] = None,
                 baseline: Optional[str] = None) -> Report:
    """Run the selected checkers (default: all) over every .py under
    ``root`` (default: the repro_torch package) and return a ``Report``."""
    # rule modules self-register on import
    from repro_torch.analysis import rules as _rules  # noqa: F401

    root = os.path.abspath(root or default_root())
    selected = sorted(rules) if rules else sorted(CHECKERS)
    unknown = [r for r in selected if r not in CHECKERS]
    if unknown:
        raise ValueError(f"unknown rule(s): {', '.join(unknown)} "
                         f"(known: {', '.join(sorted(CHECKERS))})")
    checkers = [CHECKERS[r]() for r in selected]

    sources: List[Source] = []
    findings: List[Finding] = []
    by_path: Dict[str, Source] = {}
    for path in iter_py_files(root):
        try:
            src = Source(root, path)
        except (SyntaxError, UnicodeDecodeError):
            continue                     # not analyzable; not our problem
        sources.append(src)
        by_path[src.relpath] = src

    for checker in checkers:
        for src in sources:
            findings.extend(checker.check(src))
        findings.extend(checker.finalize(sources))

    baseline_keys = load_baseline(baseline) if baseline else set()
    for f in findings:
        src = by_path.get(f.path)
        if src is not None:
            reason = src.suppression(f.line, f.rule)
            if reason is not None:
                f.suppressed = True
                f.suppress_reason = reason
        if not f.suppressed and f.key in baseline_keys:
            f.baselined = True

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return Report(root=root, findings=findings, files_scanned=len(sources))
