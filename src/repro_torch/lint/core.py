"""Lint engine — source model, pragma grammar, checker registry, runner.

The port's own copy of ``repro.lint.core``: a plain-``ast`` pass (no
imports of the checked code, no torch): each checker receives a
:class:`SourceFile` (parsed tree + raw lines + the pragma/annotation
side-channel) and returns :class:`Finding`s.  Everything codebase-specific
lives in ``repro_torch.lint.checkers``; this module is the machinery.

Pragma grammar (all parsed from raw comment text, so they work on any
line the tokenizer keeps), the reference's, so that a pragma means the
same to both linters that read the port's sources:

``# lint: disable=LXXX(reason)``
    Suppress rule LXXX on this line (or, when the pragma comment stands
    alone on a line, on the next line).  The parenthesized reason is
    MANDATORY, and several rules may be listed comma-separated.  A
    pragma that does not parse is itself a finding (L000), and L000
    cannot be suppressed.

``# @locked:<lockname>``
    Declares that the attribute(s) assigned on this line are guarded by
    ``self.<lockname>`` (L004).

``@holds:<lockname>``
    In a function's docstring or on its ``def`` line: the function is
    only ever called with ``<lockname>`` already held (L004).

``# lint: dispatch``
    On a function's ``def`` line, or on a comment line right above it
    (or above its first decorator): the function issues device work in
    the dispatch region, where L002 and L003 look.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import tokenize
from typing import Callable, Dict, List, Optional, Sequence, Set

RULES: Dict[str, str] = {
    "L000": "malformed-pragma",
    "L001": "global-generator-draw",
    "L002": "host-sync-in-dispatch",
    "L003": "impure-strategy-state",
    "L004": "unlocked-shared-mutation",
    "L005": "fingerprint-dtype-drift",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    message: str

    def render(self) -> str:
        slug = RULES.get(self.rule, "?")
        return f"{self.path}:{self.line}: {self.rule} [{slug}] {self.message}"


_PRAGMA_RE = re.compile(r"#\s*lint:\s*disable=(.*)$")
_PRAGMA_ITEM_RE = re.compile(r"^(L\d{3})\(([^()]*)\)$")
_PRAGMA_SCAN_RE = re.compile(r"L\d{3}\([^()]*\)")
_LOCKED_RE = re.compile(r"#.*@locked:([A-Za-z_]\w*)")
_HOLDS_RE = re.compile(r"@holds:([A-Za-z_]\w*)")
_DISPATCH_RE = re.compile(r"#\s*lint:\s*dispatch\b")


class SourceFile:
    """One parsed module plus its comment side-channel (pragmas, lock
    annotations).  Checkers never re-read the file."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.pragma_findings: List[Finding] = []
        # line -> rules disabled there
        self.disabled: Dict[int, Set[str]] = {}
        # line -> lockname declared by a  # @locked:<name>  comment
        self.locked_decls: Dict[int, str] = {}
        # lines holding a  # lint: dispatch  comment
        self.dispatch_marks: Set[int] = set()
        self._parse_comments()

    # -- comment side-channel -------------------------------------------------
    def _parse_comments(self) -> None:
        # real COMMENT tokens only: a docstring QUOTING the pragma
        # grammar (like this module's) must not register as a pragma
        try:
            tokens = list(tokenize.generate_tokens(
                io.StringIO(self.text).readline))
        except tokenize.TokenError:
            return
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            i = tok.start[0]
            m = _LOCKED_RE.search(tok.string)
            if m:
                self.locked_decls[i] = m.group(1)
            if _DISPATCH_RE.search(tok.string):
                self.dispatch_marks.add(i)
            m = _PRAGMA_RE.search(tok.string)
            if m:
                self._parse_pragma(i, m.group(1).strip())

    def _parse_pragma(self, line: int, body: str) -> None:
        items = _PRAGMA_SCAN_RE.findall(body)
        residue = _PRAGMA_SCAN_RE.sub("", body).replace(",", "").strip()
        rules: Set[str] = set()
        ok = bool(items) and not residue
        for item in items:
            m = _PRAGMA_ITEM_RE.match(item)
            if m is None or not m.group(2).strip():
                ok = False
                continue
            rules.add(m.group(1))
        if not ok:
            self.pragma_findings.append(Finding(
                self.path, line, "L000",
                f"malformed pragma {body!r}: expected "
                f"'# lint: disable=LXXX(reason)' with a non-empty reason"))
            return
        self.disabled.setdefault(line, set()).update(rules)

    def is_disabled(self, rule: str, line: int) -> bool:
        """A finding is suppressed by a pragma on its own line, or on an
        immediately preceding comment-only line."""
        if rule in self.disabled.get(line, ()):
            return True
        prev = line - 1
        if (rule in self.disabled.get(prev, ())
                and 1 <= prev <= len(self.lines)
                and self.lines[prev - 1].lstrip().startswith("#")):
            return True
        return False

    def holds_for(self, fn: ast.AST) -> Set[str]:
        """Locknames a function declares it is called holding
        (``@holds:<name>`` on the def line(s) or in the docstring)."""
        held: Set[str] = set()
        doc = ast.get_docstring(fn, clean=False)
        if doc:
            held.update(_HOLDS_RE.findall(doc))
        body_start = fn.body[0].lineno if fn.body else fn.lineno + 1
        for i in range(fn.lineno, min(body_start, len(self.lines)) + 1):
            if 1 <= i <= len(self.lines):
                held.update(_HOLDS_RE.findall(self.lines[i - 1]))
        return held

    def marked_dispatch(self, fn: ast.AST) -> bool:
        """Whether ``fn`` carries ``# lint: dispatch``: on its ``def``
        line(s), or on the comment-only line above its first line (its
        first decorator's, if any)."""
        first = min([fn.lineno] + [d.lineno for d in fn.decorator_list])
        body_start = fn.body[0].lineno if fn.body else fn.lineno + 1
        lines = set(range(fn.lineno, max(body_start, fn.lineno + 1)))
        if first > 1 and self.lines[first - 2].lstrip().startswith("#"):
            lines.add(first - 1)
        return bool(lines & self.dispatch_marks)


CheckerFn = Callable[[SourceFile], List[Finding]]
CHECKERS: Dict[str, CheckerFn] = {}


def checker(rule: str) -> Callable[[CheckerFn], CheckerFn]:
    """Register ``fn`` as the implementation of ``rule``."""
    if rule not in RULES:
        raise ValueError(f"unknown rule {rule!r}; add it to RULES first")

    def deco(fn: CheckerFn) -> CheckerFn:
        CHECKERS[rule] = fn
        return fn
    return deco


def lint_text(path: str, text: str,
              select: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one module's source; returns unsuppressed findings sorted by
    (line, rule).  Syntax errors surface as a single E999 finding."""
    try:
        sf = SourceFile(path, text)
    except SyntaxError as e:
        return [Finding(path, e.lineno or 1, "E999",
                        f"syntax error: {e.msg}")]
    findings = list(sf.pragma_findings)
    for rule in sorted(CHECKERS):
        if select and rule not in select:
            continue
        findings.extend(CHECKERS[rule](sf))
    kept = []
    for f in findings:
        if f.rule != "L000" and sf.is_disabled(f.rule, f.line):
            continue
        if select and f.rule not in select and f.rule != "L000":
            continue
        kept.append(f)
    return sorted(kept, key=lambda f: (f.line, f.rule, f.message))


def lint_file(path: str, select: Optional[Set[str]] = None) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as f:
        return lint_text(path, f.read(), select=select)


def iter_py_files(paths: Sequence[str]) -> List[str]:
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if d not in ("__pycache__", ".git"))
                out.extend(os.path.join(root, f) for f in sorted(files)
                           if f.endswith(".py"))
        elif p.endswith(".py"):
            out.append(p)
    return out


def run(paths: Sequence[str],
        select: Optional[Set[str]] = None) -> List[Finding]:
    """Lint every ``.py`` under ``paths``; returns all unsuppressed
    findings."""
    findings: List[Finding] = []
    for path in iter_py_files(paths):
        findings.extend(lint_file(path, select=select))
    return findings
