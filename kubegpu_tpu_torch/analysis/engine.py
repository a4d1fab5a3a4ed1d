"""Analysis engine: file walking, suppressions, and the rule registry.

Rules are whole-project passes (some, like codec-pairing, are inherently
cross-file), so the engine parses every ``.py`` under the requested roots
once and hands the full list of :class:`SourceFile` objects to each rule.
Findings land on a repo-relative ``path:line`` and are filtered against
``# analysis: disable=...`` comments before they reach the caller.

The port's copy of ``kubegpu_tpu/analysis/engine.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import io
import os
import re
import time
import tokenize
from typing import Iterable, Sequence

# `# analysis: disable=<rule>[,<rule>...]  -- free-text justification`
# (placeholders bracketed so this very comment cannot match the regex)
SUPPRESS_RE = re.compile(
    r"#\s*analysis:\s*disable(?P<scope>-file)?="
    r"(?P<rules>[A-Za-z0-9_-]+(?:\s*,\s*[A-Za-z0-9_-]+)*)")


class AnalysisError(Exception):
    """A file could not be analyzed (unreadable or unparseable)."""


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` attribute chains -> ``"a.b.c"``; None for anything else."""
    parts: list = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def bound_comments(src: "SourceFile", regex: "re.Pattern[str]") -> list:
    """``(comment_line, def_line, match)`` for every comment matching
    ``regex``: trailing on a ``def`` line, or on a comment line above
    it with any run of comment/decorator/blank lines between (stacked
    declarations — ``# hot-path: pure`` over ``# twin-of:`` over the
    ``def`` — all keep their binding). A comment that reaches no
    ``def`` is returned with ``def_line None`` so callers can flag the
    orphan instead of silently dropping a decayed declaration. One
    implementation, shared by every def-bound comment convention, so
    the conventions cannot drift apart."""
    lines = src.text.splitlines()
    out: list = []
    for i, text in enumerate(lines, start=1):
        m = regex.search(text)
        if m is None:
            continue
        if text.strip().startswith(("def ", "async def ")):
            out.append((i, i, m))
            continue
        j = i + 1
        bound = None
        while j <= len(lines) and j <= i + 16:
            nxt = lines[j - 1].strip()
            if nxt.startswith(("def ", "async def ")):
                bound = j
                break
            if nxt.startswith("#") or nxt.startswith("@") or not nxt:
                j += 1
                continue
            break
        out.append((i, bound, m))
    return out


def walk_functions(tree: ast.AST) -> list:
    """``(qualname, node)`` for every function/method in a module, with
    ``Class.method`` qualnames one level deep (the repo convention);
    nested functions as ``outer.inner``."""
    out: list = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}{child.name}"
                out.append((qual, child))
                visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


class Suppression:
    """One ``# analysis: disable[-file]=...`` comment, with usage
    tracking: the engine marks which rules it actually silenced so the
    unused-suppression audit can flag the stale ones (ruff's
    unused-noqa, applied to our own suppressions)."""

    __slots__ = ("line", "rules", "file_scope", "used_rules")

    def __init__(self, line: int, rules: set, file_scope: bool) -> None:
        self.line = line
        self.rules = frozenset(rules)
        self.file_scope = file_scope
        self.used_rules: set = set()

    def matches(self, rule: str, line: int) -> bool:
        if rule not in self.rules and "all" not in self.rules:
            return False
        if self.file_scope:
            return True
        # a trailing comment on the offending line, or one directly above
        return line in (self.line, self.line + 1)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class SourceFile:
    """A parsed module plus its suppression map.

    ``path`` is the display path (relative to the invocation cwd when
    possible); ``relparts`` are the path components *relative to the
    scanned root*, which is what rules use for scoping decisions — a
    fixture tree passed explicitly must not inherit the exemptions of
    the directory it happens to live under.
    """

    def __init__(self, path: str, relparts: tuple, text: str) -> None:
        self.path = path
        self.relparts = relparts
        self.text = text
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            raise AnalysisError(f"{path}: syntax error: {e}") from e
        self.suppressions: list = []
        self._collect_suppressions()

    @property
    def name(self) -> str:
        return os.path.basename(self.path)

    def _collect_suppressions(self) -> None:
        try:
            tokens = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = SUPPRESS_RE.search(tok.string)
                if m is None:
                    continue
                rules = {r.strip() for r in m.group("rules").split(",")
                         if r.strip()}
                self.suppressions.append(Suppression(
                    tok.start[0], rules, bool(m.group("scope"))))
        except tokenize.TokenError:
            pass  # the AST parsed; a trailing tokenize hiccup loses nothing

    def match_suppression(self, rule: str, line: int):
        """The :class:`Suppression` disabling ``rule`` at ``line`` (by a
        trailing comment on the line itself, a comment on the line
        directly above, or a file-wide ``disable-file``), or None."""
        for sup in self.suppressions:
            if sup.matches(rule, line):
                return sup
        return None

    def suppressed(self, rule: str, line: int) -> bool:
        return self.match_suppression(rule, line) is not None


class Context:
    """Cross-rule invocation context (project root, tests location, and
    — for the unused-suppression audit — which rules ran)."""

    def __init__(self, root: str, tests_dir: str | None = None) -> None:
        self.root = root
        self.tests_dir = tests_dir
        self.ran_rules: set = set()
        self.known_rules: set = set()
        # rule name -> structured side-report (the hot-path rule's ranked
        # vectorization-blockers inventory rides here; --report renders it)
        self.reports: dict = {}
        # rule name -> [{"path","line","used"}] for comment-waiver forms
        # that are not `# analysis: disable=` (host-sync's
        # `# host-sync: allowed`); unused-suppression audits these too
        self.waiver_audits: dict = {}


def _collect_files(root: str) -> list:
    """(abs_path, relparts) for every .py under ``root``, sorted."""
    root = os.path.abspath(root)
    if os.path.isfile(root):
        return [(root, (os.path.basename(root),))]
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                rel = os.path.relpath(full, root)
                out.append((full, tuple(rel.split(os.sep))))
    return out


def load_sources(roots: Sequence[str]) -> list:
    """Parse every .py under ``roots`` into :class:`SourceFile` objects."""
    sources = []
    cwd = os.getcwd()
    for root in roots:
        if not os.path.exists(root):
            raise AnalysisError(f"no such path: {root}")
        for full, relparts in _collect_files(root):
            display = os.path.relpath(full, cwd)
            if display.startswith(".."):
                display = full
            with open(full, encoding="utf-8") as fh:
                text = fh.read()
            sources.append(SourceFile(display, relparts, text))
    return sources


def all_rules() -> list:
    from kubegpu_tpu_torch.analysis.rules import ALL_RULES

    return list(ALL_RULES)


def run_analysis(roots: Sequence[str], select: Iterable[str] | None = None,
                 tests_dir: str | None = None,
                 stats: dict | None = None,
                 reports: dict | None = None) -> list:
    """Run the (selected) rules over ``roots``; returns findings sorted by
    location, with suppressed findings already dropped. When ``stats``
    is a dict it is filled with the timing report ``--stats`` prints:
    ``{"files": N, "parse_s": float, "rules": {name: seconds},
    "total_s": float}`` — the dataflow pass made per-rule cost worth
    watching, and CI holds the total to a wall-clock budget."""
    t_start = time.perf_counter()
    rules = all_rules()
    if select is not None:
        wanted = set(select)
        unknown = wanted - {r.name for r in rules}
        if unknown:
            raise AnalysisError(
                f"unknown rule(s): {', '.join(sorted(unknown))}")
        rules = [r for r in rules if r.name in wanted]
    sources = load_sources(roots)
    parse_s = time.perf_counter() - t_start
    by_path = {s.path: s for s in sources}
    ctx = Context(root=os.path.abspath(roots[0]) if roots else os.getcwd(),
                  tests_dir=tests_dir)
    ctx.known_rules = {r.name for r in all_rules()}
    ctx.ran_rules = {r.name for r in rules}
    # the audit must observe every other rule's suppression usage, so it
    # always runs last regardless of registry order
    rules = sorted(rules, key=lambda r: r.name == "unused-suppression")
    findings: list = []
    rule_times: dict = {}
    for rule in rules:
        t_rule = time.perf_counter()
        for finding in rule.run(sources, ctx):
            src = by_path.get(finding.path)
            if src is not None:
                sup = src.match_suppression(finding.rule, finding.line)
                if sup is not None:
                    sup.used_rules.add(finding.rule)
                    continue
            findings.append(finding)
        rule_times[rule.name] = time.perf_counter() - t_rule
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if reports is not None:
        reports.update(ctx.reports)
    if stats is not None:
        stats["files"] = len(sources)
        stats["parse_s"] = parse_s
        stats["rules"] = rule_times
        stats["total_s"] = time.perf_counter() - t_start
    return findings
