"""Analysis engine: file walking, findings and the rule registry.

The port's copy of the part of ``kubegpu_tpu/analysis/engine.py`` that
its host-sync rule needs. Rules are whole-project passes: the engine
parses every ``.py`` under the requested roots once and hands the list of
:class:`SourceFile` objects to each rule, whose findings land on a
``path:line``.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Iterable, Sequence


class AnalysisError(Exception):
    """A file could not be analysed (unreadable or unparseable), or a rule
    name is unknown."""


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


def walk_functions(tree: ast.AST) -> list:
    """``(qualname, node)`` for every function in a module, methods as
    ``Class.method`` and nested functions as ``outer.inner``."""
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
    """A parsed module. ``path`` is the display path (relative to the
    working directory where possible); ``relparts`` are the path's
    components relative to the scanned root, which rules scope by, so a
    fixture passed explicitly does not inherit the scope of the tree it
    lives in."""

    def __init__(self, path: str, relparts: tuple, text: str) -> None:
        self.path = path
        self.relparts = relparts
        self.text = text
        try:
            self.tree = ast.parse(text, filename=path)
        except SyntaxError as e:
            raise AnalysisError(f"{path}: syntax error: {e}") from e


class Context:
    """What one invocation shares across rules: which rules ran, their
    side reports (``--report`` renders them) and the usage of each rule's
    own waivers, which the unused-suppression audit reads."""

    def __init__(self) -> None:
        self.ran_rules: set = set()
        self.reports: dict = {}
        # rule name -> [{"path", "line", "used"}]
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
                 reports: dict | None = None) -> list:
    """Run the (selected) rules over ``roots``; returns the findings
    sorted by location. ``reports``, when given, receives the rules' side
    reports."""
    rules = all_rules()
    if select is not None:
        wanted = set(select)
        unknown = wanted - {r.name for r in rules}
        if unknown:
            raise AnalysisError(
                f"unknown rule(s): {', '.join(sorted(unknown))}")
        rules = [r for r in rules if r.name in wanted]
    sources = load_sources(roots)
    ctx = Context()
    ctx.ran_rules = {r.name for r in rules}
    # the audit reads every other rule's waiver usage, so it runs last
    rules = sorted(rules, key=lambda r: r.name == "unused-suppression")
    findings: list = []
    for rule in rules:
        findings.extend(rule.run(sources, ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    if reports is not None:
        reports.update(ctx.reports)
    return findings
