"""no-swallowed-exceptions: retry/watch loops must not eat errors blind.

A broad ``except``/``except Exception:`` whose body is just ``pass`` or
``continue``, sitting inside a loop, is the signature of a silently-dying
control loop: a watch thread that drops every event, an advertiser that
retries forever against a gone node, a chaos duplicate that masks a real
server error. A persistently-failing advertiser that looks identical
to a healthy one is exactly this shape.

The rule is lexical: the handler must log (any ``log.*``/``logging.*``
call, or a counter increment plus a comment is NOT enough), re-raise, or
narrow the exception type. Deliberate best-effort swallows take a
``# analysis: disable=no-swallowed-exceptions`` with a justification.

Scope: everything but ``workload/``.

The port's copy of ``kubegpu_tpu/analysis/rules/exceptions.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator

from kubegpu_tpu_torch.analysis.engine import Context, Finding

_BROAD = frozenset({"Exception", "BaseException"})
_EXEMPT_TOP_DIRS = frozenset({"workload"})


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, ast.Name):
        return t.id in _BROAD
    if isinstance(t, ast.Attribute):
        return t.attr in _BROAD
    if isinstance(t, ast.Tuple):
        return any(_is_broad_node(elt) for elt in t.elts)
    return False


def _is_broad_node(node: ast.AST) -> bool:
    if isinstance(node, ast.Name):
        return node.id in _BROAD
    if isinstance(node, ast.Attribute):
        return node.attr in _BROAD
    return False


def _is_silent(handler: ast.ExceptHandler) -> bool:
    return all(isinstance(stmt, (ast.Pass, ast.Continue))
               for stmt in handler.body)


class _LoopVisitor(ast.NodeVisitor):
    """Collects broad+silent handlers that are lexically inside a loop
    (within the same function — a handler in a nested def is considered
    on its own)."""

    def __init__(self) -> None:
        self.hits: list = []
        self._loop_depth = 0

    def visit_For(self, node: ast.For) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_FunctionDef(self, node: ast.AST) -> None:
        saved = self._loop_depth
        self._loop_depth = 0
        self.generic_visit(node)
        self._loop_depth = saved

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Lambda(self, node: ast.Lambda) -> None:
        pass  # no statements inside

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        if self._loop_depth > 0 and _is_broad(node) and _is_silent(node):
            self.hits.append(node)
        self.generic_visit(node)


class NoSwallowedExceptions:
    name = "no-swallowed-exceptions"
    description = ("no bare/broad `except: pass` in loops — log, re-raise, "
                   "or narrow the exception")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            if src.relparts and src.relparts[0] in _EXEMPT_TOP_DIRS:
                continue
            visitor = _LoopVisitor()
            visitor.visit(src.tree)
            for handler in visitor.hits:
                yield Finding(
                    self.name, src.path, handler.lineno,
                    "broad exception silently swallowed inside a loop — a "
                    "persistently-failing iteration is invisible; log the "
                    "failure, narrow the exception type, or suppress with "
                    "a justification")
