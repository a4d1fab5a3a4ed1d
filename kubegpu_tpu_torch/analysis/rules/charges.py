"""Charge-pairing: every ``assume_pod`` reaches ``confirm``/``forget``.

The static twin of the explorer's card-accounting conservation property
(PAPER.md's optimistic schedule-time allocation): an ``assume_pod``
charges the scheduler cache optimistically, and the charge MUST be
resolved — ``confirm_pod`` when the bind commits, ``forget_pod`` when it
fails, conflicts, or crashes. An execution path that drops the charge on
the floor under-places the node until the 30 s assumed-pod TTL sweeps it
(latency, not safety — but a *systematic* leak on a hot path is real
capacity loss, and the TTL exists for crashes, not for control flow).

The rule is **interprocedural**: a call counts as resolving when its
callee *transitively* reaches ``confirm_pod``/``forget_pod`` through the
package call graph (:class:`~kubegpu_tpu_torch.analysis.dataflow.CallGraph`) —
handing the assumed pod to the pipelined binder (whose commit/crash
paths confirm or forget) is the designed resolution, not a leak.
Callees are resolved by name across the scanned tree (an
over-approximation: a same-named function anywhere in the package
matches), which errs toward silence, never toward noise.

The path reasoning itself lives in the shared dataflow
engine (:mod:`kubegpu_tpu_torch.analysis.dataflow`): the rule builds the
function's CFG, treats each ``assume_pod`` statement as an *acquire*
site and every statement calling a resolving name as a *release*, and
asks :func:`~kubegpu_tpu_torch.analysis.dataflow.may_leak` whether the charge
can reach a checked exit still open. The contract is unchanged:

- **Normal paths** — every path from the call site to function exit
  (including an explicit ``raise``) must contain a resolving call.
- **Exception edges** — when the call site sits inside a ``try``, each
  ``except`` handler is a path of its own and must also resolve (a
  handler that logs-and-returns swallowed the failure AND the charge).
  Outside any ``try``, an unexpected exception propagates to the TTL
  backstop by design and is not flagged.
- **Loops** — may-iterate semantics with the canonical-cleanup
  refinement: ``for p in assumed: forget_pod(p)`` iterates exactly when
  there is a charge to release and counts as resolving.

The port's copy of ``kubegpu_tpu/analysis/rules/charges.py``.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Set

from kubegpu_tpu_torch.analysis.dataflow import (CallGraph, LeakReport, Node,
                                           build_cfg, call_names, may_leak,
                                           stmt_sites)
from kubegpu_tpu_torch.analysis.engine import Context, Finding, SourceFile

ASSUME = "assume_pod"
RESOLVERS = frozenset({"confirm_pod", "forget_pod"})


def _effect_calls(node: Node) -> Set[str]:
    out: Set[str] = set()
    for sub in node.effect_asts():
        out |= call_names(sub)
    return out


class ChargePairing:
    """Every ``assume_pod`` call site must reach ``confirm_pod`` or
    ``forget_pod`` on all paths — normal and handled-exception — with
    hand-offs followed interprocedurally through the call graph."""

    name = "charge-pairing"
    description = ("every assume_pod call site must reach "
                   "confirm_pod/forget_pod on all paths (exception "
                   "handlers included), transitively through callees")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        resolving = CallGraph(sources).closure(RESOLVERS)
        for src in sources:
            for node in ast.walk(src.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                if node.name == ASSUME:
                    continue  # the definition, not a consumer
                if ASSUME not in call_names(node):
                    continue
                yield from self._check_function(src, node, resolving)

    def _check_function(self, src: SourceFile, fn: ast.AST,
                        resolving: frozenset) -> Iterator[Finding]:
        cfg = build_cfg(fn)

        def releases(node: Node) -> bool:
            return bool(_effect_calls(node) & resolving)

        sites = stmt_sites(cfg, lambda n: ASSUME in _effect_calls(n))
        reports: List[LeakReport] = []
        site_lines: List[int] = []
        for site in sites:
            reports.append(may_leak(cfg, site, releases,
                                    site_releases=releases(site)))
            site_lines.append(getattr(site.stmt, "lineno", fn.lineno))
        seen: Set[tuple] = set()
        for line, report in zip(site_lines, reports):
            if report.normal:
                finding = Finding(
                    self.name, src.path, line,
                    f"`{ASSUME}` call is not paired: a path from here to "
                    f"function exit reaches no confirm_pod/forget_pod "
                    f"(directly or through any called function); the "
                    f"assumed charge leaks until the TTL sweep")
                key = (finding.line, finding.message)
                if key not in seen:
                    seen.add(key)
                    yield finding
            for handler in report.handlers:
                finding = Finding(
                    self.name, src.path, handler.lineno,
                    f"exception edge drops the assumed charge: this "
                    f"handler covers an `{ASSUME}` call but no path "
                    f"through it reaches confirm_pod/forget_pod")
                key = (finding.line, finding.message)
                if key not in seen:
                    seen.add(key)
                    yield finding
