"""Static race detection + hot-path purity budget.

``racer`` is the RacerD-style interprocedural lockset pass (Blackshear
et al., Infer): discover every concurrency root in the repo, attribute
every shared-field write site the lockset held there (flow-sensitive
locally, meet-over-call-sites interprocedurally — see
``analysis/locksets.py``), and report any field written from two or
more roots whose write-site locksets share no common lock. Unlike the
flat ``lock-discipline`` rule (which trusts a field written under a
lock to define its own guard), this pass needs no training write: an
*entirely* unguarded counter bumped from two threads is exactly what it
exists to catch. Intentionally lock-free state is declared, not
waived: ``# guarded-by: self._lock`` (protection the analysis cannot
see — join-before-read hand-offs, protocol serialization) or
``# racer: single-writer`` (one thread owns all writes), both bound to
the field and themselves checked for referring to a real lock.

``hot-path`` is the vectorization-readiness budget for ROADMAP item 1:
the functions reachable from the scheduler's filter→score→allocate
loop are the code that must become pure array operations, so the rule
(1) inventories every *blocker* in that closure — lock acquisitions,
I/O and logging calls, and per-call allocation counts over budget —
into a ranked report (``python -m kubegpu_tpu_torch.analysis --rule hot-path
--report``), and (2) enforces the ratchet: a function annotated
``# hot-path: pure`` (optionally ``alloc=N``) is CONTRACTED clean, and
any blocker inside it is a finding. The report is the worklist the
vectorized-core refactor burns down; the annotations pin each function
it converts so the purity can never silently regress.

The port's copy of ``kubegpu_tpu/analysis/rules/racer.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, FrozenSet, Iterator, List, Optional, Set, Tuple

from kubegpu_tpu_torch.analysis import locksets
from kubegpu_tpu_torch.analysis.dataflow import CallGraph
from kubegpu_tpu_torch.analysis.engine import (Context, Finding, SourceFile,
                                         bound_comments, dotted_name)
from kubegpu_tpu_torch.analysis.locksets import (Access, FieldKey, LocksetModel,
                                           field_write_sites, shared_model)


class Racer:
    """Interprocedural lockset race detector: a field written from ≥ 2
    concurrency roots must have a non-empty intersection of write-site
    locksets, a field-level ``# guarded-by:``/``# racer: single-writer``
    declaration, or it is a report."""

    name = "racer"
    description = ("fields written from >=2 thread roots must share a "
                   "common lock across all write sites (or carry a "
                   "checked `# guarded-by:` / `# racer: single-writer` "
                   "declaration)")

    # The workload half (training/serving PyTorch code) is single-threaded
    # host-loop code driven by one caller; its method names (`submit`,
    # `step`, `run`) collide with the control plane's thread roots under
    # name-based resolution, so its fields are out of this rule's scope
    # — the control plane (scheduler, cluster, node, obs, analysis) is
    # where the 16-worker pool, HA replicas, and stream fan-out live.
    # Scoped at query time so the model itself is shared with hot-path.
    SKIP_TREES = ("workload",)

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        model = shared_model(ctx, sources)
        skip = {s.path for s in sources
                if s.relparts and s.relparts[0] in self.SKIP_TREES}
        reach = model.roots_reaching()
        yield from self._check_guard_notes(model, skip)
        for field, sites in sorted(
                field_write_sites(model).items(),
                key=lambda kv: (kv[1][0].path, kv[1][0].line)):
            sites = [acc for acc in sites if acc.path not in skip]
            if sites:
                yield from self._check_field(model, reach, field, sites)

    # -- per-field race check -------------------------------------------------

    def _check_field(self, model: LocksetModel, reach: Dict[str, Set[str]],
                     field: FieldKey,
                     sites: List[Access]) -> Iterator[Finding]:
        roots: Set[str] = set()
        rooted_sites: List[Access] = []
        for acc in sites:
            acc_roots = reach.get(acc.func)
            if acc_roots:
                roots |= acc_roots
                rooted_sites.append(acc)
        concurrency = sum(model.root_multiplicity(r) for r in roots)
        if concurrency < 2 or not rooted_sites:
            return
        locksets_held = [model.effective_locks(acc) for acc in rooted_sites]
        common: FrozenSet[str] = locksets_held[0]
        for held in locksets_held[1:]:
            common = common & held
        if common:
            return  # consistently guarded
        if field in model.guards:
            # declared lock-free discipline; a guarded-by naming a
            # nonexistent lock is _check_guard_notes's finding
            return
        bare = [acc for acc, held in zip(rooted_sites, locksets_held)
                if not held] or rooted_sites
        first = min(bare, key=lambda a: (a.path, a.line))
        held_somewhere = sorted(set().union(*locksets_held))
        hint = (f"; other write sites hold {', '.join(held_somewhere)} — "
                f"acquire it here too or annotate the field "
                f"`# guarded-by: {held_somewhere[0]}`") if held_somewhere \
            else ("; add a lock, or declare the discipline with "
                  "`# guarded-by: <lock>` / `# racer: single-writer`")
        yield Finding(
            self.name, first.path, first.line,
            f"{field.render()} is written from {len(roots)} concurrency "
            f"root(s) ({locksets.describe_roots(roots, model)}) with no "
            f"common lock across its write sites{hint}")

    @staticmethod
    def _lock_exists(model: LocksetModel, field: FieldKey,
                     lock: str) -> bool:
        """Three accepted spellings: ``self._lock`` (a lock attribute of
        the field's own class), ``SomeClass._lock`` (a *monitor* member:
        the field holds an instance of a class that guards itself
        internally — ``self.queue`` behind ``SchedulingQueue._lock``),
        or a bare module-level lock name."""
        if lock.startswith("self."):
            attr = lock.split(".", 1)[1]
            if field.owner.startswith("<"):
                return False
            return attr in model.class_locks.get(field.owner, set())
        if "." in lock:
            cls, attr = lock.rsplit(".", 1)
            if cls in model.class_locks:
                return attr in model.class_locks[cls]
        name = lock.split(".")[-1]
        return any(name in names for names in model.module_locks.values())

    def _check_guard_notes(self, model: LocksetModel,
                           skip: set) -> Iterator[Finding]:
        """guarded-by annotations on fields that never race still must
        name a real lock — a typo'd declaration is worse than none."""
        for field, note in sorted(model.guards.items(),
                                  key=lambda kv: (kv[1].path, kv[1].line)):
            if note.path not in skip and \
                    note.kind == "guarded-by" and note.lock is not None and \
                    not self._lock_exists(model, field, note.lock):
                yield Finding(
                    self.name, note.path, note.line,
                    f"`# guarded-by: {note.lock}` on {field.render()} "
                    f"names a lock the owner does not define; fix the "
                    f"annotation or declare the lock")


# ---- hot-path purity budget -------------------------------------------------

# The filter -> score -> allocate loop's entry points in scheduler/core.py
# (name-matched so the fixture trees can model the same shape).
HOT_ROOTS = ("find_nodes_that_fit", "prioritize_nodes", "allocate_devices")

DEFAULT_ALLOC_BUDGET = 8

PURE_RE = re.compile(r"#\s*hot-path:\s*pure(?:\s+alloc=(?P<alloc>\d+))?")

# Calls that are I/O or logging — per-pod-per-node work must never pay
# a syscall or a formatting round trip (and a log call allocates too).
_IO_CALL_HEADS = frozenset({"open", "print", "input"})
_IO_RECEIVERS = frozenset({"log", "logger", "logging", "warnings", "sys",
                           "os", "socket", "subprocess", "requests",
                           "urllib", "time"})
_IO_TIME_OK = frozenset({"monotonic", "perf_counter", "time", "time_ns",
                         "perf_counter_ns", "monotonic_ns"})

_ALLOC_CALL_NAMES = frozenset({"list", "dict", "set", "tuple", "sorted",
                               "frozenset", "deepcopy", "copy", "dumps",
                               "loads", "deque"})

# Names too generic to follow when expanding the hot-path closure: a
# `feasible.pop(...)` or `spool.append(...)` is a container operation,
# not a call into the same-named package method — following it would
# pull `SchedulingQueue.pop` or `WriteAheadLog.append` into the closure
# by name collision alone.
_GENERIC_NAMES = frozenset({
    "add", "append", "clear", "close", "copy", "count", "discard",
    "extend", "flush", "get", "index", "insert", "items", "join", "keys",
    "pop", "popleft", "put", "read", "recv", "release", "remove", "send",
    "set", "setdefault", "sort", "split", "start", "stop", "update",
    "values", "wait", "write",
})


class _Blockers:
    """Per-function blocker inventory."""

    def __init__(self) -> None:
        self.locks: List[Tuple[str, int]] = []   # (token, line)
        self.io: List[Tuple[str, int]] = []      # (label, line)
        self.allocs: int = 0

    def severity(self) -> Tuple[int, int, int]:
        return (len(self.locks), len(self.io), self.allocs)

    def any(self, budget: int) -> bool:
        return bool(self.locks or self.io or self.allocs > budget)


def _scan_blockers(fn: ast.AST, model: LocksetModel,
                   qualname: str) -> _Blockers:
    out = _Blockers()
    for acq in model.acquisitions:
        if acq.func == qualname:
            out.locks.append((acq.token, acq.line))
    for node in _own_body_walk(fn):
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                             ast.GeneratorExp, ast.List, ast.Dict, ast.Set,
                             ast.JoinedStr)):
            out.allocs += 1
        elif isinstance(node, ast.Call):
            label = _io_label(node)
            if label is not None:
                out.io.append((label, node.lineno))
            elif _is_alloc_call(node):
                out.allocs += 1
    out.locks.sort(key=lambda t: t[1])
    out.io.sort(key=lambda t: t[1])
    return out


def _own_body_walk(fn: ast.AST) -> Iterator[ast.AST]:
    """ast.walk, but nested function/class definitions are opaque (they
    run on someone else's schedule and carry their own entry)."""
    work: List[ast.AST] = list(ast.iter_child_nodes(fn))
    while work:
        node = work.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        yield node
        work.extend(ast.iter_child_nodes(node))


def _io_label(node: ast.Call) -> Optional[str]:
    func = node.func
    if isinstance(func, ast.Name) and func.id in _IO_CALL_HEADS:
        return f"{func.id}()"
    dotted = dotted_name(func)
    if dotted is None:
        return None
    head = dotted.split(".")[0]
    if head in _IO_RECEIVERS:
        if head == "time" and dotted.split(".")[-1] in _IO_TIME_OK:
            return None  # clock reads are cheap and everywhere
        return f"{dotted}()"
    if dotted.endswith(".wait") or dotted.endswith(".sleep"):
        return f"{dotted}()"
    return None


def _is_alloc_call(node: ast.Call) -> bool:
    func = node.func
    if isinstance(func, ast.Name):
        return func.id in _ALLOC_CALL_NAMES
    if isinstance(func, ast.Attribute):
        return func.attr in _ALLOC_CALL_NAMES
    return False


def _pure_marks(src: SourceFile) -> Dict[int, int]:
    """def-line -> allocation budget for every ``# hot-path: pure``
    comment in the file, via the shared def-bound comment walk (the
    twin-of and guard declarations stack with the contract, and a
    stacked comment must not silently unbind it)."""
    out: Dict[int, int] = {}
    for _cline, dline, m in bound_comments(src, PURE_RE):
        if dline is not None:
            out[dline] = int(m.group("alloc") or DEFAULT_ALLOC_BUDGET)
    return out


class HotPathPurity:
    """The vectorization-readiness ratchet: blockers (locks, I/O,
    logging, allocation storms) in the filter→score→allocate closure are
    inventoried into a ranked report, and any function contracted
    ``# hot-path: pure`` containing one is a finding."""

    name = "hot-path"
    description = ("functions on the filter->score->allocate hot path "
                   "annotated `# hot-path: pure` must acquire no locks, "
                   "do no I/O or logging, and stay under the per-call "
                   "allocation budget; --report ranks every blocker in "
                   "the closure")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        model = shared_model(ctx, sources)
        graph = CallGraph(sources)
        depths = self._closure_depths(graph)
        entries: List[dict] = []
        findings: List[Finding] = []
        for src in sources:
            marks = _pure_marks(src)
            for qual, rec in model.functions.items():
                if rec.path != src.path:
                    continue
                in_closure = rec.name in depths
                budget = marks.get(rec.lineno)
                if not in_closure and budget is None:
                    continue
                blockers = _scan_blockers(rec.node, model, qual)
                if budget is not None:
                    findings.extend(self._contract_findings(
                        src, rec, blockers, budget))
                if in_closure and blockers.any(DEFAULT_ALLOC_BUDGET):
                    entries.append({
                        "function": qual,
                        "path": src.path,
                        "line": rec.lineno,
                        "depth": depths[rec.name],
                        "locks": [f"{tok}@{line}"
                                  for tok, line in blockers.locks],
                        "io": [f"{label}@{line}"
                               for label, line in blockers.io],
                        "allocs": blockers.allocs,
                        "severity": blockers.severity(),
                    })
        entries.sort(key=lambda e: (-e["severity"][0], -e["severity"][1],
                                    -e["severity"][2], e["depth"],
                                    e["function"]))
        ctx.reports[self.name] = {
            "roots": [r for r in HOT_ROOTS if r in depths],
            "closure_size": len(depths),
            "alloc_budget": DEFAULT_ALLOC_BUDGET,
            "blockers": entries,
        }
        yield from findings

    @staticmethod
    def _closure_depths(graph: CallGraph) -> Dict[str, int]:
        """bare function name -> min call depth from a hot root, over
        the package call graph (name-resolved, the usual
        over-approximation, minus edges through names too generic to
        mean a package call — see ``_GENERIC_NAMES``)."""
        depths: Dict[str, int] = {}
        frontier = [r for r in HOT_ROOTS if r in graph.calls_by_name]
        for name in frontier:
            depths[name] = 0
        while frontier:
            nxt: List[str] = []
            for name in frontier:
                for callee in sorted(graph.calls_by_name.get(name, ())):
                    if callee in graph.calls_by_name and \
                            callee not in depths and \
                            callee not in _GENERIC_NAMES:
                        depths[callee] = depths[name] + 1
                        nxt.append(callee)
            frontier = nxt
        return depths

    def _contract_findings(self, src: SourceFile, rec: "locksets.FunctionRec",
                           blockers: _Blockers,
                           budget: int) -> Iterator[Finding]:
        for token, line in blockers.locks:
            yield Finding(
                self.name, src.path, line,
                f"{rec.qualname}() is contracted `# hot-path: pure` but "
                f"acquires {token}; hoist the lock out of the hot path "
                f"or drop the contract")
        for label, line in blockers.io:
            yield Finding(
                self.name, src.path, line,
                f"{rec.qualname}() is contracted `# hot-path: pure` but "
                f"calls {label}; pure hot-path code does no I/O or "
                f"logging")
        if blockers.allocs > budget:
            yield Finding(
                self.name, src.path, rec.lineno,
                f"{rec.qualname}() is contracted `# hot-path: pure` with "
                f"an allocation budget of {budget} but contains "
                f"{blockers.allocs} allocation sites; vectorize or hoist "
                f"them, or raise the contract's `alloc=` budget")


def render_report(report: dict) -> str:
    """The ranked vectorization-blockers report ``--report`` prints."""
    lines = [
        f"hot-path report: roots {', '.join(report['roots']) or '(none)'}"
        f" — closure of {report['closure_size']} function(s), "
        f"{len(report['blockers'])} with blockers "
        f"(alloc budget {report['alloc_budget']}/call)"]
    for i, e in enumerate(report["blockers"], start=1):
        parts = []
        if e["locks"]:
            parts.append("locks: " + ", ".join(e["locks"]))
        if e["io"]:
            parts.append("io: " + ", ".join(e["io"]))
        if e["allocs"]:
            parts.append(f"allocs: {e['allocs']}")
        lines.append(f"{i:3d}. {e['function']} ({e['path']}:{e['line']}) "
                     f"depth {e['depth']} — {'; '.join(parts)}")
    if not report["blockers"]:
        lines.append("  (clean: the closure is vectorization-ready)")
    return "\n".join(lines)
