"""Lock rules: static race detection and no-blocking-under-lock.

Both rules share one region analysis: for every class that owns a
``threading.Lock``/``RLock``/``Condition`` attribute, each method body is
walked with the set of *held* lock attributes tracked through ``with
self._lock:`` blocks. Code inside a nested function definition is treated
as NOT holding the enclosing ``with``'s lock — in this codebase nested
functions are thread targets and callbacks, which run long after the
``with`` block exited.

Convention: a method whose name ends in ``_locked`` asserts "only called
with the lock held" and is exempt from the discipline check (the repo
already uses this convention, e.g. ``SharedShapeCache._remove_shape_locked``).

The port's copy of ``kubegpu_tpu/analysis/rules/locks.py``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterable, Iterator

from kubegpu_tpu_torch.analysis.engine import (Context, Finding, SourceFile,
                                         dotted_name)

LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})

# Method calls that mutate the receiver: `self.attr.append(...)` is a
# write to the state behind `self.attr` even though the attribute slot
# itself is only read.
MUTATORS = frozenset({
    "add", "append", "clear", "difference_update", "discard", "extend",
    "insert", "intersection_update", "pop", "popitem", "remove", "reverse",
    "setdefault", "sort", "symmetric_difference_update", "update",
})

# Callables that block (sleep, process spawn, network round trips) and
# must never run while a lock is held: every other thread that touches
# the lock stalls for the full wait.
BLOCKING_CALLS = {
    ("time", "sleep"): "time.sleep",
    ("subprocess", "run"): "subprocess.run",
    ("subprocess", "call"): "subprocess.call",
    ("subprocess", "check_call"): "subprocess.check_call",
    ("subprocess", "check_output"): "subprocess.check_output",
    ("subprocess", "Popen"): "subprocess.Popen",
    ("socket", "create_connection"): "socket.create_connection",
    ("urllib.request", "urlopen"): "urllib.request.urlopen",
    ("requests", "get"): "requests.get",
    ("requests", "post"): "requests.post",
    ("requests", "put"): "requests.put",
    ("requests", "delete"): "requests.delete",
    ("requests", "request"): "requests.request",
}


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> ``"X"``, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in LOCK_FACTORIES and \
            isinstance(func.value, ast.Name) and func.value.id == "threading":
        return True
    return isinstance(func, ast.Name) and func.id in LOCK_FACTORIES


@dataclasses.dataclass(frozen=True)
class Access:
    attr: str
    line: int
    write: bool
    held: frozenset
    method: str
    in_init: bool


@dataclasses.dataclass(frozen=True)
class BlockingCall:
    line: int
    held: frozenset
    what: str
    method: str


@dataclasses.dataclass(frozen=True)
class SelfCall:
    """``self.X(...)`` — an intra-class call edge, with the lock set held
    at the call site. The transitive rules walk these."""

    callee: str
    line: int
    held: frozenset
    method: str


class _ClassLockInfo:
    """Per-class result of the region walk."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.lock_attrs: set = set()
        self.accesses: list = []
        self.blocking: list = []
        self.self_calls: list = []
        self.methods: set = set()


def _lock_attrs_of(cls: ast.ClassDef) -> set:
    attrs: set = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for target in node.targets:
                attr = _self_attr(target)
                if attr is not None:
                    attrs.add(attr)
    return attrs


class _RegionWalker:
    """Walks one method body tracking the held-lock set."""

    def __init__(self, info: _ClassLockInfo, method: str,
                 in_init: bool) -> None:
        self.info = info
        self.method = method
        self.in_init = in_init

    # -- access recording ----------------------------------------------------

    def _record(self, attr: str, line: int, write: bool,
                held: frozenset) -> None:
        if attr in self.info.lock_attrs:
            return
        self.info.accesses.append(Access(
            attr, line, write, held, self.method, self.in_init))

    def _record_target(self, target: ast.AST, held: frozenset) -> None:
        """Assignment/deletion target: the attribute slot or the container
        one subscript below it is written."""
        attr = _self_attr(target)
        if attr is not None:
            self._record(attr, target.lineno, True, held)
            return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            inner = _self_attr(target.value)
            if inner is not None:
                self._record(inner, target.lineno, True, held)
                return
            self.walk(target.value, held)
            if isinstance(target, ast.Subscript):
                self.walk(target.slice, held)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, held)
        elif isinstance(target, ast.Starred):
            self._record_target(target.value, held)

    # -- the walk ------------------------------------------------------------

    def walk(self, node: ast.AST, held: frozenset) -> None:
        method = getattr(self, "_walk_" + type(node).__name__, None)
        if method is not None:
            method(node, held)
            return
        attr = _self_attr(node)
        if attr is not None:
            self._record(attr, node.lineno, False, held)
            return
        for child in ast.iter_child_nodes(node):
            self.walk(child, held)

    def walk_body(self, body: Iterable[ast.AST], held: frozenset) -> None:
        for stmt in body:
            self.walk(stmt, held)

    def _walk_With(self, node: ast.With, held: frozenset) -> None:
        acquired = set()
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr is not None and attr in self.info.lock_attrs:
                acquired.add(attr)
            else:
                self.walk(item.context_expr, held)
            if item.optional_vars is not None:
                self.walk(item.optional_vars, held)
        self.walk_body(node.body, held | frozenset(acquired))

    def _walk_Assign(self, node: ast.Assign, held: frozenset) -> None:
        for target in node.targets:
            self._record_target(target, held)
        self.walk(node.value, held)

    def _walk_AnnAssign(self, node: ast.AnnAssign, held: frozenset) -> None:
        self._record_target(node.target, held)
        if node.value is not None:
            self.walk(node.value, held)

    def _walk_AugAssign(self, node: ast.AugAssign, held: frozenset) -> None:
        self._record_target(node.target, held)
        self.walk(node.value, held)

    def _walk_Delete(self, node: ast.Delete, held: frozenset) -> None:
        for target in node.targets:
            self._record_target(target, held)

    def _walk_Call(self, node: ast.Call, held: frozenset) -> None:
        func = node.func
        if isinstance(func, ast.Attribute):
            if isinstance(func.value, ast.Name) and func.value.id == "self":
                # self.X(...): an intra-class call edge (resolved against
                # the class's real methods by the consuming rule)
                self.info.self_calls.append(SelfCall(
                    func.attr, node.lineno, held, self.method))
            recv_attr = _self_attr(func.value)
            if recv_attr is not None and func.attr in MUTATORS:
                # self.attr.mutator(...): a write to the guarded container
                self._record(recv_attr, node.lineno, True, held)
            else:
                self.walk(func, held)
            self._check_blocking(node, held)
        else:
            self.walk(func, held)
        for arg in node.args:
            self.walk(arg, held)
        for kw in node.keywords:
            self.walk(kw.value, held)

    def _walk_FunctionDef(self, node: ast.AST, held: frozenset) -> None:
        # a nested def runs later, on some other thread's schedule: it
        # does NOT inherit the lexically-enclosing held set
        self.walk_body(node.body, frozenset())

    _walk_AsyncFunctionDef = _walk_FunctionDef

    def _walk_Lambda(self, node: ast.Lambda, held: frozenset) -> None:
        self.walk(node.body, frozenset())

    # -- blocking-call detection ---------------------------------------------

    def _check_blocking(self, node: ast.Call, held: frozenset) -> None:
        # recorded even with no lock held locally: the transitive rule
        # checks helpers that run under a CALLER's lock
        dotted = dotted_name(node.func)
        if dotted is None:
            return
        for (mod, fn), label in BLOCKING_CALLS.items():
            if dotted == f"{mod}.{fn}" or \
                    dotted.endswith(f".{mod.split('.')[-1]}.{fn}"):
                self.info.blocking.append(BlockingCall(
                    node.lineno, held, label, self.method))
                return
        if dotted.endswith(".wait") and not any(
                dotted == f"self.{lock}.wait" for lock in held):
            # Event/other-lock waits stall every peer of the held lock;
            # Condition.wait on the HELD lock releases it and is fine.
            self.info.blocking.append(BlockingCall(
                node.lineno, held, f"{dotted}()", self.method))


def analyze_classes(src: SourceFile) -> Iterator[_ClassLockInfo]:
    """Region analysis for every lock-owning class in ``src``."""
    for node in ast.walk(src.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        lock_attrs = _lock_attrs_of(node)
        if not lock_attrs:
            continue
        info = _ClassLockInfo(node.name)
        info.lock_attrs = lock_attrs
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods.add(item.name)
                walker = _RegionWalker(info, item.name,
                                       in_init=item.name == "__init__")
                walker.walk_body(item.body, frozenset())
        yield info


class LockDiscipline:
    """Attributes written under a class's lock are *guarded*: every other
    read or write of them must hold the same lock. This is the static
    analogue of a race detector — an unlocked read of guarded state is a
    torn-read / stale-read hazard even when it "usually works"."""

    name = "lock-discipline"
    description = ("state written under `with self._lock` must never be "
                   "read or written without that lock")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            for info in analyze_classes(src):
                guarded: dict = {}
                for acc in info.accesses:
                    if acc.write and acc.held and not acc.in_init:
                        guarded.setdefault(acc.attr, set()).update(acc.held)
                for acc in info.accesses:
                    locks = guarded.get(acc.attr)
                    if locks is None or acc.in_init or \
                            acc.method.endswith("_locked"):
                        continue
                    if acc.held & locks:
                        continue
                    lock_names = ", ".join(
                        f"self.{name}" for name in sorted(locks))
                    verb = "written" if acc.write else "read"
                    yield Finding(
                        self.name, src.path, acc.line,
                        f"{info.name}.{acc.attr} is guarded by {lock_names} "
                        f"but {verb} in {acc.method}() without it; acquire "
                        f"the lock or rename the method `*_locked` if every "
                        f"caller already holds it")


class TransitiveLockDiscipline:
    """Call-graph-aware lock discipline, closing the one-hop blind spot
    of the two flat rules above:

    1. **``_locked`` contract enforcement** — a ``*_locked`` method
       asserts "caller holds the lock". A call site that holds no class
       lock, is not itself inside a ``*_locked`` method (or a helper
       only ever reached from locked contexts), and is not ``__init__``
       breaks that contract: the helper will mutate guarded state
       unlocked.
    2. **Transitive blocking-under-lock** — ``NoBlockingUnderLock``
       only sees blocking calls lexically inside a ``with self._lock``
       body. Here the under-lock region is propagated through same-class
       ``self.helper()`` edges (a helper invoked under the lock runs
       ENTIRELY under it, as does every ``*_locked`` method by
       contract), so a ``time.sleep`` or HTTP round trip hidden one or
       more hops down still flags.
    """

    name = "transitive-locks"
    description = ("`_locked` helpers must be called with the lock held, "
                   "and blocking calls are traced through helper calls "
                   "made under a lock")

    @staticmethod
    def _under_lock_closure(info: "_ClassLockInfo") -> set:
        """Methods whose bodies (sometimes) run with a class lock held:
        ``*_locked`` by contract, plus every method reachable through
        ``self.X()`` edges from a locked call site or a closure member.
        ``__init__`` never joins (single-threaded by construction)."""
        under: set = {m for m in info.methods
                      if m.endswith("_locked") and m != "__init__"}
        edges: dict = {}
        for call in info.self_calls:
            if call.callee not in info.methods or call.callee == "__init__":
                continue
            if call.held:
                under.add(call.callee)
            edges.setdefault(call.method, set()).add(call.callee)
        work = sorted(under)
        while work:
            m = work.pop()
            for callee in sorted(edges.get(m, ())):
                if callee not in under:
                    under.add(callee)
                    work.append(callee)
        return under

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            for info in analyze_classes(src):
                under = self._under_lock_closure(info)
                # 1. _locked helpers called without the lock, from a
                # method that itself never runs under it
                for call in info.self_calls:
                    if not call.callee.endswith("_locked") or \
                            call.callee not in info.methods:
                        continue
                    if call.held or call.method == "__init__" or \
                            call.method in under:
                        continue
                    yield Finding(
                        self.name, src.path, call.line,
                        f"{info.name}.{call.method}() calls "
                        f"{call.callee}() without holding a class lock; "
                        f"`*_locked` asserts the caller already holds it "
                        f"— acquire the lock or rename the helper")
                # 2. blocking calls inside methods that run under a lock
                # even when the local held set is empty (the one-hop
                # blind spot of no-blocking-under-lock)
                for call in info.blocking:
                    if call.held:
                        continue  # the flat rule already reports these
                    if call.method in under and call.method != "__init__":
                        yield Finding(
                            self.name, src.path, call.line,
                            f"{info.name}.{call.method}() runs under a "
                            f"class lock (reached via locked callers or "
                            f"the `_locked` contract) but calls "
                            f"{call.what}; move the blocking call out of "
                            f"the locked call chain")


class NoBlockingUnderLock:
    """No sleeps, subprocess spawns, HTTP round trips, or foreign waits
    inside a `with <lock>` body: the lock's other users stall for the
    whole wait, and a lock held across I/O is one retry policy away from
    a deadlock."""

    name = "no-blocking-under-lock"
    description = ("no time.sleep / subprocess / HTTP calls / foreign "
                   "`.wait()` inside a `with self._lock` body")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            for info in analyze_classes(src):
                for call in info.blocking:
                    if not call.held:
                        continue  # transitive-locks owns the helper case
                    locks = ", ".join(
                        f"self.{name}" for name in sorted(call.held))
                    yield Finding(
                        self.name, src.path, call.line,
                        f"{info.name}.{call.method}() calls {call.what} "
                        f"while holding {locks}; move the blocking call "
                        f"outside the locked region")
