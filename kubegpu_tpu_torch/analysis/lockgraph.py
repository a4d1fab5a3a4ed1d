"""Dynamic lock-order harness: record the acquisition graph, fail on
inversions.

The port's copy of ``kubegpu_tpu/analysis/lockgraph.py``, matching the
port's package exactly. The static lock-discipline rule proves
single-lock hygiene; it cannot see *ordering* between locks. This module
instruments the locks ``kubegpu_tpu_torch`` creates (opt-in, via
:func:`install`) and records a directed edge ``A -> B`` every time a
thread acquires lock B while holding lock A, keyed by the lock's
construction site (``file:line``) so every instance of the same lock
*role* shares a node. A cycle in that graph is a potential deadlock: two
threads interleaving the two edge directions can each end up waiting on
the other — the classic lock-order inversion.

Edges are recorded at acquisition *attempt* time, before blocking: an
actual deadlock must still leave its second edge in the graph.

``install()`` patches ``threading.Lock``/``RLock``/``Condition`` with
factories that instrument only locks constructed from a module of the
package (``kubegpu_tpu_torch`` itself or a ``kubegpu_tpu_torch.``
submodule, by the constructing frame's ``__name__``), so the JAX
package's locks, stdlib and third-party locks keep their native types
and cost. The uninstrumented primitives are ``_thread``'s own, whatever
another harness has patched into ``threading``, and ``uninstall()``
puts back what ``install()`` found. The pytest plugin
(:mod:`kubegpu_tpu_torch.analysis.pytest_plugin`) installs this for a
whole session and fails it if the global graph ends up cyclic.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
from typing import Iterator

PACKAGE = "kubegpu_tpu_torch"

_real_lock_factory = _thread.allocate_lock
_real_rlock_factory = _thread.RLock


def _native_condition() -> type:
    """``threading``'s own Condition, under any subclass another harness
    has installed in its place."""
    cls = threading.Condition
    while cls.__module__ != "threading":
        cls = cls.__mro__[1]
    return cls


_real_condition = _native_condition()

_held = threading.local()  # per-thread stack of site labels


def _held_stack() -> list:
    stack = getattr(_held, "stack", None)
    if stack is None:
        stack = _held.stack = []
    return stack


class LockGraph:
    """Thread-safe acquisition-order graph over lock construction sites."""

    def __init__(self) -> None:
        self._meta = _real_lock_factory()
        # (held_site, acquired_site) -> (thread name, full held stack)
        self.edges: dict = {}

    def record_acquire(self, site: str) -> None:
        stack = _held_stack()
        for held_site in stack:
            if held_site == site:
                continue  # RLock re-entry is not an ordering edge
            key = (held_site, site)
            if key in self.edges:  # GIL-safe membership fast path
                continue
            with self._meta:
                self.edges.setdefault(
                    key, (threading.current_thread().name, tuple(stack)))

    def cycles(self) -> list:
        """Site-label cycles in the edge graph (each reported once)."""
        adj: dict = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
        cycles: list = []
        seen_cycles: set = set()
        visiting: list = []
        on_path: set = set()
        done: set = set()

        def visit(node: str) -> None:
            visiting.append(node)
            on_path.add(node)
            for nxt in sorted(adj.get(node, ())):
                if nxt in on_path:
                    cycle = tuple(visiting[visiting.index(nxt):])
                    canon = frozenset(cycle)
                    if canon not in seen_cycles:
                        seen_cycles.add(canon)
                        cycles.append(list(cycle) + [nxt])
                elif nxt not in done:
                    visit(nxt)
            visiting.pop()
            on_path.discard(node)
            done.add(node)

        for node in sorted(adj):
            if node not in done:
                visit(node)
        return cycles

    def render_cycles(self) -> str:
        lines = []
        for cycle in self.cycles():
            lines.append("lock-order inversion: " + " -> ".join(cycle))
            for a, b in zip(cycle, cycle[1:]):
                thread, stack = self.edges[(a, b)]
                lines.append(f"    {a} -> {b}  (thread {thread}, "
                             f"held {list(stack)})")
        return "\n".join(lines)


GLOBAL_GRAPH = LockGraph()


def _site_label(depth: int) -> str:
    frame = sys._getframe(depth)
    path = frame.f_code.co_filename
    parts = path.replace(os.sep, "/").split("/")
    if PACKAGE in parts:
        path = "/".join(parts[parts.index(PACKAGE):])
    else:
        path = "/".join(parts[-2:])
    return f"{path}:{frame.f_lineno}"


class InstrumentedLock:
    """Wraps a real lock primitive; context-manager and acquire/release
    compatible, with held-stack bookkeeping and edge recording."""

    def __init__(self, inner: object, site: str,
                 graph: LockGraph | None = None) -> None:
        self._inner = inner
        self._site = site
        self._graph = graph if graph is not None else GLOBAL_GRAPH

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # record BEFORE blocking: a real deadlock never returns from here
        self._graph.record_acquire(self._site)
        got = self._inner.acquire(blocking, timeout)
        if got:
            _held_stack().append(self._site)
        return got

    def release(self) -> None:
        self._inner.release()
        stack = _held_stack()
        if self._site in stack:
            # remove the LAST occurrence (RLock depth / nesting order)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == self._site:
                    del stack[i]
                    break

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()

    # -- RLock protocol used by threading.Condition --------------------------

    def _is_owned(self) -> bool:
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return inner_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self) -> object:
        # mirror threading.Condition's own probe-and-fallback: delegate
        # to an RLock's full-release, or plain release() for a raw lock —
        # defining this unconditionally must not break plain-Lock inners
        inner_save = getattr(self._inner, "_release_save", None)
        if inner_save is None:
            self.release()
            return None
        state = inner_save()
        stack = _held_stack()
        while self._site in stack:
            stack.remove(self._site)
        return state

    def _acquire_restore(self, state: object) -> None:
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        if inner_restore is None:
            self.acquire()
            return
        self._graph.record_acquire(self._site)
        inner_restore(state)
        _held_stack().append(self._site)

    def __repr__(self) -> str:
        return f"<InstrumentedLock {self._site} wrapping {self._inner!r}>"


def _caller_module(depth: int) -> str:
    """Module __name__ of the frame ``depth`` levels above our caller."""
    return sys._getframe(depth + 1).f_globals.get("__name__", "")


def in_package(module_name: str) -> bool:
    """The package or one of its modules — never the JAX package, whose
    name is a prefix of this one's, nor a sibling sharing the prefix."""
    return module_name == PACKAGE or module_name.startswith(PACKAGE + ".")


_installed = False
_previous: tuple = ()  # what install() replaced: (Lock, RLock, Condition)


def _lock_factory() -> object:
    if in_package(_caller_module(1)):
        return InstrumentedLock(_real_lock_factory(), _site_label(2))
    return _real_lock_factory()


def _rlock_factory() -> object:
    if in_package(_caller_module(1)):
        return InstrumentedLock(_real_rlock_factory(), _site_label(2))
    return _real_rlock_factory()


class _PatchingCondition(_real_condition):
    """`threading.Condition` that, when created lock-less from package
    code, wires an instrumented RLock in as its lock — so condition use
    participates in the acquisition graph. Subclass (not factory): code
    holding a reference must still isinstance/subclass cleanly."""

    def __init__(self, lock: object = None) -> None:
        if lock is None and in_package(_caller_module(1)):
            lock = InstrumentedLock(_real_rlock_factory(), _site_label(2))
        super().__init__(lock)


def install() -> None:
    """Patch the threading lock factories. Idempotent."""
    global _installed, _previous
    if _installed:
        return
    _previous = (threading.Lock, threading.RLock, threading.Condition)
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _PatchingCondition
    _installed = True


def uninstall() -> None:
    """Put back the factories :func:`install` replaced."""
    global _installed
    if not _installed:
        return
    threading.Lock, threading.RLock, threading.Condition = _previous
    _installed = False


def installed() -> bool:
    return _installed


def iter_edges() -> Iterator[tuple]:
    return iter(GLOBAL_GRAPH.edges)
