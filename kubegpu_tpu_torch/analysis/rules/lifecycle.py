"""Resource-lifecycle: ``acquired -> released`` on all paths.

The streaming transport brought the package its densest collection of
OS-level resources yet — sockets, pump/writer threads, subscriber
registrations, WAL file handles — and every future controller (defrag
rebalancer, autoscaler) adds more. This rule is the typestate that
keeps them honest: a resource acquired in a function must be released,
handed off, or daemon-exempt on **every** path out of it, exception
edges included, using the same CFG/obligation engine as charge-pairing
(:mod:`kubegpu_tpu_torch.analysis.dataflow`).

Tracked resource kinds and their release obligations:

===============  =======================================  ==============
kind             acquired by                              released by
===============  =======================================  ==============
socket           ``socket.socket`` /                      ``.close()`` /
                 ``socket.create_connection``             ``.detach()``
thread           ``threading.Thread(...)`` then           ``.join()``
                 ``.start()`` (``daemon=True`` exempt)
file             ``open(...)`` / ``os.fdopen(...)``       ``.close()``
subscriber       ``*.add_stream_subscriber(...)``         ``.stop()``
lease loop       ``Elector``/``ShardCoordinator``         ``.stop()`` /
                 then ``.start()``                        ``.release()``
===============  =======================================  ==============

**Escapes discharge the obligation.** Passing the resource to any call
(``self._conns.add(conn)``, ``remove_stream_subscriber(sub)``,
``cls(sock)``), storing it (``self._fh = fh``, ``y = x``, a container
literal), returning or yielding it — all transfer ownership somewhere
this function-local analysis cannot see, and the rule goes silent
rather than noisy. ``with`` context managers are release-on-exit by
construction and never tracked. A bound name that escapes anywhere
*before* a thread/elector ``.start()`` gate is owned elsewhere and not
tracked either.

Path semantics mirror charge-pairing's contract: normal exits and
explicit ``raise`` exits are checked; each ``except`` handler covering
the acquisition must release on its own paths; implicit propagation
out of the function is the interpreter/GC backstop and is not flagged;
loops use may-iterate semantics with the canonical-cleanup refinement.
Deliberate leaks carry ``# analysis: disable=resource-lifecycle`` with
a justification the suppression audit keeps honest.

The port's copy of ``kubegpu_tpu/analysis/rules/lifecycle.py``.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Iterator, List, Optional, Tuple

from kubegpu_tpu_torch.analysis.dataflow import (ControlFlowGraph, Node, build_cfg,
                                           may_leak)
from kubegpu_tpu_torch.analysis.engine import (Context, Finding, SourceFile,
                                         dotted_name)


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    kind: str
    # fully-dotted constructor names (matched against the call's dotted
    # name, or its last component for bare/attribute calls)
    ctors: frozenset
    releases: frozenset        # receiver methods that discharge
    what: str                  # human phrase for findings
    gate: Optional[str] = None  # obligation starts at x.<gate>() if set
    daemon_kwarg: Optional[str] = None  # ctor kwarg that exempts


SPECS: Tuple[ResourceSpec, ...] = (
    ResourceSpec("socket",
                 frozenset({"socket.socket", "socket.create_connection"}),
                 frozenset({"close", "detach"}),
                 "socket is never closed"),
    ResourceSpec("thread",
                 frozenset({"threading.Thread", "Thread"}),
                 frozenset({"join"}),
                 "non-daemon thread is started but never joined",
                 gate="start", daemon_kwarg="daemon"),
    ResourceSpec("file",
                 frozenset({"open", "os.fdopen", "io.open"}),
                 frozenset({"close"}),
                 "file handle is never closed"),
    ResourceSpec("subscriber",
                 frozenset({"add_stream_subscriber"}),
                 frozenset({"stop"}),
                 "stream subscriber is registered but never severed"),
    ResourceSpec("lease loop",
                 frozenset({"Elector", "ShardCoordinator"}),
                 frozenset({"stop", "release"}),
                 "lease/election loop is started but never stopped",
                 gate="start"),
)


def _ctor_spec(call: ast.AST) -> Optional[ResourceSpec]:
    """The spec whose constructor this call invokes, if any."""
    if not isinstance(call, ast.Call):
        return None
    dotted = dotted_name(call.func)
    last = None
    if isinstance(call.func, ast.Attribute):
        last = call.func.attr
    elif isinstance(call.func, ast.Name):
        last = call.func.id
    for spec in SPECS:
        for ctor in spec.ctors:
            if dotted == ctor:
                return spec
            if "." not in ctor and last == ctor and \
                    (dotted is None or dotted == ctor or
                     dotted.endswith("." + ctor)):
                return spec
            if "." in ctor and dotted is not None and \
                    dotted.endswith("." + ctor):
                return spec
    return None


def _is_daemon_exempt(call: ast.Call, spec: ResourceSpec) -> bool:
    if spec.daemon_kwarg is None:
        return False
    for kw in call.keywords:
        if kw.arg == spec.daemon_kwarg:
            # daemon=True (or any non-constant expression: give the
            # benefit of the doubt — err toward silence)
            if isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
            return True
    return False


@dataclasses.dataclass
class _Binding:
    """One ``x = <ctor>(...)`` the rule tracks through the function."""

    name: str
    spec: ResourceSpec
    acquire_stmt: ast.stmt   # the binding statement
    site_stmt: ast.stmt      # where the obligation starts (gate or bind)


class _NameUse:
    """Classification of one occurrence of the tracked name."""

    READ = "read"        # receiver/test/interpolation use: still held
    RELEASE = "release"  # x.close()/x.join()/... discharges
    ESCAPE = "escape"    # ownership left this function's hands
    EXEMPT = "exempt"    # x.daemon = True before start


def _classify_uses(root: ast.AST, name: str,
                   spec: ResourceSpec) -> List[str]:
    """Every occurrence of ``name`` under ``root``, classified. Parent
    chains decide: a receiver use (``x.sendall(...)``), a guard
    (``if x is None``), or an f-string repr keeps holding the
    resource; appearing as a call argument, in a container literal, as
    an assignment's value, or in a ``return``/``yield`` escapes it."""
    parents: dict = {}
    for node in ast.walk(root):
        for child in ast.iter_child_nodes(node):
            parents[id(child)] = node
    out: List[str] = []
    for node in ast.walk(root):
        if not (isinstance(node, ast.Name) and node.id == name):
            continue
        out.append(_classify_one(node, parents, spec))
    return out


def _classify_one(node: ast.AST, parents: dict,
                  spec: ResourceSpec) -> str:
    parent = parents.get(id(node))
    if isinstance(parent, ast.Attribute) and parent.value is node:
        grand = parents.get(id(parent))
        # x.<release>() discharges; x.daemon = True exempts a thread
        if isinstance(grand, ast.Call) and grand.func is parent:
            if parent.attr in spec.releases:
                return _NameUse.RELEASE
            return _NameUse.READ  # x.sendall(...), x.fileno(), ...
        if spec.daemon_kwarg is not None and \
                parent.attr == spec.daemon_kwarg and \
                isinstance(grand, ast.Assign) and parent in grand.targets:
            return _NameUse.EXEMPT
        return _NameUse.READ  # attribute read, or x.attr = v mutation
    if isinstance(parent, ast.Subscript) and parent.value is node:
        return _NameUse.READ  # x[i]
    if isinstance(parent, (ast.Compare, ast.BoolOp, ast.UnaryOp,
                           ast.FormattedValue, ast.JoinedStr)):
        return _NameUse.READ  # guards and reprs hold, not leak
    if isinstance(parent, ast.Assign) and node in parent.targets:
        return _NameUse.RELEASE  # rebinding drops our tracking
    if isinstance(parent, ast.withitem):
        return _NameUse.RELEASE  # context manager releases on exit
    if isinstance(parent, ast.Delete):
        return _NameUse.RELEASE
    if isinstance(parent, (ast.If, ast.While)) and \
            getattr(parent, "test", None) is node:
        return _NameUse.READ
    # call argument, container element, assignment value, return/yield
    # value, comprehension, starred, await... — ownership moved on
    return _NameUse.ESCAPE


class ResourceLifecycle:
    """Sockets, threads, file handles, stream subscribers, and lease
    loops acquired by a function must be released (or handed off) on
    every path out of it — exception edges included."""

    name = "resource-lifecycle"
    description = ("package-created sockets/threads/files/stream "
                   "subscribers/lease loops must reach their release "
                   "(close/join/stop) on all paths, exception edges "
                   "included; hand-offs and daemon threads are exempt")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield from self._check_function(src, node)

    # -- per-function analysis ------------------------------------------------

    def _check_function(self, src: SourceFile,
                        fn: ast.AST) -> Iterator[Finding]:
        bindings = self._collect_bindings(fn)
        dropped = self._dropped_acquires(fn)
        if not bindings and not dropped:
            return
        cfg = build_cfg(fn)
        for stmt, spec in dropped:
            yield Finding(
                self.name, src.path, stmt.lineno,
                f"{spec.what}: the {spec.kind} is acquired and its only "
                f"reference immediately dropped — bind it and release "
                f"it, or hand it off")
        for binding in bindings:
            yield from self._check_binding(src, fn, cfg, binding)

    def _collect_bindings(self, fn: ast.AST) -> List[_Binding]:
        """``x = <ctor>(...)`` statements directly in this function
        (nested defs are their own unit), with gated kinds anchored at
        their ``x.start()`` statement."""
        out: List[_Binding] = []
        for stmt in self._own_statements(fn):
            if not isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                continue
            value = stmt.value
            if value is None:
                continue
            targets = stmt.targets if isinstance(stmt, ast.Assign) \
                else [stmt.target]
            if len(targets) != 1 or not isinstance(targets[0], ast.Name):
                continue  # attribute/tuple targets escape immediately
            spec = _ctor_spec(value)
            if spec is None:
                continue
            assert isinstance(value, ast.Call)
            if _is_daemon_exempt(value, spec):
                continue
            name = targets[0].id
            site = stmt
            if spec.gate is not None:
                site_or_none = self._gate_stmt(fn, stmt, name, spec)
                if site_or_none is None:
                    continue  # never started, or owned elsewhere first
                site = site_or_none
            out.append(_Binding(name, spec, stmt, site))
        return out

    def _own_statements(self, fn: ast.AST) -> Iterator[ast.stmt]:
        """Every statement in this function, not descending into
        nested function/class definitions."""
        work: List[ast.stmt] = list(getattr(fn, "body", []))
        while work:
            stmt = work.pop()
            yield stmt
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    work.append(child)
                else:
                    work.extend(c for c in ast.iter_child_nodes(child)
                                if isinstance(c, ast.stmt))
        return

    def _gate_stmt(self, fn: ast.AST, bind_stmt: ast.stmt, name: str,
                   spec: ResourceSpec) -> Optional[ast.stmt]:
        """The ``x.start()`` statement that opens a gated obligation,
        or None when the resource never starts here — or escapes (or
        is daemon-exempted) before starting, i.e. is owned elsewhere."""
        gate: Optional[ast.stmt] = None
        for stmt in self._simple_statements(fn):
            if stmt is bind_stmt:
                continue
            for sub in ast.walk(stmt):
                if isinstance(sub, ast.Call) and \
                        isinstance(sub.func, ast.Attribute) and \
                        sub.func.attr == spec.gate and \
                        isinstance(sub.func.value, ast.Name) and \
                        sub.func.value.id == name:
                    if gate is None or stmt.lineno < gate.lineno:
                        gate = stmt
        if gate is None:
            return None
        for stmt in self._simple_statements(fn):
            if stmt is bind_stmt or stmt.lineno >= gate.lineno:
                continue
            uses = _classify_uses(stmt, name, spec)
            if _NameUse.EXEMPT in uses:
                return None
            if _NameUse.ESCAPE in uses or _NameUse.RELEASE in uses:
                return None  # stored/handed off before start
        return gate

    def _simple_statements(self, fn: ast.AST) -> Iterator[ast.stmt]:
        """Non-compound statements only: a compound statement's header
        must not soak up matches that belong to its nested children
        (which this walk yields in their own right)."""
        for stmt in self._own_statements(fn):
            if not isinstance(stmt, (ast.If, ast.For, ast.AsyncFor,
                                     ast.While, ast.Try, ast.With,
                                     ast.AsyncWith)):
                yield stmt

    def _dropped_acquires(self, fn: ast.AST) \
            -> List[Tuple[ast.stmt, ResourceSpec]]:
        """Bare ``Expr`` statements that acquire and drop the result:
        ``socket.create_connection(...)`` on its own line, or a
        ``Thread(...).start()`` chain without ``daemon=True``."""
        out: List[Tuple[ast.stmt, ResourceSpec]] = []
        for stmt in self._own_statements(fn):
            if not isinstance(stmt, ast.Expr):
                continue
            value = stmt.value
            spec = _ctor_spec(value)
            if spec is not None and spec.gate is None:
                assert isinstance(value, ast.Call)
                if not _is_daemon_exempt(value, spec):
                    out.append((stmt, spec))
                continue
            # Thread(...).start() / Elector(...).start() chains
            if isinstance(value, ast.Call) and \
                    isinstance(value.func, ast.Attribute):
                inner = value.func.value
                spec = _ctor_spec(inner)
                if spec is not None and spec.gate == value.func.attr:
                    assert isinstance(inner, ast.Call)
                    if not _is_daemon_exempt(inner, spec):
                        out.append((stmt, spec))
        return out

    def _check_binding(self, src: SourceFile, fn: ast.AST,
                       cfg: ControlFlowGraph,
                       binding: _Binding) -> Iterator[Finding]:
        site = cfg.node_for(binding.site_stmt)
        if site is None:
            return  # e.g. statically unreachable code

        def releases(node: Node) -> bool:
            # A None-guarded cleanup — `if sub is not None:
            # remove(sub)` — is credited at the guard: on the branch
            # that skips the body the resource was never acquired (the
            # guard exists precisely to encode that), so a plain join
            # would manufacture a phantom leak.
            if isinstance(node.stmt, ast.If) and \
                    binding.name in {n.id for n in ast.walk(node.stmt.test)
                                     if isinstance(n, ast.Name)}:
                for body_stmt in node.stmt.body:
                    uses = _classify_uses(body_stmt, binding.name,
                                          binding.spec)
                    if _NameUse.RELEASE in uses or _NameUse.ESCAPE in uses:
                        return True
            for sub in node.effect_asts():
                uses = _classify_uses(sub, binding.name, binding.spec)
                if _NameUse.RELEASE in uses or _NameUse.ESCAPE in uses \
                        or _NameUse.EXEMPT in uses:
                    return True
                if isinstance(sub, (ast.Assign, ast.AnnAssign)):
                    # re-binding x (even to another acquire) drops this
                    # obligation; the new acquire is its own site
                    targets = sub.targets if isinstance(sub, ast.Assign) \
                        else [sub.target]
                    for t in targets:
                        if isinstance(t, ast.Name) and \
                                t.id == binding.name:
                            return True
            return False

        site_releases = False
        if binding.site_stmt is not binding.acquire_stmt:
            # the gate statement itself may hand off (rare)
            uses = _classify_uses(binding.site_stmt, binding.name,
                                  binding.spec)
            site_releases = _NameUse.ESCAPE in uses
        # site_raise_holds=False: if `x = open(...)` raises, nothing
        # was bound, so a handler covering only the acquisition itself
        # owes no release
        report = may_leak(cfg, site, releases, site_releases=site_releases,
                          site_raise_holds=False)
        spec = binding.spec
        line = binding.site_stmt.lineno
        if report.normal:
            yield Finding(
                self.name, src.path, line,
                f"{spec.what}: a path from here to function exit "
                f"reaches no {'/'.join(sorted(spec.releases))} of "
                f"`{binding.name}` and never hands it off")
        for handler in report.handlers:
            yield Finding(
                self.name, src.path, handler.lineno,
                f"exception edge leaks the {spec.kind}: this handler "
                f"covers the acquisition of `{binding.name}` but no "
                f"path through it releases or hands it off")
