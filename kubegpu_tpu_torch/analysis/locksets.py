"""Lockset model: thread roots, held-lock dataflow, guarded-by bindings.

The RacerD-style static race detector (``rules/racer.py``) and the
hot-path purity budget share one whole-repo model built here:

* **Thread-root discovery** — every place the package hands a function
  to another thread becomes a *concurrency root*: ``threading.Thread(
  target=...)`` spawn sites, executor/pool ``submit``/``map`` hand-offs
  (including the scheduler's ``_parallel_map`` fan-out wrapper, whose
  lambda argument runs on the 16-worker fit pool), and the ``main``
  entry function of each ``cmd/`` binary (the process's main thread is
  a root like any other). Pool hand-offs and spawns lexically inside a
  loop are *self-racing* (multiplicity 2): the same code runs on two
  threads at once even though it is one root.

* **Lockset dataflow** — a flow-sensitive walk of every function body
  tracking the set of locks *held*: ``with self._lock:`` bodies,
  explicit ``.acquire()``/``.release()`` at statement level (a
  conditional acquire inside one ``if`` arm does NOT survive the branch
  join — locksets join by intersection, the classic Eraser rule), and
  ``with``-statement module-level locks. Every ``self.<field>`` /
  module-global read and write site is recorded with the lockset held
  there.

* **Interprocedural entry locksets** — a helper's body runs under the
  locks every caller holds at the call site: ``entry(f) = ∩ over call
  sites (held at site ∪ entry(caller))``, the call-graph closure idea
  turned into a meet-over-call-sites fixpoint. A lock handed through a helper
  (``with self._lock: self._bump()``) therefore guards the helper's
  writes, and a ``*_locked`` method with no visible caller falls back
  to its class's single lock (the naming contract transitive-locks
  already enforces). Thread spawns are NOT call edges: a thread target
  starts with the empty lockset no matter what its spawner held.

* **Guarded-by conventions** — ``# guarded-by: self._lock`` on a
  field's write/init line asserts the field is protected by that lock
  even where the analysis cannot see it (protection by protocol:
  join-before-read hand-offs, external serialization); ``# racer:
  single-writer`` asserts exactly one thread ever writes it. Both bind
  per *field*, suppress the race report for it, and are themselves
  checked — a guarded-by naming a lock the owner does not define is a
  finding, not a silencer.

Name resolution is the package's usual over-approximation: ``self.m()``
resolves within the class when the class defines ``m``, anything else
by bare name against every same-named function in the scanned tree.
For *reachability* that errs toward more roots (more potential races —
the annotations exist for the survivors); for *entry locksets* the
meet makes extra call sites err toward fewer held locks, which also
errs toward reporting, never toward silence.

The port's copy of ``kubegpu_tpu/analysis/locksets.py``.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, \
    Set, Tuple

from kubegpu_tpu_torch.analysis.engine import SourceFile, dotted_name

LOCK_FACTORIES = frozenset({"Lock", "RLock", "Condition"})

# Container-method calls that mutate the receiver (shared with the flat
# lock-discipline rule's notion of a write).
MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "difference_update", "discard",
    "extend", "insert", "intersection_update", "pop", "popitem", "popleft",
    "remove", "reverse", "setdefault", "sort", "symmetric_difference_update",
    "update",
})

# `# guarded-by: self._lock` / `# racer: single-writer -- justification`
GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*(?P<lock>[A-Za-z0-9_.]+)")
SINGLE_WRITER_RE = re.compile(r"#\s*racer:\s*single-writer")

# Receivers whose .submit/.map hand work to a pool; jax.tree.map and
# plain-container .map/.update lookalikes must not spawn phantom roots.
_POOL_RECEIVER_HINTS = ("pool", "executor", "binder", "workers")
# Wrapper methods whose callable argument runs on a worker pool.
_SPAWN_WRAPPERS = frozenset({"_parallel_map"})


@dataclasses.dataclass(frozen=True)
class Root:
    """One discovered concurrency root: ``target`` is the qualname of
    the function that runs on its own thread; ``multiplicity`` is 2 for
    self-racing spawns (pool hand-offs, spawns inside a loop)."""

    target: str
    kind: str            # "thread" | "pool" | "entry"
    path: str
    line: int
    multiplicity: int


@dataclasses.dataclass(frozen=True)
class FieldKey:
    """Identity of a shared field: a class attribute (``owner`` is the
    class name) or a module global (``owner`` is ``<path>``)."""

    owner: str
    attr: str

    def render(self) -> str:
        return f"{self.owner}.{self.attr}"


@dataclasses.dataclass(frozen=True)
class Access:
    field: FieldKey
    path: str
    line: int
    write: bool
    held: FrozenSet[str]   # locally held lock tokens at the site
    func: str              # qualname of the containing function


@dataclasses.dataclass(frozen=True)
class CallSite:
    caller: str
    callee: str            # "Class.method" when resolved, else bare name
    held: FrozenSet[str]


@dataclasses.dataclass(frozen=True)
class Acquisition:
    """One lock acquisition site (``with`` or ``.acquire()``) — what the
    hot-path purity rule reports as a vectorization blocker."""

    func: str
    token: str
    path: str
    line: int


@dataclasses.dataclass(frozen=True)
class GuardNote:
    """A field-level ``# guarded-by:`` / ``# racer: single-writer``
    binding."""

    kind: str              # "guarded-by" | "single-writer"
    lock: Optional[str]
    path: str
    line: int


@dataclasses.dataclass
class FunctionRec:
    qualname: str
    name: str
    class_name: Optional[str]
    path: str
    lineno: int
    node: ast.AST


class LocksetModel:
    """The whole-repo model. Build with :func:`build_model`; query
    ``entry_locks`` / :meth:`effective_locks` / :meth:`roots_reaching`.
    """

    def __init__(self) -> None:
        self.functions: Dict[str, FunctionRec] = {}
        self.by_name: Dict[str, List[str]] = {}     # bare -> [qualnames]
        self.class_locks: Dict[str, Set[str]] = {}  # class -> lock attrs
        self.module_locks: Dict[str, Set[str]] = {}  # path -> lock names
        self.accesses: List[Access] = []
        self.calls: List[CallSite] = []
        self.acquisitions: List[Acquisition] = []
        self.roots: List[Root] = []
        self.guards: Dict[FieldKey, GuardNote] = {}
        self.site_notes: Dict[Tuple[str, int], GuardNote] = {}
        self.entry_locks: Dict[str, FrozenSet[str]] = {}
        # racer: single-writer -- lazily-memoized by the one analysis
        # thread that owns the model
        self._reach: Optional[Dict[str, Set[str]]] = None
        self._root_mult: Dict[str, int] = {}

    # -- queries -------------------------------------------------------------

    def effective_locks(self, access: Access) -> FrozenSet[str]:
        """Locks held at the site: locally held ∪ caller-guaranteed."""
        return access.held | self.entry_locks.get(access.func, frozenset())

    def root_multiplicity(self, target: str) -> int:
        return self._root_mult.get(target, 1)

    def roots_reaching(self) -> Dict[str, Set[str]]:
        """qualname -> set of root *targets* whose forward call-graph
        closure contains it (a function two roots can run concurrently
        executes on two threads)."""
        if self._reach is not None:
            return self._reach
        succs: Dict[str, Set[str]] = {}
        for call in self.calls:
            succs.setdefault(call.caller, set()).add(call.callee)
        reach: Dict[str, Set[str]] = {}
        for root in self.roots:
            seen: Set[str] = set()
            work = [root.target]
            while work:
                qual = work.pop()
                if qual in seen:
                    continue
                seen.add(qual)
                reach.setdefault(qual, set()).add(root.target)
                for callee in succs.get(qual, ()):
                    for resolved in self._resolve(callee):
                        if resolved not in seen:
                            work.append(resolved)
        self._reach = reach
        return reach

    def _resolve(self, callee: str) -> List[str]:
        if callee in self.functions:
            return [callee]
        return self.by_name.get(callee, [])


# ---- the per-function walk --------------------------------------------------


class _FunctionWalker:
    """Flow-sensitive held-lock walk of one function body. ``held``
    flows through statements; branches join by intersection; records
    accesses, call sites, and acquisitions into the model."""

    def __init__(self, model: LocksetModel, src: SourceFile,
                 rec: FunctionRec, module_level: Set[str],
                 annotations: Dict[int, GuardNote]) -> None:
        self.model = model
        self.src = src
        self.rec = rec
        self.module_level = module_level  # module-scope mutable names
        self.annotations = annotations
        # racer: single-writer -- walker instances are per-function scratch
        self.globals_declared: Set[str] = set()

    # -- lock token helpers ---------------------------------------------------

    def _lock_token(self, node: ast.AST) -> Optional[str]:
        """``self._lock`` / module-level ``_lock`` -> its token, when it
        is a known lock of the enclosing class or module."""
        dotted = dotted_name(node)
        if dotted is None:
            return None
        if dotted.startswith("self.") and self.rec.class_name is not None:
            attr = dotted.split(".", 1)[1]
            if attr in self.model.class_locks.get(self.rec.class_name, ()):
                return f"self.{attr}"
        elif "." not in dotted and \
                dotted in self.model.module_locks.get(self.src.path, ()):
            return f"<module>.{dotted}"
        return None

    # -- access recording -----------------------------------------------------

    def _field(self, node: ast.AST) -> Optional[FieldKey]:
        if isinstance(node, ast.Attribute) and \
                isinstance(node.value, ast.Name) and \
                node.value.id == "self" and self.rec.class_name is not None:
            return FieldKey(self.rec.class_name, node.attr)
        if isinstance(node, ast.Name) and (
                node.id in self.globals_declared
                or (node.id in self.module_level
                    and isinstance(node.ctx, ast.Load))):
            return FieldKey(f"<{self.src.path}>", node.id)
        return None

    def _record(self, node: ast.AST, write: bool,
                held: FrozenSet[str]) -> None:
        field = self._field(node)
        if field is None:
            return
        if self._lock_token(node) is not None:
            return  # the lock itself is not guarded state
        line = getattr(node, "lineno", self.rec.lineno)
        self.model.accesses.append(Access(
            field, self.src.path, line, write, held, self.rec.qualname))
        # a note binds via a trailing comment on the write line or a
        # comment block directly above it (block propagation registers
        # the note on the first code line after it — and ONLY that line,
        # so one note cannot bleed onto the next field down)
        note = self.annotations.get(line)
        if note is not None and write:
            self.model.guards.setdefault(field, note)

    def _record_target(self, target: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(target, (ast.Attribute, ast.Name)):
            if self._field(target) is not None or \
                    isinstance(target, ast.Name):
                self._record(target, True, held)
                return
        if isinstance(target, (ast.Subscript, ast.Attribute)):
            # self.X[k] = v / G[k] = v: the container behind X is written
            inner = target.value
            if self._field(inner) is not None:
                self._record(inner, True, held)
            else:
                self.expr(inner, held)
            if isinstance(target, ast.Subscript):
                self.expr(target.slice, held)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._record_target(elt, held)
        elif isinstance(target, ast.Starred):
            self._record_target(target.value, held)

    # -- expressions ----------------------------------------------------------

    def expr(self, node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, ast.Call):
            self._call(node, held)
            return
        if isinstance(node, (ast.Lambda, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            # runs later on someone else's schedule: empty lockset, and
            # nested defs are separate functions registered by the scan
            if isinstance(node, ast.Lambda):
                self.expr(node.body, frozenset())
            return
        field = self._field(node)
        if field is not None:
            self._record(node, False, held)
            return
        for child in ast.iter_child_nodes(node):
            self.expr(child, held)

    def _call(self, node: ast.Call, held: FrozenSet[str]) -> None:
        func = node.func
        spawn_kind = _spawn_kind(node)
        if spawn_kind is not None:
            self._spawn(node, spawn_kind)
        if isinstance(func, ast.Attribute):
            recv = func.value
            if isinstance(recv, ast.Name) and recv.id == "self" and \
                    self.rec.class_name is not None:
                callee = f"{self.rec.class_name}.{func.attr}"
                if callee not in self.model.functions:
                    callee = func.attr
                self.model.calls.append(CallSite(
                    self.rec.qualname, callee, held))
            else:
                self.model.calls.append(CallSite(
                    self.rec.qualname, func.attr, held))
            field = self._field(recv)
            if field is not None and func.attr in MUTATORS:
                self._record(recv, True, held)
            else:
                self.expr(recv, held)
        elif isinstance(func, ast.Name):
            self.model.calls.append(CallSite(
                self.rec.qualname, func.id, held))
        else:
            self.expr(func, held)
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if spawn_kind is not None and _target_name(arg) is not None:
                continue  # a hand-off reference, not an evaluation
            self.expr(arg, held)

    def _spawn(self, node: ast.Call, kind: str) -> None:
        line = node.lineno
        pooled = kind == "pool"
        for arg in _spawn_targets(node):
            target = _target_name(arg)
            if target is None:
                continue
            for resolved in self._resolve_target(target):
                self.model.roots.append(Root(
                    resolved, kind, self.src.path, line,
                    2 if (pooled or self._in_loop) else 1))

    def _resolve_target(self, target: str) -> List[str]:
        """Spawn-target reference -> the concrete function qualnames it
        may name (every same-named function when ambiguous — each is a
        root *somewhere*, and over-approximating here errs toward
        checking more code, with the annotations as the escape hatch)."""
        if target.startswith("self."):
            attr = target.split(".", 1)[1]
            qual = f"{self.rec.class_name}.{attr}" \
                if self.rec.class_name else attr
            if qual in self.model.functions:
                return [qual]
            target = attr
        if target in self.model.functions:
            return [target]
        return list(self.model.by_name.get(target, []))

    # -- statements -----------------------------------------------------------

    _in_loop = False

    def stmts(self, body: Sequence[ast.stmt],
              held: FrozenSet[str]) -> Optional[FrozenSet[str]]:
        """Walk a statement list; returns the held set at fall-through,
        or None when the suffix cannot fall through (return/raise...)."""
        out: Optional[FrozenSet[str]] = held
        for stmt in body:
            if out is None:
                break
            out = self.stmt(stmt, out)
        return out

    def stmt(self, stmt: ast.stmt,
             held: FrozenSet[str]) -> Optional[FrozenSet[str]]:
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            acquired: Set[str] = set()
            for item in stmt.items:
                token = self._lock_token(item.context_expr)
                if token is not None:
                    acquired.add(token)
                    self.model.acquisitions.append(Acquisition(
                        self.rec.qualname, token, self.src.path,
                        item.context_expr.lineno))
                else:
                    self.expr(item.context_expr, held)
                if item.optional_vars is not None:
                    self._record_target(item.optional_vars, held)
            # a reentrant re-acquire (nested `with self._lock` on an
            # RLock) releases nothing on exit — only tokens this with
            # NEWLY acquired leave the held set
            newly = acquired - held
            inner = self.stmts(stmt.body, held | acquired)
            return None if inner is None else inner - newly
        if isinstance(stmt, ast.If):
            self.expr(stmt.test, held)
            then = self.stmts(stmt.body, held)
            orelse = self.stmts(stmt.orelse, held) if stmt.orelse else held
            if then is None:
                return orelse
            if orelse is None:
                return then
            return then & orelse
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self.expr(stmt.iter, held)
            self._record_target(stmt.target, held)
            return self._loop_body(stmt.body, stmt.orelse, held)
        if isinstance(stmt, ast.While):
            self.expr(stmt.test, held)
            return self._loop_body(stmt.body, stmt.orelse, held)
        if isinstance(stmt, ast.Try):
            body_out = self.stmts(stmt.body, held)
            if stmt.orelse and body_out is not None:
                body_out = self.stmts(stmt.orelse, body_out)
            handler_outs: List[Optional[FrozenSet[str]]] = []
            for handler in stmt.handlers:
                # an exception may fire anywhere in the body: the locks
                # certainly held in the handler are those held at entry
                handler_outs.append(self.stmts(handler.body, held))
            outs = [o for o in [body_out] + handler_outs if o is not None]
            merged: Optional[FrozenSet[str]] = None
            if outs:
                merged = outs[0]
                for o in outs[1:]:
                    merged = merged & o
            if stmt.finalbody:
                return self.stmts(stmt.finalbody,
                                  merged if merged is not None else held)
            return merged
        if isinstance(stmt, (ast.Return, ast.Raise)):
            if isinstance(stmt, ast.Return) and stmt.value is not None:
                self.expr(stmt.value, held)
            if isinstance(stmt, ast.Raise) and stmt.exc is not None:
                self.expr(stmt.exc, held)
            return None
        if isinstance(stmt, (ast.Break, ast.Continue)):
            return None
        if isinstance(stmt, ast.Global):
            self.globals_declared.update(stmt.names)
            return held
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return held  # separate unit; registered by the scan
        if isinstance(stmt, ast.Assign):
            self.expr(stmt.value, held)
            for target in stmt.targets:
                self._record_target(target, held)
            return held
        if isinstance(stmt, ast.AugAssign):
            self.expr(stmt.value, held)
            # x += 1 reads AND writes
            self._record(stmt.target, False, held)
            self._record_target(stmt.target, held)
            return held
        if isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self.expr(stmt.value, held)
            self._record_target(stmt.target, held)
            return held
        if isinstance(stmt, ast.Delete):
            for target in stmt.targets:
                self._record_target(target, held)
            return held
        if isinstance(stmt, ast.Expr):
            held2 = self._acquire_release(stmt.value, held)
            if held2 is not None:
                return held2
            self.expr(stmt.value, held)
            return held
        for child in ast.iter_child_nodes(stmt):
            self.expr(child, held)
        return held

    def _loop_body(self, body: Sequence[ast.stmt],
                   orelse: Sequence[ast.stmt],
                   held: FrozenSet[str]) -> Optional[FrozenSet[str]]:
        prev = self._in_loop
        # racer: single-writer -- walker instances are per-function scratch
        self._in_loop = True
        body_out = self.stmts(body, held)
        self._in_loop = prev
        if orelse:
            self.stmts(orelse, held)
        # may-iterate: what survives is the entry set intersected with
        # the body's exit (a release inside the body may have run)
        return held if body_out is None else held & body_out

    def _acquire_release(self, value: ast.AST,
                         held: FrozenSet[str]) -> Optional[FrozenSet[str]]:
        """``self._lock.acquire()`` / ``.release()`` as a bare statement
        moves the held set; returns None when ``value`` is neither."""
        if not (isinstance(value, ast.Call) and
                isinstance(value.func, ast.Attribute) and
                value.func.attr in ("acquire", "release")):
            return None
        token = self._lock_token(value.func.value)
        if token is None:
            return None
        if value.func.attr == "acquire":
            self.model.acquisitions.append(Acquisition(
                self.rec.qualname, token, self.src.path, value.lineno))
            return held | {token}
        return held - {token}


# ---- spawn-site helpers -----------------------------------------------------


def _spawn_kind(node: ast.Call) -> Optional[str]:
    """"thread" / "pool" when this call hands a function to another
    thread, else None."""
    func = node.func
    if isinstance(func, ast.Attribute):
        if func.attr == "Thread" and isinstance(func.value, ast.Name) and \
                func.value.id == "threading":
            return "thread"
        if func.attr in ("submit", "map"):
            recv = dotted_name(func.value) or ""
            leaf = recv.split(".")[-1].lower()
            if any(h in leaf for h in _POOL_RECEIVER_HINTS):
                return "pool"
        if func.attr in _SPAWN_WRAPPERS:
            return "pool"
        return None
    if isinstance(func, ast.Name):
        if func.id == "Thread":
            return "thread"
        if func.id in _SPAWN_WRAPPERS:
            return "pool"
    return None


def _spawn_targets(node: ast.Call) -> List[ast.AST]:
    """The argument expressions that name the spawned function."""
    func = node.func
    name = func.attr if isinstance(func, ast.Attribute) else \
        func.id if isinstance(func, ast.Name) else ""
    if name == "Thread":
        return [kw.value for kw in node.keywords if kw.arg == "target"]
    out: List[ast.AST] = []
    for arg in node.args:
        if _target_name(arg) is not None:
            out.append(arg)
    return out


def _target_name(node: ast.AST) -> Optional[str]:
    """A reference suitable as a spawn target: ``self.x`` -> "self.x",
    ``f`` -> "f", a lambda -> the single call inside it (the
    ``_parallel_map(lambda n: self._fits_on_node(...))`` shape)."""
    if isinstance(node, ast.Lambda):
        for sub in ast.walk(node.body):
            if isinstance(sub, ast.Call):
                inner = dotted_name(sub.func)
                if inner is not None:
                    return inner
        return None
    dotted = dotted_name(node)
    if dotted is None:
        return None
    if dotted.startswith("self.") or "." not in dotted:
        return dotted
    return None


# ---- model construction -----------------------------------------------------


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    func = node.func
    if isinstance(func, ast.Attribute) and func.attr in LOCK_FACTORIES and \
            isinstance(func.value, ast.Name) and func.value.id == "threading":
        return True
    return isinstance(func, ast.Name) and func.id in LOCK_FACTORIES


_MUTABLE_CTORS = frozenset({"list", "dict", "set", "deque", "defaultdict",
                            "OrderedDict", "Counter"})


def _module_level_names(tree: ast.Module) -> Tuple[Set[str], Set[str]]:
    """(mutable module globals, module-level lock names)."""
    mutables: Set[str] = set()
    locks: Set[str] = set()
    for stmt in tree.body:
        if not isinstance(stmt, ast.Assign):
            continue
        value = stmt.value
        is_lock = _is_lock_ctor(value)
        is_mutable = isinstance(value, (ast.List, ast.Dict, ast.Set)) or (
            isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id in _MUTABLE_CTORS)
        for target in stmt.targets:
            if isinstance(target, ast.Name):
                if is_lock:
                    locks.add(target.id)
                elif is_mutable:
                    mutables.add(target.id)
    return mutables, locks


def _annotations_of(src: SourceFile) -> Dict[int, GuardNote]:
    """line -> guard note for every ``# guarded-by:`` / ``# racer:
    single-writer`` comment in the file. A note on a pure comment line
    propagates forward through the rest of its comment block to the
    first code line — a multi-line justification above the field still
    binds to the field's write."""
    notes: Dict[int, GuardNote] = {}
    lines = src.text.splitlines()
    for i, text in enumerate(lines, start=1):
        if "#" not in text:
            continue
        m = GUARDED_BY_RE.search(text)
        if m is not None:
            note = GuardNote("guarded-by", m.group("lock"), src.path, i)
        elif SINGLE_WRITER_RE.search(text):
            note = GuardNote("single-writer", None, src.path, i)
        else:
            continue
        notes[i] = note
        if text.lstrip().startswith("#"):
            # standalone comment: cover the remaining comment lines of
            # the block and the first code line after it, so a
            # multi-line justification still binds its field
            j = i + 1
            while j <= len(lines) and lines[j - 1].lstrip().startswith("#"):
                notes.setdefault(j, note)
                j += 1
            notes.setdefault(j, note)
    return notes


def _class_lock_attrs(cls: ast.ClassDef) -> Set[str]:
    attrs: Set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            for target in node.targets:
                if isinstance(target, ast.Attribute) and \
                        isinstance(target.value, ast.Name) and \
                        target.value.id == "self":
                    attrs.add(target.attr)
    return attrs


def _register_functions(model: LocksetModel, src: SourceFile) -> None:
    def visit(node: ast.AST, class_name: Optional[str],
              prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                locks = _class_lock_attrs(child)
                if locks:
                    model.class_locks.setdefault(child.name, set()) \
                        .update(locks)
                visit(child, child.name, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                if qual in model.functions:
                    qual = f"{qual}@{src.path}:{child.lineno}"
                model.functions[qual] = FunctionRec(
                    qual, child.name, class_name, src.path,
                    child.lineno, child)
                model.by_name.setdefault(child.name, []).append(qual)
                # nested defs: thread bodies and callbacks — their own
                # analysis units, class context NOT inherited (no `self`)
                visit(child, None, qual)

    visit(src.tree, None, "")


def _entry_roots(model: LocksetModel, src: SourceFile) -> None:
    """The ``main`` function of each ``cmd/`` binary runs on the
    process's main thread — a concurrency root like any spawned one."""
    if "cmd" not in src.relparts[:-1]:
        return
    for qual, rec in model.functions.items():
        if rec.path == src.path and rec.name == "main" and \
                rec.class_name is None and "." not in qual.split("@")[0]:
            model.roots.append(Root(qual, "entry", src.path,
                                    rec.lineno, 1))


def build_model(sources: Sequence[SourceFile]) -> LocksetModel:
    """Build the whole-repo lockset model: two passes (register every
    function and lock first — spawn-target and self-call resolution need
    the full table), then the flow-sensitive walk, then the entry-lockset
    fixpoint."""
    model = LocksetModel()
    module_meta: Dict[str, Tuple[Set[str], Set[str]]] = {}
    annotations: Dict[str, Dict[int, GuardNote]] = {}
    for src in sources:
        _register_functions(model, src)
        mutables, locks = _module_level_names(src.tree)
        module_meta[src.path] = (mutables, locks)
        model.module_locks[src.path] = locks
        annotations[src.path] = _annotations_of(src)
    for src in sources:
        mutables, _locks = module_meta[src.path]
        for qual, rec in model.functions.items():
            if rec.path != src.path:
                continue
            walker = _FunctionWalker(model, src, rec, mutables,
                                     annotations[src.path])
            walker.stmts(list(getattr(rec.node, "body", [])), frozenset())
        _entry_roots(model, src)
    for root in model.roots:
        mult = model._root_mult.get(root.target, 0)
        model._root_mult[root.target] = max(mult, root.multiplicity)
    _compute_entry_locks(model)
    return model


_TOP = None  # optimistic "unknown" for the meet-over-call-sites fixpoint


def _compute_entry_locks(model: LocksetModel) -> None:
    """``entry(f) = ∩ over call sites (held ∪ entry(caller))``, solved
    optimistically from ⊤ (call sites through a not-yet-known caller do
    not constrain the meet until the caller resolves). Thread roots and
    entry points pin to ∅ — a spawned function starts lock-free."""
    sites: Dict[str, List[CallSite]] = {}
    for call in model.calls:
        for resolved in model._resolve(call.callee):
            sites.setdefault(resolved, []).append(call)
    entry: Dict[str, Optional[FrozenSet[str]]] = {
        q: _TOP for q in model.functions}
    for qual in model.functions:
        if qual not in sites:
            entry[qual] = frozenset()
    for root in model.roots:
        entry[root.target] = frozenset()
    changed = True
    while changed:
        changed = False
        for qual, call_sites in sites.items():
            if entry.get(qual) == frozenset():
                continue  # already pinned to ∅, can't go lower
            meet: Optional[FrozenSet[str]] = _TOP
            for call in call_sites:
                caller_entry = entry.get(call.caller)
                if caller_entry is _TOP:
                    continue
                have = call.held | (caller_entry or frozenset())
                meet = have if meet is _TOP else meet & have
            if meet is not _TOP and meet != entry.get(qual):
                entry[qual] = meet
                changed = True
    for qual, value in entry.items():
        resolved = value if value is not _TOP else frozenset()
        rec = model.functions[qual]
        if not resolved and rec.name.endswith("_locked") and \
                rec.class_name is not None:
            locks = model.class_locks.get(rec.class_name, set())
            if len(locks) == 1:
                # the naming contract: caller holds THE class lock
                resolved = frozenset({f"self.{next(iter(locks))}"})
        model.entry_locks[qual] = resolved


def shared_model(ctx: object, sources: Sequence[SourceFile]) -> LocksetModel:
    """One lockset model per source set per analysis invocation, cached
    on the engine Context — the racer and hot-path rules both need the
    whole-repo walk, and building it twice doubles the fixpoint cost
    for nothing."""
    key = tuple(s.path for s in sources)
    cache = getattr(ctx, "_lockset_models", None)
    if cache is None:
        cache = {}
        setattr(ctx, "_lockset_models", cache)
    model = cache.get(key)
    if model is None:
        model = cache[key] = build_model(sources)
    return model


def field_write_sites(model: LocksetModel) -> Dict[FieldKey, List[Access]]:
    """Write accesses grouped per field, ``__init__`` construction
    excluded (an object under construction is unreachable by peers)."""
    out: Dict[FieldKey, List[Access]] = {}
    for acc in model.accesses:
        if not acc.write:
            continue
        rec = model.functions.get(acc.func)
        if rec is not None and rec.name in ("__init__", "__new__"):
            continue
        out.setdefault(acc.field, []).append(acc)
    return out


def describe_roots(roots: Iterable[str], model: LocksetModel) -> str:
    """Human-readable root list for finding messages."""
    parts = []
    for target in sorted(roots):
        mult = model.root_multiplicity(target)
        parts.append(f"{target}{' (xN)' if mult > 1 else ''}")
    return ", ".join(parts)
