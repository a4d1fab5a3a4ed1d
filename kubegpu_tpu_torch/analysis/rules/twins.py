"""Dual-path drift rules: the vector/scalar twin contract.

The port's copy of ``kubegpu_tpu/analysis/rules/twins.py``. The
scheduler's hot paths are dual implementations: a masked numpy chain
(``scheduler/vectorized.py``) shadowing the scalar predicate chain in
``scheduler/core.py``, and a columnar fleet mirror (``_FleetColumns``)
shadowing the object cache (``scheduler/cache.py``). The only thing
holding the twins together is hand-written differential tests, so the
twin relationships themselves become checked contracts:

* ``twin-coverage`` — every vectorized kernel declares its scalar
  original with a ``# twin-of: <qualname>`` comment bound to its
  ``def`` (``kubegpu_tpu_torch.scheduler.…``). The declaration must
  *resolve* (the named original exists in the scanned tree), the pair
  must be *exercised* (one of the two names appears,
  AST-identifier-checked like codec-pairing's tested-in rule, in the
  port's differential tests ``test_torch_vectorized.py`` and
  ``test_torch_batch.py``; the reference's ``test_vector*.py`` hold
  another package's twins and never count), and — the coverage half —
  every scalar DEFAULT-chain predicate must either be the declared
  original of some twin or carry a ``# vector-gate:`` declaration naming
  how the masked pass routes its pods/nodes to the scalar chain. An
  undeclared default predicate is a predicate the masked pass may
  silently disagree with.

* ``mirror-maintenance`` — dataflow over the scheduler cache (the CFG
  engine of ``dataflow.py``): in a class that owns a fleet-columns mirror
  (``self.columns``), every path that bumps a fit generation
  (``_invalidate_locked`` / ``_invalidate_all_locked`` call sites) must
  first update the mirror (a ``self.columns.<...>()`` call, or the
  None-guarded ``if self.columns is not None:`` form, credited at the
  guard) — on ALL paths, exception edges included. The invalidate
  methods themselves must propagate the new generation into the columns
  (``set_gen`` / ``bump_all_gens``), and nothing outside them may write
  the generation map directly.

* ``reason-parity`` — failure-reason string literals emitted by the
  vector chain (``_REASON*`` constants and list-display literals inside
  twin-declared functions) must be drawn from the exact literal set the
  scalar chain emits (every literal in the port's ``predicates.py`` and
  ``factory.py``) — a drifted ``Insufficient ...`` string is a verdict
  the differential tests would report as a reason mismatch in
  production, caught here at parse time.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from kubegpu_tpu_torch.analysis.dataflow import (EXCEPT, ControlFlowGraph,
                                                 build_cfg, call_names)
from kubegpu_tpu_torch.analysis.engine import (Context, Finding, SourceFile,
                                               bound_comments, dotted_name,
                                               walk_functions)

TWIN_RE = re.compile(r"#\s*twin-of:\s*(?P<qual>[A-Za-z_][\w.]*)")
GATE_RE = re.compile(r"#\s*vector-gate:\s*(?P<why>\S.*)")

#: The differential-test files the exercised check scans: the port's
#: vector-vs-scalar proof suites, never the reference's test_vector*.py.
DIFF_TEST_FILES = ("test_torch_vectorized.py", "test_torch_batch.py")


# ---- shared helpers ---------------------------------------------------------


_functions = walk_functions


def _bound_comments(
        src: SourceFile,
        regex: "re.Pattern[str]") -> List[Tuple[int, Optional[int], str]]:
    """The shared :func:`engine.bound_comments` walk, with the match's
    first capture group extracted (the qualname / justification)."""
    return [(cline, dline, m.group(1))
            for cline, dline, m in bound_comments(src, regex)]


def _diff_test_identifiers(ctx: Context) -> Optional[Set[str]]:
    """Identifiers referenced (names or attributes) in the differential
    tests — AST-level like codec-pairing's tested-in check, so a
    docstring mention cannot satisfy the exercised requirement. None
    when no tests tree (or no differential test file) is in scope."""
    if ctx.tests_dir is None or not os.path.isdir(ctx.tests_dir):
        return None
    idents: Set[str] = set()
    found = False
    for name in DIFF_TEST_FILES:
        path = os.path.join(ctx.tests_dir, name)
        if not os.path.isfile(path):
            continue
        with open(path, encoding="utf-8") as fh:
            try:
                tree = ast.parse(fh.read(), filename=path)
            except SyntaxError:
                continue
        found = True
        for node in ast.walk(tree):
            if isinstance(node, ast.Name):
                idents.add(node.id)
            elif isinstance(node, ast.Attribute):
                idents.add(node.attr)
    return idents if found else None


# ---- twin-coverage ----------------------------------------------------------


class _TwinDecl:
    __slots__ = ("src", "comment_line", "fn_name", "fn_qual", "target")

    def __init__(self, src: SourceFile, comment_line: int, fn_name: str,
                 fn_qual: str, target: str) -> None:
        self.src = src
        self.comment_line = comment_line
        self.fn_name = fn_name
        self.fn_qual = fn_qual
        self.target = target


class TwinCoverage:
    name = "twin-coverage"
    description = ("vectorized kernels declare their scalar originals "
                   "with `# twin-of:` (resolving, and exercised by the "
                   "differential tests); every DEFAULT-chain predicate "
                   "needs a declared twin or a `# vector-gate:`")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        defined: Set[str] = set()          # bare terminal names
        defined_quals: Set[str] = set()    # Class.method qualnames
        class_names: Set[str] = set()
        module_stems: Set[str] = set()
        toplevel_by_module: Dict[str, Set[str]] = {}
        fn_by_line: Dict[str, Dict[int, Tuple[str, Any]]] = {}
        for src in sources:
            stem = src.name[:-3] if src.name.endswith(".py") else src.name
            module_stems.add(stem)
            toplevel = toplevel_by_module.setdefault(stem, set())
            per_line: Dict[int, Tuple[str, Any]] = {}
            for qual, node in _functions(src.tree):
                defined.add(qual.rsplit(".", 1)[-1])
                defined_quals.add(qual)
                if "." not in qual:
                    toplevel.add(qual)
                per_line[node.lineno] = (qual, node)
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef):
                    class_names.add(node.name)
            fn_by_line[src.path] = per_line

        decls: List[_TwinDecl] = []
        for src in sources:
            per_line = fn_by_line[src.path]
            for cline, dline, qual in _bound_comments(src, TWIN_RE):
                bound = per_line.get(dline) if dline is not None else None
                if bound is None:
                    yield Finding(
                        self.name, src.path, cline,
                        f"`# twin-of: {qual}` binds to no function "
                        f"definition — move it onto (or directly above) "
                        f"the twin's `def`; an orphaned declaration "
                        f"looks like coverage and provides none")
                    continue
                fn_qual, node = bound
                decls.append(_TwinDecl(src, cline,
                                       fn_qual.rsplit(".", 1)[-1],
                                       fn_qual, qual))

        test_idents = _diff_test_identifiers(ctx)
        for decl in decls:
            parts = decl.target.split(".")
            terminal = parts[-1]
            if not self._resolves(parts, defined, defined_quals,
                                  class_names, module_stems,
                                  toplevel_by_module):
                yield Finding(
                    self.name, decl.src.path, decl.comment_line,
                    f"`# twin-of: {decl.target}` does not resolve in "
                    f"the scanned tree — the twin binding is dangling "
                    f"(renamed, moved, or removed original?)")
                continue
            if test_idents is not None and \
                    decl.fn_name not in test_idents and \
                    terminal not in test_idents:
                yield Finding(
                    self.name, decl.src.path, decl.comment_line,
                    f"twin pair `{decl.fn_qual}` <-> `{terminal}` never "
                    f"appears in the differential tests "
                    f"({', '.join(DIFF_TEST_FILES)}) — an unexercised "
                    f"twin pair "
                    f"drifts unobserved")

        targets = {d.target.rsplit(".", 1)[-1] for d in decls}
        for src in sources:
            yield from self._check_default_chain(src, targets)

    @staticmethod
    def _resolves(parts: List[str], defined: Set[str],
                  defined_quals: Set[str], class_names: Set[str],
                  module_stems: Set[str],
                  toplevel_by_module: Dict[str, Set[str]]) -> bool:
        """A qualified target must resolve through its last TWO
        segments — ``Class.method`` against a scanned class, or
        ``module.function`` against that module's top level — so a
        moved or mis-pathed original cannot hide behind a same-named
        function elsewhere in the tree. A bare single-segment target
        falls back to the permissive any-function match."""
        terminal = parts[-1]
        if len(parts) == 1:
            return terminal in defined
        parent = parts[-2]
        if parent in class_names:
            return f"{parent}.{terminal}" in defined_quals
        if parent in module_stems:
            return terminal in toplevel_by_module.get(parent, set())
        return False

    def _check_default_chain(self, src: SourceFile,
                             twin_targets: Set[str]) -> Iterator[Finding]:
        """The coverage half: DEFAULT_PREDICATE_NAMES x FIT_PREDICATES
        (wherever both shapes appear — the factory, or a fixture
        modeling it) must be fully twin-covered or vector-gated."""
        default_names = self._default_names(src.tree)
        registry = self._fit_registry(src.tree)
        if default_names is None or registry is None:
            return
        builder_defs: Dict[str, Any] = {
            qual.rsplit(".", 1)[-1]: node
            for qual, node in _functions(src.tree)}
        gated: Set[str] = set()
        for _cline, dline, _why in _bound_comments(src, GATE_RE):
            for bname, node in builder_defs.items():
                if getattr(node, "lineno", None) == dline:
                    gated.add(bname)
        seen: Set[str] = set()
        for pred_name in default_names:
            entry = registry.get(pred_name)
            if entry is None:
                continue
            builder, line = entry
            if builder in seen:
                continue
            seen.add(builder)
            if builder in twin_targets or builder in gated:
                continue
            node = builder_defs.get(builder)
            if node is not None and call_names(node) & twin_targets:
                continue  # one hop: the builder wraps a declared original
            yield Finding(
                self.name, src.path,
                getattr(node, "lineno", line),
                f"default predicate `{pred_name}` (builder `{builder}`) "
                f"has no declared vector twin and no `# vector-gate:` "
                f"declaration — the masked pass's behavior for it is an "
                f"unchecked assumption")

    @staticmethod
    def _default_names(tree: ast.AST) -> Optional[List[str]]:
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == "DEFAULT_PREDICATE_NAMES" and \
                    isinstance(node.value, (ast.Tuple, ast.List)):
                out = [e.value for e in node.value.elts
                       if isinstance(e, ast.Constant)
                       and isinstance(e.value, str)]
                return out
        return None

    @staticmethod
    def _fit_registry(tree: ast.AST) -> \
            Optional[Dict[str, Tuple[str, int]]]:
        """FIT_PREDICATES entries -> (builder function name, line).
        Handles the repo's shapes: ``_declare(...)(_p_host)``,
        ``_declare(...)(_p_max_volumes("kind", 39))``, and a bare
        builder name."""
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and node.targets[0].id == "FIT_PREDICATES"
                    and isinstance(node.value, ast.Dict)):
                continue
            out: Dict[str, Tuple[str, int]] = {}
            for key, value in zip(node.value.keys, node.value.values):
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue
                builder = _builder_name(value)
                if builder is not None:
                    out[key.value] = (builder, value.lineno)
            return out
        return None


def _builder_name(value: ast.AST) -> Optional[str]:
    if isinstance(value, ast.Name):
        return value.id
    if isinstance(value, ast.Call):
        # `_declare(...)(builder)` — the builder is the outer call's arg
        if value.args:
            inner = value.args[0]
            if isinstance(inner, ast.Name):
                return inner.id
            if isinstance(inner, ast.Call):
                got = dotted_name(inner.func)
                if got is not None:
                    return got.rsplit(".", 1)[-1]
        got = dotted_name(value.func)
        if got is not None:
            return got.rsplit(".", 1)[-1]
    return None


# ---- mirror-maintenance -----------------------------------------------------

_INVALIDATE_NAMES = ("self._invalidate_locked", "self._invalidate_all_locked")
_GEN_PROPAGATORS = frozenset({"set_gen", "bump_all_gens"})


class MirrorMaintenance:
    name = "mirror-maintenance"
    description = ("every generation bump in a fleet-columns-owning "
                   "cache must be preceded by a columns update on all "
                   "paths (exception edges included); the invalidators "
                   "must propagate generations into the mirror")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.ClassDef) and \
                        self._owns_columns(node):
                    yield from self._check_class(src, node)

    @staticmethod
    def _owns_columns(cls: ast.ClassDef) -> bool:
        for node in ast.walk(cls):
            if isinstance(node, ast.Attribute) and \
                    dotted_name(node) == "self.columns":
                return True
        return False

    def _check_class(self, src: SourceFile,
                     cls: ast.ClassDef) -> Iterator[Finding]:
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in ("_invalidate_locked", "_invalidate_all_locked"):
                if not self._propagates_gen(item):
                    yield Finding(
                        self.name, src.path, item.lineno,
                        f"{cls.name}.{item.name}() bumps generations but "
                        f"never mirrors them into the fleet columns "
                        f"(self.columns.set_gen / bump_all_gens) — the "
                        f"mask memo would serve verdicts the bump meant "
                        f"to retire")
                continue
            yield from self._check_method(src, cls, item)

    @staticmethod
    def _propagates_gen(fn: ast.AST) -> bool:
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                got = dotted_name(node.func)
                if got is not None and got.startswith("self.columns.") and \
                        got.rsplit(".", 1)[-1] in _GEN_PROPAGATORS:
                    return True
        return False

    def _check_method(self, src: SourceFile, cls: ast.ClassDef,
                      fn: ast.AST) -> Iterator[Finding]:
        bumps = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and dotted_name(n.func) in _INVALIDATE_NAMES]
        for node in ast.walk(fn):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for tgt in targets:
                    if isinstance(tgt, ast.Subscript) and \
                            dotted_name(tgt.value) == "self._gen":
                        yield Finding(
                            self.name, src.path, node.lineno,
                            f"{cls.name}.{fn.name}() writes the "
                            f"generation map directly; bump through "
                            f"_invalidate_locked so the columns mirror "
                            f"moves in lockstep")
        if not bumps:
            return
        cfg = build_cfg(fn)
        dirty = self._dirty_tags(cfg)
        reported: Set[int] = set()
        for node in cfg.nodes:
            if node.kind != "stmt":
                continue
            if not any(isinstance(sub, ast.Call)
                       and dotted_name(sub.func) in _INVALIDATE_NAMES
                       for a in node.effect_asts()
                       for sub in ast.walk(a)):
                continue
            tags = dirty.get(node.idx, set())
            if not tags:
                continue
            line = getattr(node.stmt, "lineno", fn.lineno)
            if line in reported:
                continue
            reported.add(line)
            handlers = sorted(t.lineno for t in tags if t is not None)
            via = []
            if None in tags:
                via.append("a normal path")
            if handlers:
                via.append("an exception edge (handler at line "
                           + ", ".join(str(h) for h in handlers) + ")")
            yield Finding(
                self.name, src.path, line,
                f"{cls.name}.{fn.name}() bumps a fit generation with no "
                f"fleet-columns update on {' and '.join(via)} — the "
                f"mirror and the objects it mirrors diverge")

    def _dirty_tags(self, cfg: ControlFlowGraph) -> Dict[int, set]:
        """Forward tag propagation from entry: a node's in-set holds
        ``None`` when some normal path reaches it with the mirror not
        yet updated, or an ``excepthandler`` when an exception edge
        does. A maintaining statement clears the state (the mirror is
        in sync past it)."""
        in_tags: Dict[int, set] = {}
        out_tags: Dict[int, set] = {cfg.entry.idx: {None}}
        work = [cfg.entry.idx]
        while work:
            idx = work.pop()
            node_in = in_tags.get(idx, set())
            node_out = out_tags.get(idx, set())
            for edge in cfg.succs[idx]:
                payload = node_in | node_out if edge.kind == EXCEPT \
                    else node_out
                if not payload:
                    continue
                dst_in = in_tags.setdefault(edge.dst, set())
                if payload <= dst_in:
                    continue
                dst_in |= payload
                dst = cfg.nodes[edge.dst]
                if dst.kind == "handler":
                    new_out = {dst.handler} if dst_in else set()
                elif self._maintains(dst):
                    new_out = set()
                else:
                    new_out = set(dst_in)
                out_tags[edge.dst] = new_out
                work.append(edge.dst)
        return in_tags

    @staticmethod
    def _maintains(node: object) -> bool:
        stmt = getattr(node, "stmt", None)
        if getattr(node, "kind", None) != "stmt":
            return False
        if isinstance(stmt, ast.If):
            # the None-guarded form: `if self.columns is not None:
            #     self.columns.charge(...)` — credited at the guard so
            # the numpy-less branch is not a false positive
            test_reads = any(
                isinstance(sub, ast.Attribute)
                and dotted_name(sub) == "self.columns"
                for sub in ast.walk(stmt.test))
            body_updates = any(
                isinstance(sub, ast.Call)
                and (dotted_name(sub.func) or "").startswith("self.columns.")
                for s in stmt.body for sub in ast.walk(s))
            return test_reads and body_updates
        for a in getattr(node, "effect_asts", lambda: [])():
            for sub in ast.walk(a):
                if isinstance(sub, ast.Call):
                    got = dotted_name(sub.func)
                    if got is not None and got.startswith("self.columns."):
                        return True
        return False


# ---- reason-parity ----------------------------------------------------------

_REASON_NAME_RE = re.compile(r"^_REASON")
#: Modules whose string literals define the scalar chain's reason
#: vocabulary (the allowed set; over-approximate — errs silent).
_SCALAR_REASON_FILES = ("predicates.py", "factory.py")


def _norm_str(node: ast.AST) -> Optional[str]:
    """A string constant, or an f-string with every interpolation
    normalized to ``{}`` — so ``f"Insufficient {res}"`` in the vector
    chain matches the scalar chain's identical template."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for part in node.values:
            if isinstance(part, ast.Constant) and \
                    isinstance(part.value, str):
                parts.append(part.value)
            else:
                parts.append("{}")
        return "".join(parts)
    return None


class ReasonParity:
    name = "reason-parity"
    description = ("failure-reason literals in the vector chain "
                   "(`_REASON*` constants, list literals in twin-"
                   "declared functions) must match the scalar chain's "
                   "literal set verbatim — no drifted reason strings")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        pool: Set[str] = set()
        for src in sources:
            if src.name in _SCALAR_REASON_FILES:
                for node in ast.walk(src.tree):
                    got = _norm_str(node)
                    if got is not None:
                        pool.add(got)
        if not pool:
            return  # no scalar chain in scope: nothing to compare against
        for src in sources:
            if src.name in _SCALAR_REASON_FILES:
                continue
            yield from self._check_source(src, pool)

    def _check_source(self, src: SourceFile,
                      pool: Set[str]) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name) and \
                    _REASON_NAME_RE.match(node.targets[0].id):
                got = _norm_str(node.value)
                if got is not None and got not in pool:
                    yield Finding(
                        self.name, src.path, node.lineno,
                        f"reason constant {node.targets[0].id} = "
                        f"{got!r} is not a literal the scalar chain "
                        f"emits ({'/'.join(_SCALAR_REASON_FILES)}) — "
                        f"twin reason drift")
        twin_defs = {dline for _c, dline, _q in _bound_comments(src, TWIN_RE)}
        if not twin_defs:
            return
        for qual, fn in _functions(src.tree):
            if fn.lineno not in twin_defs:  # type: ignore[attr-defined]
                continue
            for node in ast.walk(fn):
                elts: List[ast.AST] = []
                if isinstance(node, ast.List):
                    elts = list(node.elts)
                elif isinstance(node, ast.ListComp):
                    elts = [node.elt]
                for elt in elts:
                    got = _norm_str(elt)
                    if got is not None and got not in pool:
                        yield Finding(
                            self.name, src.path, elt.lineno,
                            f"reason literal {got!r} emitted by twin "
                            f"`{qual}` is not in the scalar chain's "
                            f"literal set — the differential contract "
                            f"requires verbatim reason strings")
