"""Per-function control-flow graphs + a forward typestate framework.

Every path-shaped rule in this package used to carry its own ad-hoc
walk (charge-pairing's right-to-left fold was the biggest). This module
is the one engine they now share:

* :func:`build_cfg` — a per-function CFG with the shapes the rules
  care about modeled explicitly: branches, loops with **may-iterate**
  semantics (a loop body may run zero or more times; ``while True``
  has no zero-iteration edge), ``with`` bodies, and ``try`` with real
  exception edges — every statement inside a ``try`` may raise into an
  exception-dispatch node that fans to the handlers and unwinds
  outward through each intervening ``finally`` (inlined per exit, the
  way compilers lower it). Explicit ``raise``/``return``/``break``/
  ``continue`` route through enclosing ``finally`` bodies too.

* :func:`may_leak` — the typestate query the obligation rules
  (charge-pairing, resource-lifecycle) are built on: given an
  *acquire* site and a *release* predicate, does some path reach a
  checked exit while the obligation is still open? The lattice per
  node is a set of *tags* — ``None`` for "acquired, traveling normal
  edges" plus one tag per exception handler traversed — joined by set
  union at merge points, so a leak is attributed either to the normal
  path (finding at the acquire site) or to a specific exception edge
  (finding at the handler). Implicit exception propagation OUT of the
  function is deliberately unchecked (matching the charge rule's
  contract: an unexpected crash is the backstop's job);
  explicit ``raise`` exits ARE checked.

  Loops get the may-iterate refinement the canonical cleanup shape
  needs: when every path through a loop body discharges the
  obligation, the zero-iteration edge is treated as discharging too —
  ``for p in assumed: forget_pod(p)`` iterates exactly when there is a
  charge to release — while a body that can exit un-discharged (or
  never discharges at all) keeps the plain join.

* :class:`CallGraph` — interprocedural summaries by name over the
  scanned tree: :meth:`CallGraph.closure` answers "which function
  names transitively reach one of these seed calls", which is how a
  hand-off to the pipelined binder counts as resolving a charge. Name
  resolution is an over-approximation (a same-named function anywhere
  in the package matches), which errs toward silence, never noise.

The port's copy of ``kubegpu_tpu/analysis/dataflow.py``.
"""

from __future__ import annotations

import ast
import dataclasses
from collections import deque
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, \
    Sequence, Set, Union

# ---- shared AST helpers -----------------------------------------------------


def call_names(node: ast.AST) -> Set[str]:
    """Names of everything called anywhere under ``node`` (attribute
    calls by attr name, plain calls by identifier) — lambdas included:
    a deferred ``submit(lambda: self._commit(...))`` hands off work and
    the handed-off call is what matters."""
    out: Set[str] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            func = sub.func
            if isinstance(func, ast.Attribute):
                out.add(func.attr)
            elif isinstance(func, ast.Name):
                out.add(func.id)
    return out


class CallGraph:
    """Name-keyed call graph over every function in the scanned tree.

    ``calls_by_name[f]`` is the set of names functions called ``f``
    call (every function bearing the name anywhere contributes — the
    deliberate over-approximation described in the module docstring).
    """

    def __init__(self, sources: Sequence[object]) -> None:
        self.calls_by_name: Dict[str, Set[str]] = {}
        for src in sources:
            tree = getattr(src, "tree", src)
            for node in ast.walk(tree):  # type: ignore[arg-type]
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    self.calls_by_name.setdefault(node.name, set()) \
                        .update(call_names(node))

    def closure(self, seeds: Iterable[str]) -> FrozenSet[str]:
        """Fixpoint: every name that is a seed, or whose function calls
        a name already in the closure — "calling this resolves the
        obligation, directly or through any chain of helpers"."""
        resolving: Set[str] = set(seeds)
        changed = True
        while changed:
            changed = False
            for name, called in self.calls_by_name.items():
                if name not in resolving and called & resolving:
                    resolving.add(name)
                    changed = True
        return frozenset(resolving)


# ---- the CFG ----------------------------------------------------------------

NORMAL = "normal"
EXCEPT = "except"   # statement -> exception-dispatch node (state: IN ∪ OUT)
SKIP = "skip"       # loop zero-iteration edge (tagged with its loop header)
BACK = "back"       # loop body -> header


@dataclasses.dataclass(frozen=True)
class Edge:
    src: int
    dst: int
    kind: str
    loop: Optional[int] = None  # header node index, for SKIP/BACK edges


class Node:
    """One CFG node. ``kind`` is one of:

    * ``"entry"`` / ``"exit"`` / ``"raise"`` / ``"unwind"`` — the
      synthetic boundary nodes (``raise`` = explicit-raise exit,
      checked by obligation rules; ``unwind`` = implicit exception
      propagation out of the function, unchecked);
    * ``"stmt"`` — a real statement. For compound statements this node
      models the *header* — the test of an ``if``/``while``, the
      iterable of a ``for``, the context expressions of a ``with`` —
      and ``effect`` holds exactly those sub-expressions so transfer
      functions never see the body through the header;
    * ``"handler"`` — an ``except`` clause entry (``handler`` set);
    * ``"dispatch"`` — a try block's exception-dispatch point;
    * ``"join"`` — a synthetic merge point (loop body entry, loop
      skip target).
    """

    __slots__ = ("idx", "kind", "stmt", "handler", "effect")

    def __init__(self, idx: int, kind: str,
                 stmt: Optional[ast.stmt] = None,
                 handler: Optional[ast.excepthandler] = None,
                 effect: Optional[List[ast.AST]] = None) -> None:
        self.idx = idx
        self.kind = kind
        self.stmt = stmt
        self.handler = handler
        self.effect = effect

    def effect_asts(self) -> List[ast.AST]:
        """What a transfer function should inspect for this node: the
        header sub-expressions for compound statements, the whole
        statement otherwise, nothing for synthetic nodes (a dispatch
        node references its ``try`` for context but executes nothing)
        and nested definitions (defining a function has no effect)."""
        if self.kind != "stmt":
            return []
        if self.effect is not None:
            return self.effect
        if self.stmt is not None:
            return [self.stmt]
        return []

    def __repr__(self) -> str:  # debugging aid
        line = getattr(self.stmt, "lineno",
                       getattr(self.handler, "lineno", None))
        return f"<Node {self.idx} {self.kind}" + \
            (f" L{line}>" if line is not None else ">")


@dataclasses.dataclass
class LoopInfo:
    header: int           # node index of the loop header
    body_entry: int       # synthetic join node the body starts from
    body_nodes: Set[int]  # every node built for the body (nested incl.)
    stmt: ast.stmt


class ControlFlowGraph:
    def __init__(self, fn: ast.AST) -> None:
        self.fn = fn
        # builder-private: a CFG is built and then read by one analysis
        # thread; instances never cross threads
        self.nodes: List[Node] = []                 # racer: single-writer
        self.succs: Dict[int, List[Edge]] = {}      # racer: single-writer
        self.preds: Dict[int, List[Edge]] = {}      # racer: single-writer
        self.stmt_nodes: Dict[int, Node] = {}  # id(ast stmt) -> header node
        self.loops: List[LoopInfo] = []
        self.entry = self._new("entry")
        self.exit = self._new("exit")
        self.raise_exit = self._new("raise")
        self.unwind_exit = self._new("unwind")

    def _new(self, kind: str, stmt: Optional[ast.stmt] = None,
             handler: Optional[ast.excepthandler] = None,
             effect: Optional[List[ast.AST]] = None) -> Node:
        node = Node(len(self.nodes), kind, stmt, handler, effect)
        self.nodes.append(node)
        self.succs[node.idx] = []
        self.preds[node.idx] = []
        return node

    def _link(self, src: Node, dst: Node, kind: str = NORMAL,
              loop: Optional[int] = None) -> None:
        edge = Edge(src.idx, dst.idx, kind, loop)
        if edge not in self.succs[src.idx]:
            self.succs[src.idx].append(edge)
            self.preds[dst.idx].append(edge)

    def node_for(self, stmt: ast.stmt) -> Optional[Node]:
        return self.stmt_nodes.get(id(stmt))

    def successors(self, node: Node) -> List[Node]:
        return [self.nodes[e.dst] for e in self.succs[node.idx]]


# Frames the builder threads through nested statements, innermost last.


@dataclasses.dataclass
class _LoopFrame:
    header: Node
    breaks: List[Node]


@dataclasses.dataclass
class _TryFrame:
    dispatch: Optional[Node]
    finalbody: List[ast.stmt]


_Frame = Union[_LoopFrame, _TryFrame]


class _Builder:
    def __init__(self, fn: ast.AST) -> None:
        self.cfg = ControlFlowGraph(fn)

    def build(self) -> ControlFlowGraph:
        cfg = self.cfg
        frontier = self._seq(list(getattr(cfg.fn, "body", [])),
                             [cfg.entry], [])
        for node in frontier:
            cfg._link(node, cfg.exit)
        return cfg

    # -- statement sequencing -------------------------------------------------

    def _seq(self, stmts: List[ast.stmt], frontier: List[Node],
             frames: List[_Frame]) -> List[Node]:
        """Thread ``frontier`` (the dangling exits of what came before)
        through ``stmts``; returns the new frontier. An empty frontier
        means the suffix is unreachable and is skipped."""
        for stmt in stmts:
            if not frontier:
                return []
            frontier = self._stmt(stmt, frontier, frames)
        return frontier

    def _stmt(self, stmt: ast.stmt, frontier: List[Node],
              frames: List[_Frame]) -> List[Node]:
        cfg = self.cfg
        if isinstance(stmt, ast.If):
            node = self._header(stmt, [stmt.test], frontier, frames)
            then = self._seq(list(stmt.body), [node], frames)
            orelse = self._seq(list(stmt.orelse), [node], frames) \
                if stmt.orelse else [node]
            return then + orelse
        if isinstance(stmt, (ast.While, ast.For, ast.AsyncFor)):
            return self._loop(stmt, frontier, frames)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            effect: List[ast.AST] = [i.context_expr for i in stmt.items]
            effect += [i.optional_vars for i in stmt.items
                       if i.optional_vars is not None]
            node = self._header(stmt, effect, frontier, frames)
            return self._seq(list(stmt.body), [node], frames)
        if isinstance(stmt, ast.Try):
            return self._try(stmt, frontier, frames)
        if isinstance(stmt, ast.Return):
            node = self._header(stmt, None, frontier, frames)
            self._unwind_to([node], self._finally_frames(frames), cfg.exit)
            return []
        if isinstance(stmt, ast.Raise):
            node = self._header(stmt, None, frontier, frames)
            # the explicit-raise exit is checked; unwinding still runs
            # every enclosing finally on the way out
            self._unwind_to([node], self._finally_frames(frames),
                            cfg.raise_exit)
            return []
        if isinstance(stmt, (ast.Break, ast.Continue)):
            node = self._header(stmt, None, frontier, frames)
            inner: List[_TryFrame] = []
            loop_frame: Optional[_LoopFrame] = None
            for frame in reversed(frames):
                if isinstance(frame, _LoopFrame):
                    loop_frame = frame
                    break
                inner.append(frame)
            if loop_frame is None:
                return []  # malformed; unparseable code cannot get here
            exits = self._inline_finallys([node], inner)
            if isinstance(stmt, ast.Break):
                loop_frame.breaks.extend(exits)
            else:
                for n in exits:
                    cfg._link(n, loop_frame.header, BACK,
                              loop=loop_frame.header.idx)
            return []
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            # a nested definition runs later on someone else's
            # schedule: its body is a separate analysis unit, and
            # *defining* it has no effect here
            return [self._header(stmt, [], frontier, frames)]
        # simple statement (Expr/Assign/Assert/Delete/Import/...)
        return [self._header(stmt, None, frontier, frames)]

    def _header(self, stmt: ast.stmt, effect: Optional[List[ast.AST]],
                frontier: List[Node], frames: List[_Frame]) -> Node:
        """Create the node for ``stmt``, wire the frontier in, and give
        it an exception edge to the innermost dispatch (any statement
        inside a ``try`` may raise)."""
        cfg = self.cfg
        node = cfg._new("stmt", stmt=stmt, effect=effect)
        cfg.stmt_nodes.setdefault(id(stmt), node)
        for prev in frontier:
            cfg._link(prev, node)
        dispatch = self._innermost_dispatch(frames)
        if dispatch is not None:
            cfg._link(node, dispatch, EXCEPT)
        return node

    @staticmethod
    def _innermost_dispatch(frames: List[_Frame]) -> Optional[Node]:
        for frame in reversed(frames):
            if isinstance(frame, _TryFrame):
                return frame.dispatch
        return None

    @staticmethod
    def _finally_frames(frames: List[_Frame]) -> List[_TryFrame]:
        """The try frames whose ``finally`` an abrupt exit must run,
        innermost first."""
        return [f for f in reversed(frames) if isinstance(f, _TryFrame)]

    # -- loops ----------------------------------------------------------------

    @staticmethod
    def _is_while_true(stmt: ast.stmt) -> bool:
        return isinstance(stmt, ast.While) and \
            isinstance(stmt.test, ast.Constant) and bool(stmt.test.value)

    def _loop(self, stmt: ast.stmt, frontier: List[Node],
              frames: List[_Frame]) -> List[Node]:
        cfg = self.cfg
        if isinstance(stmt, ast.While):
            effect: List[ast.AST] = [stmt.test]
        else:
            effect = [stmt.iter, stmt.target]  # type: ignore[attr-defined]
        header = self._header(stmt, effect, frontier, frames)
        body_entry = cfg._new("join")
        cfg._link(header, body_entry)
        frame = _LoopFrame(header=header, breaks=[])
        first_body_idx = len(cfg.nodes)
        body_exit = self._seq(list(stmt.body),  # type: ignore[attr-defined]
                              [body_entry], frames + [frame])
        body_nodes = set(range(first_body_idx, len(cfg.nodes)))
        body_nodes.add(body_entry.idx)
        cfg.loops.append(LoopInfo(header.idx, body_entry.idx, body_nodes,
                                  stmt))
        for node in body_exit:
            cfg._link(node, header, BACK, loop=header.idx)
        after: List[Node] = list(frame.breaks)
        orelse = list(getattr(stmt, "orelse", []) or [])
        if not self._is_while_true(stmt):
            if orelse:
                after += self._seq(orelse, [header], frames)
            else:
                # the zero-iteration edge, tagged so may_leak can apply
                # the may-iterate refinement per obligation
                skip_join = cfg._new("join")
                cfg._link(header, skip_join, SKIP, loop=header.idx)
                after.append(skip_join)
        return after

    # -- try / except / finally ----------------------------------------------

    def _try(self, stmt: ast.Try, frontier: List[Node],
             frames: List[_Frame]) -> List[Node]:
        cfg = self.cfg
        dispatch = cfg._new("dispatch", stmt=stmt)
        frame = _TryFrame(dispatch=dispatch, finalbody=list(stmt.finalbody))
        body_exit = self._seq(list(stmt.body), frontier, frames + [frame])
        # handler and ELSE bodies: an exception raised there dispatches
        # past this try's handlers (to the next one out) but still
        # unwinds through this try's finally — modeled by a frame whose
        # dispatch is the outer one and whose finalbody is this one's
        handler_frame = _TryFrame(
            dispatch=self._innermost_dispatch(frames),
            finalbody=list(stmt.finalbody))
        if stmt.orelse:
            body_exit = self._seq(list(stmt.orelse), body_exit,
                                  frames + [handler_frame])
        handler_exits: List[Node] = []
        for handler in stmt.handlers:
            hnode = cfg._new("handler", handler=handler)
            cfg._link(dispatch, hnode)
            handler_exits += self._seq(list(handler.body), [hnode],
                                       frames + [handler_frame])
        # normal continuation: body/orelse and completed handlers run
        # the finally, then fall through
        after = body_exit + handler_exits
        if stmt.finalbody:
            after = self._seq(list(stmt.finalbody), after, frames)
        # propagation: an exception no handler here catches unwinds
        # through this finally to the next dispatch out, or leaves the
        # function on the unchecked implicit-propagation exit
        prop: List[Node] = [dispatch]
        if stmt.finalbody:
            prop = self._seq(list(stmt.finalbody), prop, frames)
        outer = self._innermost_dispatch(frames)
        for node in prop:
            cfg._link(node, outer if outer is not None else cfg.unwind_exit)
        return after

    # -- finally inlining for abrupt exits ------------------------------------

    def _inline_finallys(self, frontier: List[Node],
                         frames_innermost_first: List[_TryFrame]) \
            -> List[Node]:
        """Inline fresh copies of the given frames' finally bodies
        (innermost first) after ``frontier``; returns the new
        frontier."""
        for frame in frames_innermost_first:
            if frame.finalbody:
                frontier = self._seq(list(frame.finalbody), frontier, [])
            if not frontier:
                break
        return frontier

    def _unwind_to(self, frontier: List[Node], frames: List[_TryFrame],
                   target: Node) -> None:
        frontier = self._inline_finallys(frontier, frames)
        for node in frontier:
            self.cfg._link(node, target)


def build_cfg(fn: ast.AST) -> ControlFlowGraph:
    """CFG for one ``FunctionDef``/``AsyncFunctionDef`` (or any object
    with a ``body`` list of statements)."""
    return _Builder(fn).build()


# ---- the obligation (typestate) query ---------------------------------------

# A tag is None (normal-path state) or the exception handler last
# traversed — what a leaking path gets attributed to.
_Tag = Optional[ast.excepthandler]


@dataclasses.dataclass
class LeakReport:
    """Result of :func:`may_leak` for one acquire site."""

    normal: bool                        # a normal/explicit-raise path leaks
    handlers: List[ast.excepthandler]   # exception edges that leak

    def clean(self) -> bool:
        return not self.normal and not self.handlers


def may_leak(cfg: ControlFlowGraph, site: Node,
             releases: Callable[[Node], bool],
             site_releases: bool = False,
             site_raise_holds: bool = True) -> LeakReport:
    """Does some path from ``site`` reach a checked exit (normal return
    / fall-off / explicit raise) with the obligation still open?

    ``releases(node)`` decides whether executing a node discharges the
    obligation; ``site_releases`` covers the acquire-and-resolve-in-one-
    statement shape. Exception edges propagate the state from *before*
    the raising statement as well as after it (a raise may interrupt
    the statement at any point), and entering a handler re-tags the
    state so leaks are attributed to the right edge. Loop zero-
    iteration edges apply the may-iterate refinement described in the
    module docstring.

    ``site_raise_holds`` controls the acquire statement's own
    exception edge: True (charge-pairing's historical contract) means
    a raise during the site leaves the obligation open; False fits the
    ``x = open(...)`` shape, where an exception in the statement means
    nothing was acquired and the covering handler owes nothing."""
    release_cache: Dict[int, bool] = {}

    def _releases(node: Node) -> bool:
        got = release_cache.get(node.idx)
        if got is None:
            got = bool(node.effect_asts()) and releases(node)
            release_cache[node.idx] = got
        return got

    releasing_loops = _releasing_loops(cfg, _releases)
    seed: FrozenSet[_Tag] = frozenset() if site_releases \
        else frozenset({None})
    in_tags: Dict[int, Set[_Tag]] = {}
    out_tags: Dict[int, Set[_Tag]] = {site.idx: set(seed)}

    def transfer(node: Node, tags: Set[_Tag]) -> Set[_Tag]:
        if node.kind == "handler":
            return {node.handler} if tags else set()
        if _releases(node):
            return set()
        return set(tags)

    work: deque = deque([site.idx])
    while work:
        idx = work.popleft()
        node_in = in_tags.get(idx, set())
        node_out = out_tags.get(idx, set())
        for edge in cfg.succs[idx]:
            if edge.kind == SKIP and edge.loop in releasing_loops:
                continue
            if edge.kind != EXCEPT:
                payload = node_out
            elif idx != site.idx:
                payload = node_in | node_out
            elif site_raise_holds:
                # mid-statement state: the acquire may have landed and
                # the same statement's release not yet run — even an
                # acquire-and-resolve-in-one site owes its handlers
                payload = node_in | node_out | {None}
            else:
                payload = node_in
            if not payload:
                continue
            dst_in = in_tags.setdefault(edge.dst, set())
            if payload <= dst_in:
                continue
            dst_in |= payload
            new_out = transfer(cfg.nodes[edge.dst], dst_in)
            if edge.dst == site.idx:
                new_out |= seed  # re-executing the site re-acquires
            out_tags[edge.dst] = new_out
            work.append(edge.dst)
    leaked: Set[_Tag] = set()
    for exit_idx in (cfg.exit.idx, cfg.raise_exit.idx):
        leaked |= in_tags.get(exit_idx, set())
    handlers = sorted((t for t in leaked if t is not None),
                      key=lambda h: h.lineno)
    return LeakReport(normal=None in leaked, handlers=handlers)


def _releasing_loops(cfg: ControlFlowGraph,
                     releases: Callable[[Node], bool]) -> Set[int]:
    """Loop headers whose every body path discharges the obligation.

    Seed an open obligation at the body entry and propagate it along
    normal control flow; the body discharges on all paths exactly when
    the open state can neither travel back to the header (another
    iteration with it still open) nor escape the body region (a break,
    return, or explicit raise that leaves with it open). Exception
    edges are not followed here — implicit propagation out of the
    function is unchecked by contract, and handler edges are judged
    independently by the main query. Computed innermost-first so an
    inner releasing loop's skip edge is already refined while judging
    the outer one."""
    order = sorted(range(len(cfg.loops)),
                   key=lambda i: _nesting_depth(cfg.loops[i].stmt),
                   reverse=True)
    result: Set[int] = set()
    for i in order:
        info = cfg.loops[i]
        open_nodes: Set[int] = set()
        work = [info.body_entry]
        while work:
            idx = work.pop()
            if idx in open_nodes:
                continue
            open_nodes.add(idx)
            node = cfg.nodes[idx]
            if idx != info.body_entry and releases(node):
                continue  # discharged; this path is covered
            for edge in cfg.succs[idx]:
                if edge.kind == EXCEPT:
                    continue
                if edge.kind == SKIP and edge.loop in result:
                    continue
                work.append(edge.dst)
        escapes = open_nodes - info.body_nodes - {info.body_entry}
        back_open = any(
            e.kind == BACK and e.src in open_nodes
            and not releases(cfg.nodes[e.src])
            for e in cfg.preds[info.header])
        if not back_open and not escapes:
            result.add(info.header)
    return result


def _nesting_depth(stmt: ast.stmt) -> int:
    depth = 0
    for node in ast.walk(stmt):
        if node is not stmt and isinstance(node, (ast.For, ast.AsyncFor,
                                                  ast.While)):
            depth += 1
    return depth


def stmt_sites(cfg: ControlFlowGraph,
               matches: Callable[[Node], bool]) -> List[Node]:
    """The "stmt"-kind nodes whose effect matches — the acquire-site
    scan every obligation rule starts from, in source order."""
    out = [n for n in cfg.nodes if n.kind == "stmt" and n.effect_asts()
           and matches(n)]
    out.sort(key=lambda n: getattr(n.stmt, "lineno", 0))
    return out
