"""Per-function control-flow graphs for the host-sync rule.

The port's copy of the CFG builder of ``kubegpu_tpu/analysis/dataflow.py``
(its leak analysis, which only the control plane's obligation rules use,
is left out). :func:`build_cfg` gives a per-function CFG with the shapes
the rule cares about modelled explicitly: branches, loops with
may-iterate semantics (a body may run zero or more times; ``while True``
has no zero-iteration edge), ``with`` bodies, and ``try`` with exception
edges: every statement inside a ``try`` may raise into a dispatch node
that fans out to the handlers and unwinds through each intervening
``finally`` (inlined per exit). ``raise``, ``return``, ``break`` and
``continue`` route through enclosing ``finally`` bodies too.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Union

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
      synthetic boundary nodes (``raise`` = the explicit-raise exit;
      ``unwind`` = implicit exception propagation out of the function);
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
        self.nodes: List[Node] = []
        self.succs: Dict[int, List[Edge]] = {}
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
        return node

    def _link(self, src: Node, dst: Node, kind: str = NORMAL,
              loop: Optional[int] = None) -> None:
        edge = Edge(src.idx, dst.idx, kind, loop)
        if edge not in self.succs[src.idx]:
            self.succs[src.idx].append(edge)


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
                # the zero-iteration edge, tagged with its loop
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
