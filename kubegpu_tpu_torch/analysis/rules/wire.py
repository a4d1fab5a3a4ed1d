"""Wire-contract: both ends of every wire must agree, statically.

PAPER.md's whole mechanism is a cross-process contract — annotations
and binary frames written by one component and decoded by another — and
that contract spans TWO negotiated framings over one route table. A route, frame type, codec tag, or typed-error mapping added on
one side with no counterpart on the other is exactly the bug class no
unit test reliably catches (each side is self-consistent; only the
pairing is broken). Four paired surfaces are checked:

* **routes** — in any module defining a ``_route_request`` dual-wire
  route table, every client ``self._req(method, path)`` call must hit
  a served ``(method, first-segment)`` and every served route must
  have a client caller. Deliberately curl-only surfaces (``/healthz``,
  the ``/debug/*`` endpoints) carry justified suppressions the audit
  keeps honest.
* **frame types** — every member of a ``_FRAME_TYPES`` registry must
  be both *sent* (an argument to a ``send_frame``/``encode_frame``
  call) and *dispatched* (compared against somewhere): a type nobody
  sends is dead protocol surface, a type nobody dispatches poisons the
  peer's connection.
* **codec tags** — module-level ``_T_*`` wire tags must appear in both
  an ``encode*`` and a ``decode*`` function: a tag only the encoder
  knows produces frames the decoder rejects, and a decode-only tag is
  unreachable protocol.
* **typed-error maps** — within a route-table module, every dispatch
  site that maps typed errors to statuses (``except NotFound`` ->
  ``404``) must carry the SAME mapping set as every other dispatch
  site (the JSON handler and the stream handler are two wires over one
  contract), and the client must reconstruct exactly those pairs
  (``status == 404`` -> ``raise NotFound``). The front door's flow
  control rides this check too: ``TooManyRequests -> 429`` (REJECT
  frame on the stream wire) and ``QuotaExceeded -> 403`` must be
  exhaustive across both dispatch sites and client-reconstructed.
* **error-detail keys** — every key the server's ``_error_body()``
  writes into the typed-error payload must be READ somewhere on the
  client side of the module: a detail key the server sends that no
  client code consumes is a one-sided surface (exactly the
  retry-after bug class — the server advises ``retry_after_s``, the
  client's retry policy silently ignores it).
* **forward tables** — a hop module (one assigning
  ``FORWARDED_ROUTES``, i.e. the watch-cache proxy) re-serves the
  route-table module's whole client surface: every first segment a
  package client can reach must appear in ``LOCAL_ROUTES`` or
  ``FORWARDED_ROUTES`` (a segment in neither is a request the hop
  404s that the origin serves — a hole in the hop), and the hop's
  ``_forward()`` must re-raise exactly the typed-error pairs the
  origin's dispatch sites map — anything less degrades a typed error
  to a generic failure crossing the hop, anything more is dead hop
  surface.

Everything is matched by name and structure over the AST — no imports,
no execution — so the fixtures and the real tree are judged alike.

The port's copy of ``kubegpu_tpu/analysis/rules/wire.py``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from kubegpu_tpu_torch.analysis.engine import Context, Finding, SourceFile

ROUTE_TABLE_FN = "_route_request"
CLIENT_REQ = "_req"
ERROR_BODY_FN = "_error_body"
FORWARD_TABLES = ("LOCAL_ROUTES", "FORWARDED_ROUTES")
FORWARD_FN = "_forward"
FRAME_REGISTRY = "_FRAME_TYPES"
SEND_FNS = frozenset({"send_frame", "encode_frame", "send_raw"})
TAG_PREFIX = "_T_"
# broad classes never part of the typed-error contract
UNTYPED = frozenset({"Exception", "BaseException", "OSError"})


class WireContract:
    name = "wire-contract"
    description = ("client routes vs the _route_request table, "
                   "_FRAME_TYPES send vs dispatch, _T_* encode vs "
                   "decode tag sets, typed-error status maps across "
                   "both wires, and the proxy hop's forward tables vs "
                   "the client surface they must cover")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        for src in sources:
            route_fns = [node for node in ast.walk(src.tree)
                         if isinstance(node, ast.FunctionDef)
                         and node.name == ROUTE_TABLE_FN]
            if route_fns:
                yield from self._check_routes(src, route_fns)
                yield from self._check_error_maps(src)
                yield from self._check_error_detail(src)
            yield from self._check_codec_tags(src)
        yield from self._check_frame_types(sources)
        yield from self._check_forward_tables(sources)

    # ---- routes -------------------------------------------------------------

    def _check_routes(self, src: SourceFile,
                      route_fns: List[ast.FunctionDef]) -> Iterator[Finding]:
        served: Dict[str, Set[str]] = {}
        served_lines: Dict[str, int] = {}
        for fn in route_fns:
            _scan_route_table(fn, served, served_lines)
        client: Dict[Tuple[str, str], int] = {}
        for call, method, path in _client_requests(src.tree):
            seg = _first_segment(path)
            if seg is not None:
                client.setdefault((method, seg), call.lineno)
        for (method, seg), lineno in sorted(client.items(),
                                            key=lambda kv: kv[1]):
            methods = served.get(seg)
            if methods is None:
                yield Finding(
                    self.name, src.path, lineno,
                    f"client sends {method} /{seg} but the "
                    f"{ROUTE_TABLE_FN} table serves no /{seg} route — "
                    f"a request with no server counterpart")
            elif methods and method not in methods:
                yield Finding(
                    self.name, src.path, lineno,
                    f"client sends {method} /{seg} but the route table "
                    f"only serves {', '.join(sorted(methods))} for it")
        consumed = {seg for (_m, seg) in client}
        for seg in sorted(served):
            if seg not in consumed:
                yield Finding(
                    self.name, src.path, served_lines[seg],
                    f"route /{seg} is served but has no client caller "
                    f"in this module — a one-sided wire surface (add "
                    f"the client method, or waive a deliberately "
                    f"curl-only endpoint)")

    # ---- frame types --------------------------------------------------------

    def _check_frame_types(self, sources: list) -> Iterator[Finding]:
        registries: List[Tuple[SourceFile, int, List[str]]] = []
        sent: Set[str] = set()
        compared: Set[str] = set()
        for src in sources:
            for node in ast.walk(src.tree):
                if isinstance(node, ast.Assign) and \
                        any(isinstance(t, ast.Name)
                            and t.id == FRAME_REGISTRY
                            for t in node.targets):
                    value = node.value
                    if isinstance(value, ast.Call):
                        # frozenset({REQ, ...}): members live in the
                        # args, not the constructor's name
                        members = [m for arg in value.args
                                   for m in _name_refs(arg)]
                    else:
                        members = _name_refs(value)
                    if members:
                        registries.append((src, node.lineno, members))
                if isinstance(node, ast.Call):
                    fname = None
                    if isinstance(node.func, ast.Attribute):
                        fname = node.func.attr
                    elif isinstance(node.func, ast.Name):
                        fname = node.func.id
                    if fname in SEND_FNS:
                        for arg in node.args:
                            sent.update(_name_refs(arg))
                if isinstance(node, ast.Compare):
                    compared.update(_name_refs(node))
        for src, lineno, members in registries:
            for member in members:
                if member not in sent:
                    yield Finding(
                        self.name, src.path, lineno,
                        f"frame type {member} is registered in "
                        f"{FRAME_REGISTRY} but nothing ever sends it — "
                        f"dead protocol surface, or a sender is missing")
                if member not in compared:
                    yield Finding(
                        self.name, src.path, lineno,
                        f"frame type {member} is registered in "
                        f"{FRAME_REGISTRY} but no reader dispatches on "
                        f"it — a peer sending it poisons the connection")

    # ---- codec tags ---------------------------------------------------------

    def _check_codec_tags(self, src: SourceFile) -> Iterator[Finding]:
        tags: Dict[str, int] = {}
        for node in src.tree.body:
            if isinstance(node, ast.Assign):
                for target in node.targets:
                    if isinstance(target, ast.Name) and \
                            target.id.startswith(TAG_PREFIX) and \
                            isinstance(node.value, ast.Constant):
                        tags[target.id] = node.lineno
        if not tags:
            return
        encoded: Set[str] = set()
        decoded: Set[str] = set()
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            refs = {sub.id for sub in ast.walk(node)
                    if isinstance(sub, ast.Name) and
                    sub.id.startswith(TAG_PREFIX)}
            lowered = node.name.lower()
            if "encode" in lowered:
                encoded |= refs
            if "decode" in lowered:
                decoded |= refs
        for tag, lineno in sorted(tags.items(), key=lambda kv: kv[1]):
            if tag in encoded and tag not in decoded:
                yield Finding(
                    self.name, src.path, lineno,
                    f"wire tag {tag} is produced by an encoder but no "
                    f"decoder handles it — the peer rejects every frame "
                    f"that carries it")
            elif tag in decoded and tag not in encoded:
                yield Finding(
                    self.name, src.path, lineno,
                    f"wire tag {tag} is handled by a decoder but no "
                    f"encoder produces it — unreachable protocol "
                    f"surface (or the encoder half is missing)")

    # ---- typed-error maps ---------------------------------------------------

    def _check_error_maps(self, src: SourceFile) -> Iterator[Finding]:
        server_sites: List[Tuple[str, int, Set[Tuple[str, int]]]] = []
        client_sites: List[Tuple[str, int, Set[Tuple[str, int]]]] = []
        for node in ast.walk(src.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            spairs = _server_error_pairs(node)
            if spairs:
                server_sites.append((node.name, node.lineno, spairs))
            cpairs = _client_error_pairs(node)
            if cpairs:
                client_sites.append((node.name, node.lineno, cpairs))
        if not server_sites:
            return
        union: Set[Tuple[str, int]] = set()
        for _name, _line, pairs in server_sites:
            union |= pairs
        for name, line, pairs in server_sites:
            for exc, status in sorted(union - pairs):
                yield Finding(
                    self.name, src.path, line,
                    f"typed-error mapping {exc} -> {status} is missing "
                    f"from dispatch site {name}() — present on another "
                    f"wire's dispatch, so one wire surfaces a typed "
                    f"error the other turns into a generic failure")
        client_union: Set[Tuple[str, int]] = set()
        for _name, _line, pairs in client_sites:
            client_union |= pairs
        if client_sites:
            for exc, status in sorted(union - client_union):
                yield Finding(
                    self.name, src.path, server_sites[0][1],
                    f"server maps {exc} -> {status} but no client site "
                    f"reconstructs {exc} from status {status} — the "
                    f"typed error degrades to a generic one on the wire")
            for exc, status in sorted(client_union - union):
                yield Finding(
                    self.name, src.path, client_sites[0][1],
                    f"client reconstructs {exc} from status {status} "
                    f"but no dispatch site ever maps it — dead client "
                    f"surface or a missing server mapping")

    # ---- forward tables (the proxy hop) -------------------------------------

    def _check_forward_tables(self, sources: list) -> Iterator[Finding]:
        """Cross-source, like frame types: the client surface and the
        canonical typed-error union come from the route-table modules
        (the ones defining ``_route_request`` — its importers serve the
        SAME table, so they add nothing); each hop module is then held
        to both. kubeclient-style ``_req`` callers speaking a foreign
        wire don't define a route table, so they never leak into the
        surface the hop must cover."""
        client_segs: Dict[str, str] = {}  # first segment -> method
        canonical: Set[Tuple[str, int]] = set()
        saw_origin = False
        for src in sources:
            if not any(isinstance(node, ast.FunctionDef)
                       and node.name == ROUTE_TABLE_FN
                       for node in ast.walk(src.tree)):
                continue
            saw_origin = True
            for _call, method, path in _client_requests(src.tree):
                seg = _first_segment(path)
                if seg is not None:
                    client_segs.setdefault(seg, method)
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                    canonical |= _server_error_pairs(node)
        if not saw_origin:
            return  # no origin in view: nothing to hold a hop against
        for src in sources:
            tables: Dict[str, Set[str]] = {}
            table_line = 0
            for node in src.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                for target in node.targets:
                    if isinstance(target, ast.Name) and \
                            target.id in FORWARD_TABLES:
                        tables[target.id] = _string_members(node.value)
                        if target.id == FORWARD_TABLES[1]:
                            table_line = node.lineno
            if FORWARD_TABLES[1] not in tables:
                continue
            covered: Set[str] = set().union(*tables.values())
            for seg in sorted(set(client_segs) - covered):
                yield Finding(
                    self.name, src.path, table_line,
                    f"client sends {client_segs[seg]} /{seg} but the "
                    f"hop routes it neither locally (LOCAL_ROUTES) nor "
                    f"upstream (FORWARDED_ROUTES) — a hole in the hop: "
                    f"the proxy 404s a request the origin serves")
            hop_pairs: Set[Tuple[str, int]] = set()
            hop_line = table_line
            for node in ast.walk(src.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) and \
                        node.name == FORWARD_FN:
                    hop_pairs |= _client_error_pairs(node)
                    hop_line = node.lineno
            for exc, status in sorted(canonical - hop_pairs):
                yield Finding(
                    self.name, src.path, hop_line,
                    f"origin dispatch maps {exc} -> {status} but the "
                    f"hop's {FORWARD_FN}() never re-raises {exc} from "
                    f"{status} — the typed error degrades to a generic "
                    f"failure crossing the hop")
            for exc, status in sorted(hop_pairs - canonical):
                yield Finding(
                    self.name, src.path, hop_line,
                    f"{FORWARD_FN}() re-raises {exc} from status "
                    f"{status} but no origin dispatch site maps it — "
                    f"dead hop surface, or a missing origin mapping")

    # ---- error-detail keys --------------------------------------------------

    def _check_error_detail(self, src: SourceFile) -> Iterator[Finding]:
        """Every key ``_error_body()`` writes into the typed-error
        payload must be read somewhere OUTSIDE it in the same module
        (``doc.get("key")`` / ``doc["key"]``) — a detail key only the
        server knows is advice the client silently drops."""
        body_fns = [node for node in ast.walk(src.tree)
                    if isinstance(node, ast.FunctionDef)
                    and node.name == ERROR_BODY_FN]
        if not body_fns:
            return
        written: Dict[str, int] = {}
        inside: Set[int] = set()
        for fn in body_fns:
            for node in ast.walk(fn):
                inside.add(id(node))
                if isinstance(node, ast.Dict):
                    for key in node.keys:
                        if isinstance(key, ast.Constant) and \
                                isinstance(key.value, str):
                            written.setdefault(key.value, node.lineno)
                if isinstance(node, ast.Assign):
                    for target in node.targets:
                        if isinstance(target, ast.Subscript) and \
                                isinstance(target.slice, ast.Constant) \
                                and isinstance(target.slice.value, str):
                            written.setdefault(target.slice.value,
                                               target.lineno)
        read: Set[str] = set()
        for node in ast.walk(src.tree):
            if id(node) in inside:
                continue
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "get" and node.args:
                arg0 = node.args[0]
                if isinstance(arg0, ast.Constant) and \
                        isinstance(arg0.value, str):
                    read.add(arg0.value)
            if isinstance(node, ast.Subscript) and \
                    not isinstance(node.ctx, ast.Store) and \
                    isinstance(node.slice, ast.Constant) and \
                    isinstance(node.slice.value, str):
                read.add(node.slice.value)
        for key, lineno in sorted(written.items(), key=lambda kv: kv[1]):
            if key not in read:
                yield Finding(
                    self.name, src.path, lineno,
                    f"error-detail key {key!r} is written by "
                    f"{ERROR_BODY_FN}() but nothing in this module "
                    f"reads it back — server-sent advice the client "
                    f"silently drops (the retry-after bug class)")


# ---- helpers ----------------------------------------------------------------


def _name_refs(node: ast.AST) -> List[str]:
    """Plain or attribute name references under ``node``, by last
    component (``stream.PUSH`` -> ``PUSH``), constants excluded."""
    out: List[str] = []
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name):
            out.append(sub.id)
        elif isinstance(sub, ast.Attribute):
            out.append(sub.attr)
    return out


def _string_members(value: ast.AST) -> Set[str]:
    """String constants in a route-table literal: the members of
    ``frozenset({"pods", ...})`` (a Call wrapping a Set) or a bare
    set/tuple/list literal."""
    return {sub.value for sub in ast.walk(value)
            if isinstance(sub, ast.Constant)
            and isinstance(sub.value, str)}


def _client_requests(tree: ast.AST) \
        -> Iterator[Tuple[ast.Call, str, str]]:
    """Every ``*._req(<method literal>, <path>)`` call, with the path
    resolved through simple local bindings (``path = f"/watch?..."``
    then ``self._req("GET", path)``)."""
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        env: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                head = _literal_head(node.value, env)
                if head is not None:
                    env.setdefault(node.targets[0].id, head)
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            is_req = (isinstance(func, ast.Attribute)
                      and func.attr == CLIENT_REQ) or \
                     (isinstance(func, ast.Name) and func.id == CLIENT_REQ)
            if not is_req or len(node.args) < 2:
                continue
            method = node.args[0]
            if not (isinstance(method, ast.Constant)
                    and isinstance(method.value, str)):
                continue
            path = _literal_head(node.args[1], env)
            if path is not None:
                yield node, method.value, path


def _literal_head(node: ast.AST, env: Dict[str, str]) -> Optional[str]:
    """The leading literal text of a string expression: a constant, an
    f-string's leading constant parts, the left side of ``+`` chains,
    or a name previously bound to one."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        head = ""
        for part in node.values:
            if isinstance(part, ast.Constant) and \
                    isinstance(part.value, str):
                head += part.value
            else:
                break
        return head or None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return _literal_head(node.left, env)
    if isinstance(node, ast.Name):
        return env.get(node.id)
    return None


def _first_segment(path: str) -> Optional[str]:
    path = path.split("?")[0]
    parts = [p for p in path.split("/") if p]
    return parts[0] if parts else None


def _scan_route_table(fn: ast.FunctionDef, served: Dict[str, Set[str]],
                      lines: Dict[str, int]) -> None:
    """Walk a route table function collecting ``(first segment ->
    methods)``. Branch structure carries the segment context downward:
    ``if parts[0] == "nodes":`` establishes the segment for the nested
    ``if method == "GET":`` checks. A loop over ``(("pvcs", ...),
    ("pvs", ...))`` binds its target names to those constants."""
    env: Dict[str, Set[str]] = {}

    def scan(stmts: List[ast.stmt], seg_ctx: Optional[Set[str]]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                _bind_loop_env(stmt, env)
                scan(list(stmt.body), seg_ctx)
                continue
            if isinstance(stmt, ast.If):
                segs = _segments_in_test(stmt.test, env)
                methods = _methods_in_test(stmt.test)
                ctx = segs or seg_ctx
                if ctx:
                    for seg in ctx:
                        entry = served.setdefault(seg, set())
                        entry.update(methods)
                        lines.setdefault(seg, stmt.lineno)
                scan(list(stmt.body), ctx)
                scan(list(stmt.orelse), seg_ctx)
                continue
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    scan([child], seg_ctx)

    scan(list(fn.body), None)


def _bind_loop_env(stmt: "ast.For | ast.AsyncFor",
                   env: Dict[str, Set[str]]) -> None:
    """``for kind, ... in (("pvcs", ...), ("pvs", ...)):`` binds
    ``kind`` to ``{"pvcs", "pvs"}`` for segment resolution."""
    if not isinstance(stmt.iter, (ast.Tuple, ast.List)):
        return
    targets: List[Optional[str]] = []
    if isinstance(stmt.target, ast.Name):
        targets = [stmt.target.id]
    elif isinstance(stmt.target, ast.Tuple):
        targets = [t.id if isinstance(t, ast.Name) else None
                   for t in stmt.target.elts]
    for row in stmt.iter.elts:
        values: List[ast.expr] = [row]
        if isinstance(row, (ast.Tuple, ast.List)):
            values = list(row.elts)
        for i, name in enumerate(targets):
            if name is None or i >= len(values):
                continue
            val = values[i]
            if isinstance(val, ast.Constant) and isinstance(val.value, str):
                env.setdefault(name, set()).add(val.value)


def _segments_in_test(test: ast.AST,
                      env: Dict[str, Set[str]]) -> Set[str]:
    """First-segment constants this test pins ``parts`` to:
    ``parts == ["watch"]``, ``parts[0] == "nodes"``,
    ``parts[:2] == ["debug", "pod"]``, ``parts[0] == kind`` (via the
    loop env)."""
    segs: Set[str] = set()
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1 or \
                not isinstance(node.ops[0], (ast.Eq,)):
            continue
        left, right = node.left, node.comparators[0]
        if not _is_parts_expr(left):
            left, right = right, left
            if not _is_parts_expr(left):
                continue
        first = _first_of_comparand(right, env)
        segs.update(first)
    return segs


def _is_parts_expr(node: ast.AST) -> bool:
    if isinstance(node, ast.Name) and node.id == "parts":
        return True
    if isinstance(node, ast.Subscript) and \
            isinstance(node.value, ast.Name) and node.value.id == "parts":
        sl = node.slice
        if isinstance(sl, ast.Constant) and sl.value == 0:
            return True
        # parts[:2] pins a PREFIX (element 0 is the segment);
        # parts[2:] compares a tail and says nothing about it
        if isinstance(sl, ast.Slice) and sl.lower is None:
            return True
    return False


def _first_of_comparand(node: ast.AST,
                        env: Dict[str, Set[str]]) -> Set[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return {node.value}
    if isinstance(node, (ast.List, ast.Tuple)) and node.elts:
        return _first_of_comparand(node.elts[0], env)
    if isinstance(node, ast.Name):
        return set(env.get(node.id, set()))
    return set()


def _methods_in_test(test: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1 or \
                not isinstance(node.ops[0], ast.Eq):
            continue
        left, right = node.left, node.comparators[0]
        if isinstance(right, ast.Name) and right.id == "method":
            left, right = right, left
        if isinstance(left, ast.Name) and left.id == "method" and \
                isinstance(right, ast.Constant) and \
                isinstance(right.value, str):
            out.add(right.value)
    return out


def _server_error_pairs(fn: ast.AST) -> Set[Tuple[str, int]]:
    """``except NotFound: ... 404 ...`` pairs in one dispatch site."""
    pairs: Set[Tuple[str, int]] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try):
            continue
        for handler in node.handlers:
            if not isinstance(handler.type, (ast.Name, ast.Attribute)):
                continue  # tuples and bare excepts are not typed maps
            exc = handler.type.id if isinstance(handler.type, ast.Name) \
                else handler.type.attr
            if exc in UNTYPED:
                continue
            statuses = {sub.value for stmt in handler.body
                        for sub in ast.walk(stmt)
                        if isinstance(sub, ast.Constant)
                        and isinstance(sub.value, int)
                        and 400 <= sub.value <= 599}
            for status in statuses:
                pairs.add((exc, status))
    return pairs


def _client_error_pairs(fn: ast.AST) -> Set[Tuple[str, int]]:
    """``if status == 404: raise (self._server_error()NotFound(...)``
    pairs in one client site."""
    pairs: Set[Tuple[str, int]] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.If):
            continue
        status = _status_compared(node.test)
        if status is None:
            continue
        for stmt in node.body:
            for sub in ast.walk(stmt):
                if not isinstance(sub, ast.Raise) or sub.exc is None:
                    continue
                exc = _raised_error_name(sub.exc)
                if exc is not None and exc not in UNTYPED:
                    pairs.add((exc, status))
    return pairs


def _status_compared(test: ast.AST) -> Optional[int]:
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare) or len(node.ops) != 1 or \
                not isinstance(node.ops[0], ast.Eq):
            continue
        left, right = node.left, node.comparators[0]
        if isinstance(left, ast.Constant):
            left, right = right, left
        name = left.id if isinstance(left, ast.Name) \
            else left.attr if isinstance(left, ast.Attribute) else None
        if name in ("status", "code") and isinstance(right, ast.Constant) \
                and isinstance(right.value, int) and \
                400 <= right.value <= 599:
            return int(right.value)
    return None


def _raised_error_name(exc: ast.AST) -> Optional[str]:
    """The typed-error class a raise reconstructs: ``raise NotFound(x)``
    or ``raise self._server_error(NotFound, doc)`` (first capitalized
    Name wins)."""
    if isinstance(exc, ast.Call):
        func = exc.func
        if isinstance(func, ast.Name) and func.id[:1].isupper():
            return func.id
        for arg in exc.args:
            if isinstance(arg, ast.Name) and arg.id[:1].isupper():
                return arg.id
        if isinstance(func, ast.Attribute):
            for arg in exc.args:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Name) and \
                            sub.id[:1].isupper():
                        return sub.id
    if isinstance(exc, ast.Name) and exc.id[:1].isupper():
        return exc.id
    return None
