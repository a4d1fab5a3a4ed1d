"""The host-sync rule: device values crossing to the host inside a
per-iteration loop.

The port's counterpart of the host-sync rule of
``kubegpu_tpu/analysis/rules/deviceflow.py``, recast for eager PyTorch. A
forward typestate pass over each function's CFG tracks which local names
and ``self.attr`` tokens hold DEVICE values: results of ``torch.*``
producers, of methods called on a device value, and of the port's
forward/step callables (names bound to what a ``make_*`` factory returns,
as ``self._fstep = make_forward_step(cfg)``); anything derived from a
device value is one too. It flags every sink a device value reaches
inside a per-iteration loop: ``.item()``, ``.tolist()``, ``.cpu()``,
``.numpy()``, ``np.asarray``/``np.array`` of a tensor,
``int()``/``float()``/``bool()``, an ``if``/``while`` test on a tensor
(an implicit ``bool()``), and iterating one. Each is a blocking device
round trip. A sink counts as in a loop when it sits in a loop body, or in
a function that some loop body calls, directly or through other
functions of the scanned tree.

A deliberate readback is waived with
``# host-sync: allowed -- why`` on its line or in the comment block just
above it. A waiver without the ``-- why`` is itself a finding, and one
that covers no sink is stale (the unused-suppression audit reports it
when this rule ran).

``--report`` renders the ranked inventory: each function with a loop,
the sync sites one iteration of its loop reaches (its own and those of
the functions it calls) and the host-to-device uploads
(``torch.tensor``, ``torch.as_tensor``, ``torch.from_numpy``, and
``.to(device)``/``.cuda()`` of a host value), ranked by syncs per
iteration.

Scope: files that import torch and lie under a ``workload`` tree, or a
single file given explicitly. Binaries under ``cmd/`` are paced by the
host by design.
"""

from __future__ import annotations

import ast
import re

from kubegpu_tpu_torch.analysis import dataflow
from kubegpu_tpu_torch.analysis.engine import (Finding, dotted_name,
                                               walk_functions)

WAIVER_RE = re.compile(r"#\s*host-sync:\s*allowed(?P<rest>.*)")

# dotted calls that move a device value to the host
_SINK_CALLS = frozenset({"np.asarray", "numpy.asarray", "np.array",
                         "numpy.array"})
# builtins that force a device scalar onto the host
_SINK_BUILTINS = frozenset({"int", "float", "bool"})
# methods of a device value that read it back
_SINK_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# attribute reads and methods that give host metadata, not device data
_METADATA_ATTRS = frozenset({"shape", "dtype", "ndim", "device", "is_cuda",
                             "requires_grad", "layout", "T", "mT"})
_METADATA_METHODS = frozenset({"size", "dim", "numel", "stride",
                               "data_ptr", "is_contiguous", "element_size",
                               "get_device", "nelement", "is_floating_point"})
# torch.* calls that return host values, or no value, never a tensor
_METADATA_CALLS = frozenset({"torch.is_tensor", "torch.is_floating_point",
                             "torch.device", "torch.Size", "torch.finfo",
                             "torch.iinfo", "torch.get_default_dtype",
                             "torch.no_grad", "torch.inference_mode",
                             "torch.Generator"})
_HOST_PREFIXES = ("torch.cuda.", "torch.distributed.", "torch.backends.",
                  "torch.library.", "torch.utils.", "torch.profiler.")
# uploads: host data to a new device tensor
_H2D_CALLS = frozenset({"torch.tensor", "torch.as_tensor", "torch.from_numpy"})
_H2D_METHODS = frozenset({"to", "cuda"})

# call names never expanded through the per-iteration closure (a call of
# `get` could be anything)
_GENERIC = frozenset({
    "append", "extend", "pop", "popitem", "insert", "remove", "add",
    "get", "items", "keys", "values", "update", "setdefault", "copy",
    "split", "join", "strip", "format", "sum", "min", "max", "len",
    "range", "sorted", "reversed", "zip", "enumerate", "isinstance",
    "int", "float", "bool", "str", "list", "dict", "set", "tuple",
    "abs", "print", "move_to_end", "startswith", "endswith",
})


def _imports_torch(src) -> bool:
    for node in ast.walk(src.tree):
        if isinstance(node, ast.Import):
            if any(a.name == "torch" or a.name.startswith("torch.")
                   for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if mod == "torch" or mod.startswith("torch."):
                return True
    return False


def _in_scope(src) -> bool:
    if not ("workload" in src.relparts or len(src.relparts) == 1):
        return False
    return _imports_torch(src)


def _is_device_arg(expr) -> bool:
    """A ``.to()`` argument that names a device (``dev``, ``self.device``,
    ``"cuda"``), not a dtype."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.startswith("cuda")
    name = dotted_name(expr)
    return name is not None and "dev" in name.rsplit(".", 1)[-1]


class _Sink:
    __slots__ = ("line", "desc", "fn", "in_loop")

    def __init__(self, line: int, desc: str, fn: str) -> None:
        self.line = line
        self.desc = desc
        self.fn = fn
        self.in_loop = False


class _FnInfo:
    __slots__ = ("qualname", "name", "cfg", "sinks", "h2d", "loop_h2d",
                 "loop_lines", "loop_calls", "all_calls")

    def __init__(self, qualname: str) -> None:
        self.qualname = qualname
        self.name = qualname.rsplit(".", 1)[-1]
        self.cfg = None
        self.sinks: list = []         # every _Sink of the function
        self.h2d: list = []           # every upload line
        self.loop_h2d: list = []      # ... the ones inside its own loops
        self.loop_lines: list = []    # header line of each loop
        self.loop_calls: set = set()  # simple call names in loop bodies
        self.all_calls: set = set()   # simple call names anywhere


class _FileModel:
    __slots__ = ("src", "step_keys", "functions", "waivers")

    def __init__(self, src) -> None:
        self.src = src
        self.step_keys: set = set()   # "step", "self._fstep", ...
        self.functions: dict = {}     # qualname -> _FnInfo
        self.waivers: list = []       # (line, justified, covered line)


def _token(expr):
    if isinstance(expr, ast.Name):
        return expr.id
    if isinstance(expr, ast.Attribute) and \
            isinstance(expr.value, ast.Name) and expr.value.id == "self":
        return f"self.{expr.attr}"
    return None


def _collect_step_keys(model) -> None:
    """Names bound to what a ``make_*`` factory returns: the port's
    forward and step callables, whose results live on the device."""
    for node in ast.walk(model.src.tree):
        if not (isinstance(node, ast.Assign) and
                isinstance(node.value, ast.Call)):
            continue
        name = dotted_name(node.value.func) or ""
        if not name.rsplit(".", 1)[-1].startswith("make_"):
            continue
        for tgt in node.targets:
            tok = _token(tgt)
            if tok is not None:
                model.step_keys.add(tok)


def _collect_waivers(model) -> None:
    lines = model.src.text.splitlines()
    for i, text in enumerate(lines, start=1):
        m = WAIVER_RE.search(text)
        if m is None:
            continue
        # a waiver covers its own line (trailing form) or the next code
        # line after its comment block
        cover = i
        for j in range(i, min(i + 8, len(lines))):
            nxt = lines[j].strip()
            if nxt and not nxt.startswith("#"):
                cover = j + 1
                break
        model.waivers.append((i, "--" in m.group("rest"), cover))


class _Typestate:
    """Forward may-analysis: which tokens hold device values at each CFG
    point of one function."""

    def __init__(self, model: _FileModel, info: _FnInfo) -> None:
        self.model = model
        self.info = info
        self.events: list = []  # racer: single-writer -- per-call local
        self._node_idx = -1     # racer: single-writer -- per-call local

    def _sink(self, line: int, desc: str) -> None:
        self.events.append((self._node_idx, _Sink(
            line, desc, self.info.qualname)))

    def _eval(self, expr, state: set, record: bool) -> bool:
        """Evaluate ``expr`` (recording its sinks when ``record``); True
        when its value lives on the device."""
        if isinstance(expr, ast.Name):
            return expr.id in state
        if isinstance(expr, ast.Attribute):
            if expr.attr in _METADATA_ATTRS:
                self._eval(expr.value, state, record)
                return False
            tok = _token(expr)
            if tok is not None:
                return tok in state
            return self._eval(expr.value, state, record)
        if isinstance(expr, ast.Subscript):
            self._eval(expr.slice, state, record)
            return self._eval(expr.value, state, record)
        if isinstance(expr, ast.Call):
            return self._eval_call(expr, state, record)
        if isinstance(expr, ast.BinOp):
            left = self._eval(expr.left, state, record)
            right = self._eval(expr.right, state, record)
            return left or right
        if isinstance(expr, ast.UnaryOp):
            return self._eval(expr.operand, state, record)
        if isinstance(expr, ast.BoolOp):
            return any([self._eval(v, state, record) for v in expr.values])
        if isinstance(expr, ast.Compare):
            vals = [expr.left] + list(expr.comparators)
            return any([self._eval(v, state, record) for v in vals])
        if isinstance(expr, (ast.Tuple, ast.List, ast.Set)):
            return any([self._eval(e, state, record) for e in expr.elts])
        if isinstance(expr, ast.IfExp):
            self._eval(expr.test, state, record)
            a = self._eval(expr.body, state, record)
            b = self._eval(expr.orelse, state, record)
            return a or b
        if isinstance(expr, ast.Starred):
            return self._eval(expr.value, state, record)
        if isinstance(expr, (ast.JoinedStr, ast.FormattedValue)):
            for child in ast.iter_child_nodes(expr):
                self._eval(child, state, record)
            return False
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            # comprehension variables are fresh: evaluate the iterables
            for gen in expr.generators:
                self._eval(gen.iter, state, record)
            return False
        if isinstance(expr, ast.Dict):
            return any([self._eval(v, state, record)
                        for v in list(expr.keys) + list(expr.values)
                        if v is not None])
        return False

    def _eval_call(self, call: ast.Call, state: set, record: bool) -> bool:
        name = dotted_name(call.func)
        args_dev = [self._eval(a, state, record) for a in call.args]
        for kw in call.keywords:
            args_dev.append(self._eval(kw.value, state, record))
        any_dev = any(args_dev)

        if name in _SINK_CALLS or (name in _SINK_BUILTINS and
                                   isinstance(call.func, ast.Name)):
            if any_dev and record:
                self._sink(call.lineno,
                           f"{name}() materializes a device value on host")
            return False
        if isinstance(call.func, ast.Attribute):
            method = call.func.attr
            if method in _SINK_METHODS:
                if self._eval(call.func.value, state, record) and record:
                    self._sink(call.lineno, f".{method}() materializes a "
                               "device value on host")
                return False
            if name is None or not name.startswith("torch."):
                receiver = self._eval(call.func.value, state, record)
                if receiver:
                    return method not in _METADATA_METHODS
                if method in _H2D_METHODS and record and (
                        method == "cuda" or any(
                            _is_device_arg(a) for a in call.args) or any(
                            kw.arg == "device" for kw in call.keywords)):
                    self.events.append((self._node_idx, ("h2d", call.lineno)))
        if name is not None and name.startswith("torch."):
            if name in _METADATA_CALLS or name.startswith(_HOST_PREFIXES):
                return False
            if record and name in _H2D_CALLS and not any_dev:
                self.events.append((self._node_idx, ("h2d", call.lineno)))
            return True
        if _token(call.func) in self.model.step_keys:
            return True
        # any other call: a device value in gives a device value out
        return any_dev

    def _assign_target(self, tgt, dev: bool, state: set) -> None:
        tok = _token(tgt)
        if tok is not None:
            if dev:
                state.add(tok)
            else:
                state.discard(tok)
            return
        if isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._assign_target(el, dev, state)
        # subscript and attribute-chain stores mutate, they do not bind

    def transfer(self, node, state: set, record: bool) -> set:
        state = set(state)
        self._node_idx = node.idx
        stmt = node.stmt
        if stmt is None or node.kind not in ("stmt", "handler"):
            return state
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return state
        if isinstance(stmt, ast.Assign):
            dev = self._eval(stmt.value, state, record)
            # a tuple unpack of one call result: every target inherits
            for tgt in stmt.targets:
                self._assign_target(tgt, dev, state)
            return state
        if isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            dev = self._eval(stmt.value, state, record)
            self._assign_target(stmt.target, dev, state)
            return state
        if isinstance(stmt, ast.AugAssign):
            dev = self._eval(stmt.value, state, record)
            tok = _token(stmt.target)
            if tok is not None and (dev or tok in state):
                state.add(tok)
            return state
        if isinstance(stmt, (ast.If, ast.While)):
            test = stmt.test
            dev = self._eval(test, state, record)
            if dev and self._bare_device_test(test, state) and record:
                self._sink(test.lineno,
                           "branching on a device value forces a blocking "
                           "host sync (implicit bool())")
            return state
        if isinstance(stmt, ast.For) and node.kind == "stmt" and \
                node.effect:
            dev = self._eval(stmt.iter, state, record)
            if dev and _token(stmt.iter) is not None and record:
                self._sink(stmt.iter.lineno,
                           "iterating a device value materializes it on "
                           "host")
            self._assign_target(stmt.target, dev, state)
            return state
        # header sub-expressions for compound statements, the whole
        # statement for simple ones
        for sub in node.effect_asts():
            if isinstance(sub, ast.expr):
                self._eval(sub, state, record)
            elif isinstance(sub, ast.Expr):
                self._eval(sub.value, state, record)
            elif isinstance(sub, ast.Return) and sub.value is not None:
                self._eval(sub.value, state, record)
            elif isinstance(sub, ast.Assert):
                self._eval(sub.test, state, record)
        return state

    @staticmethod
    def _bare_device_test(test, state) -> bool:
        """Only a test that IS a device value (or compares one) blocks;
        ``x is None`` or ``len(x)`` do not."""
        if isinstance(test, ast.Name):
            return test.id in state
        if isinstance(test, ast.Compare):
            return not any(isinstance(op, (ast.Is, ast.IsNot))
                           for op in test.ops)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return _Typestate._bare_device_test(test.operand, state)
        return False

    def run(self) -> None:
        cfg = self.info.cfg
        in_states: dict = {n.idx: set() for n in cfg.nodes}
        work = [cfg.entry.idx]
        out_cache: dict = {}
        while work:
            idx = work.pop()
            node = cfg.nodes[idx]
            out = frozenset(self.transfer(node, in_states[idx], False))
            if out_cache.get(idx) == out:
                continue
            out_cache[idx] = out
            for edge in cfg.succs.get(idx, []):
                dst = edge.dst
                before = len(in_states[dst])
                merged = in_states[dst] | out
                if len(merged) != before or dst not in out_cache:
                    in_states[dst] = merged
                    work.append(dst)
        # record the events with the converged in-states
        for node in cfg.nodes:
            self.transfer(node, in_states[node.idx], True)


def _build_file_model(src) -> _FileModel:
    model = _FileModel(src)
    _collect_step_keys(model)
    _collect_waivers(model)
    # a call through a step callable runs what its factory returned, not
    # a function of the scanned tree that shares its name
    opaque = {k.rsplit(".", 1)[-1] for k in model.step_keys} | _GENERIC
    for qualname, fn in walk_functions(src.tree):
        info = _FnInfo(qualname)
        info.cfg = dataflow.build_cfg(fn)
        ts = _Typestate(model, info)
        ts.run()
        loop_body_nodes: set = set()
        for loop in info.cfg.loops:
            loop_body_nodes |= set(loop.body_nodes)
            loop_body_nodes.add(loop.header)
            info.loop_lines.append(loop.stmt.lineno)
            for idx in loop.body_nodes:
                for sub in info.cfg.nodes[idx].effect_asts():
                    for cname in dataflow.call_names(sub):
                        if cname not in opaque:
                            info.loop_calls.add(cname)
        for node_idx, ev in ts.events:
            in_loop = node_idx in loop_body_nodes
            if isinstance(ev, _Sink):
                ev.in_loop = in_loop
                info.sinks.append(ev)
            else:
                info.h2d.append(ev[1])
                if in_loop:
                    info.loop_h2d.append(ev[1])
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                cname = dotted_name(node.func)
                if cname:
                    simple = cname.rsplit(".", 1)[-1]
                    if simple not in opaque:
                        info.all_calls.add(simple)
        model.functions[qualname] = info
    return model


def _name_map(models) -> dict:
    """simple function name -> [(path, model, _FnInfo)] over every file in
    scope (name-keyed: an over-approximation that needs no config)."""
    by_name: dict = {}
    for path, model in models.items():
        for info in model.functions.values():
            by_name.setdefault(info.name, []).append((path, model, info))
    return by_name


def _expand(seeds: set, by_name: dict) -> frozenset:
    """Transitive closure of callee names through in-scope functions."""
    closure = set(seeds)
    work = list(seeds)
    while work:
        name = work.pop()
        for _, _, info in by_name.get(name, []):
            for callee in info.all_calls:
                if callee not in closure:
                    closure.add(callee)
                    work.append(callee)
    return frozenset(closure)


def _waived(model, line: int) -> bool:
    return any(line in (wline, cover) and justified
               for wline, justified, cover in model.waivers)


class HostSync:
    """Device values crossing to the host inside a per-iteration loop."""

    name = "host-sync"
    description = ("device tensors must not cross to host inside a "
                   "per-token/per-step loop: each sink is a blocking "
                   "round trip; waive with `# host-sync: allowed -- <why>`")

    def run(self, sources, ctx):
        findings: list = []
        models = {s.path: _build_file_model(s)
                  for s in sources if _in_scope(s)}
        by_name = _name_map(models)
        audits = ctx.waiver_audits.setdefault(self.name, [])

        # the per-iteration closure: every function some loop body reaches
        loop_seeds: set = set()
        for model in models.values():
            for info in model.functions.values():
                loop_seeds |= info.loop_calls
        per_iteration = _expand(loop_seeds, by_name)

        report_roots: list = []
        for path, model in sorted(models.items()):
            sink_lines = {s.line for info in model.functions.values()
                          for s in info.sinks}
            for info in model.functions.values():
                for sink in info.sinks:
                    if not (sink.in_loop or info.name in per_iteration):
                        continue
                    if _waived(model, sink.line):
                        continue
                    findings.append(Finding(
                        self.name, path, sink.line,
                        f"{sink.desc} inside a per-iteration loop "
                        f"({info.qualname}); batch the transfer or "
                        "annotate `# host-sync: allowed -- <why>`"))
            for wline, justified, cover in model.waivers:
                if not justified:
                    findings.append(Finding(
                        self.name, path, wline,
                        "host-sync waiver without a justification: "
                        "write `# host-sync: allowed -- <why>`"))
                audits.append({"path": path, "line": wline, "used": bool(
                    {wline, cover} & sink_lines)})
            # one report entry per function with a loop: its own in-loop
            # sinks plus every sink of the functions its loops call
            for info in model.functions.values():
                if not info.cfg.loops:
                    continue
                sites: dict = {}
                for sink in info.sinks:
                    if sink.in_loop:
                        sites[(path, sink.line)] = (sink, model)
                closure = _expand(info.loop_calls, by_name)
                for callee in closure:
                    for cpath, cmodel, cinfo in by_name.get(callee, []):
                        for sink in cinfo.sinks:
                            sites[(cpath, sink.line)] = (sink, cmodel)
                if not sites:
                    continue
                h2d = len(info.loop_h2d)
                for callee in closure:
                    for _, _, cinfo in by_name.get(callee, []):
                        h2d += len(cinfo.h2d)
                report_roots.append({
                    "function": info.qualname,
                    "path": path,
                    "line": info.loop_lines[0],
                    "syncs_per_iteration": len(sites),
                    "h2d_per_iteration": h2d,
                    "sites": [
                        {"path": p, "line": ln, "desc": s.desc,
                         "function": s.fn, "waived": _waived(m, ln)}
                        for (p, ln), (s, m) in sorted(sites.items())],
                })
        report_roots.sort(key=lambda r: (-r["syncs_per_iteration"],
                                         -r["h2d_per_iteration"],
                                         r["path"], r["line"]))
        ctx.reports[self.name] = {"roots": report_roots}
        return findings


def render_report(report: dict) -> str:
    """The host-sync inventory as text (``--report``), ranked by syncs per
    loop iteration."""
    lines = ["host-sync report: host round trips per loop iteration",
             "(rank 1 = the loop paying the most device round trips per "
             "iteration)", ""]
    if not report.get("roots"):
        lines.append("  no per-iteration host syncs found")
        return "\n".join(lines)
    for rank, root in enumerate(report["roots"], start=1):
        lines.append(
            f"  #{rank} {root['function']} ({root['path']}:{root['line']})"
            f" — {root['syncs_per_iteration']} sync(s) + "
            f"{root['h2d_per_iteration']} upload(s) per iteration")
        for site in root["sites"]:
            mark = " [waived]" if site["waived"] else ""
            lines.append(f"       {site['path']}:{site['line']}: "
                         f"{site['desc']} ({site['function']}){mark}")
    return "\n".join(lines)
