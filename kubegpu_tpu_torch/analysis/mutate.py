"""AST mutation engine: prove the differential oracles' kill power.

The port's copy of ``kubegpu_tpu/analysis/mutate.py``, over GPU cards.
The twin rules (``rules/twins.py``) check that the vector/scalar dual
implementations stay *declared and exercised*; this module checks that
the differential oracles would actually *catch* a divergence. It applies
small, deliberately bug-shaped AST mutations to the targeted closure —
``scheduler/vectorized.py``, ``scheduler/cache.py``'s column maintenance
and card canonicalization, ``scheduler/equivalence.py`` store/lookup,
``scheduler/batch.py``'s cycle-local ledger and class pass, and
``scheduler/queue.py``'s batch intake — re-executes each mutated module
**in process** (rebinding cross-module ``from X import Y`` references in
every ``kubegpu_tpu_torch`` module), and runs the differential kill suite
until a check fails. A mutant every check passes is a *survivor*: either
a missing differential assertion (add it) or a real bug (fix it); a
mutant whose behavior is provably unobservable carries a justified entry
in :data:`WAIVERS`.

There is no topology target. The reference mutates its mesh convolution
tables because the masked pass reads them; the port's masked pass reads
nothing of ``topology/``. ``topology/tree.py`` is read only by the device
fit (``scheduler/gpu_scheduler.py``), which the masked pass and the
scalar chain share — a mutant there would move both sides of the
differential at once, which is why the targets leave the scalar oracles
out. So the reference's ``mesh-tables`` check has no counterpart.

The kill suite runs on fake HGX, PCIe and single-card hosts
(``node/fake.py``) advertised through the port's device manager and
codec, pods asking for 1-8 cards (``alpha.gpu/numgpu``), and the port's
engine over its own in-memory API server with the GPU device scheduler.

Operators (tuned to this codebase's bug shapes):

============  ==============================================================
``cmp``       comparison flips: ``<`` <-> ``<=``, ``>`` <-> ``>=``,
              ``==`` <-> ``!=``, ``in`` <-> ``not in``
``boundary``  off-by-one on small integer constants in arithmetic,
              comparisons, shifts, slices and ``range()`` bounds
``maskop``    ``&`` <-> ``|`` on masks (BinOp, AugAssign, and
              ``np.bitwise_and`` <-> ``np.bitwise_or``)
``minmax``    swapped extremum: ``min``/``max``, ``argmin``/``argmax``,
              ``maximum``/``minimum``, ``any``/``all``
``dropcall``  a deleted maintenance statement: generation bumps, column
              updates, memo stores/records, charge-set bookkeeping
              (never a ``probe(...)`` seam of the interleaving explorer)
============  ==============================================================

Mutant IDs are content-addressed — ``<module>.<function>:<op>:<hash>``
over the (operator, original snippet, mutated snippet, ordinal) — so
they survive unrelated line shifts and a fast subset can be pinned
(:data:`PINNED_SMOKE`). ``python -m kubegpu_tpu_torch.analysis --mutate
[--budget-s N]`` runs the sweep; ``--list-mutants`` enumerates without
executing anything.
"""

from __future__ import annotations

import ast
import collections
import hashlib
import itertools
import os
import random
import re
import signal
import sys
import threading
import time
import types
from typing import Any, Callable, Dict, Iterator, List, Optional, Set, Tuple

# Unmutated infrastructure may be imported by name; anything inside the
# mutation targets must be reached through its module object so a
# re-exec'd (mutated or restored) definition is always the one used.
from kubegpu_tpu_torch.analysis.engine import walk_functions
from kubegpu_tpu_torch.core import codec, grammar
from kubegpu_tpu_torch.core.types import (DEVICE_GROUP_PREFIX, ContainerInfo,
                                          NodeInfo, PodInfo)

MUTANT_TIMEOUT_S = 120.0

#: The package whose modules a mutant's cross-module rebinding reaches.
PACKAGE = "kubegpu_tpu_torch"

#: module name -> qualname prefixes whose functions are mutated. A bare
#: class name covers every method; the lists deliberately exclude the
#: scalar oracles (mutating shared code would blind the differential).
TARGETS: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("kubegpu_tpu_torch.scheduler.vectorized", (
        "VectorizedFitPass.run_filter",
        "VectorizedFitPass._compute_rows",
        "VectorizedFitPass._shape_verdict",
        "VectorizedFitPass._remember",
        "VectorizedFitPass._store_mask",
        "_fractions",
        "_kernel_least_requested",
        "_kernel_most_requested",
        "_kernel_balanced",
        "FastPreemptFit.fits",
        "FastPreemptFit.sim_key",
        "FastPreemptFit.might_fit_after_full_eviction",
        "_chips_demand",
        "broadcast_class",
        "_names_card",
    )),
    ("kubegpu_tpu_torch.scheduler.cache", (
        "_FleetColumns",
        "_canonical_paths",
        "card_ids",
        "SchedulerCache._invalidate_locked",
        "SchedulerCache._invalidate_all_locked",
        "SchedulerCache.set_node",
        "SchedulerCache._charge_locked",
        "SchedulerCache.remove_node",
        "SchedulerCache.cycle_snapshot",
    )),
    ("kubegpu_tpu_torch.scheduler.equivalence", (
        "EquivalenceCache",
    )),
    ("kubegpu_tpu_torch.scheduler.batch", (
        "CapacityLedger",
        "ClassPass",
        "batch_class",
        "pod_chip_demand",
        "free_chip_count",
        "open_class_pass",
        "refresh_class_pass",
        "pick_host",
        "scores_decompose",
    )),
    ("kubegpu_tpu_torch.scheduler.queue", (
        "SchedulingQueue.push_many",
        "SchedulingQueue.pop_many",
    )),
)

#: Equivalent mutants: behavior provably unobservable through any
#: differential oracle, each with its justification (rendered in the
#: report; audited by tests/test_torch_mutate.py against the live ids).
WAIVERS: Dict[str, str] = {
    "vectorized.run_filter:cmp:34408c08":
        "the mask memo's memo['n'] == n test is redundant with its epoch "
        "test: every membership change rebuilds the columns and bumps the "
        "epoch, so an equal epoch already means an equal row count and "
        "the n compare never decides a reuse",
    "vectorized.run_filter:maskop:6a3d05fb":
        "elig | valid widens reuse only onto rows outside the mask "
        "(tainted, volume-heavy or nominated hosts): a taint or a placed "
        "volume moves the host's generation, so only nominated rows can "
        "match, and run_filter hands those back in scalar_names, whose "
        "scalar verdicts find_nodes_that_fit writes over the reused "
        "ones; the difference is one extra counted hit",
    "vectorized._store_mask:boundary:c0bc97c4":
        "the -1 that fills a fresh memo's generation array is shadowed "
        "by its valid mask: a row is reused only after a store wrote both "
        "its valid bit and its generation, so -2 never reaches a compare",
    "vectorized._store_mask:boundary:5c2d189c":
        "the same valid-mask shadowing as the -2 variant; host "
        "generations start at 1 (the first registration bumps), so even "
        "a 0 fill could not collide with a live generation",
    "vectorized.might_fit_after_full_eviction:cmp:a351a73a":
        "the chips_needed <= 0 early return is a shortcut: a demand of "
        "0 cards makes the general free + evictable >= demand test true "
        "as well, and the demand is never negative",
    "vectorized.might_fit_after_full_eviction:boundary:af2235de":
        "the same zero-demand shortcut: with the bound at -1 a 0-card "
        "demand falls through to free + evictable >= 0, which is true",
    "cache.view:cmp:b0a5824c":
        "the delta view is an optimization of the full one: _rebuild "
        "clears the cached view whenever it bumps the epoch, so a cached "
        "view always carries the current epoch, and the flipped test "
        "only ever takes the full (always correct) view",
    "cache._invalidate_locked:boundary:5da31794":
        "generations only need to move strictly upward: every consumer "
        "compares them for equality or order, so a bump of 2 reads "
        "exactly like a bump of 1",
    "cache._invalidate_all_locked:boundary:7a45e8f2":
        "the same monotonicity argument as the one-host bump",
    "cache.remove_node:dropcall:d67a34a0":
        "a re-registered host always bumps through set_node's "
        "first-registration path (old_labels is None), so a pass holding "
        "the pre-removal generation is never served a store made after "
        "the re-add; the removal-time bump is a second guard",
    "cache.remove_node:dropcall:4ca211ba":
        "equivalence.drop_node frees memory only: staleness rides on the "
        "generation, which outlives the host, so entries it would have "
        "dropped can never be served",
    "cache._charge_locked:dropcall:8fbfcccf":
        "the vanished-host release un-mark is unreachable: remove_node "
        "already un-marks every pod of a departing host, so a release "
        "for a host that is gone never finds its pod still marked",
    "cache.cycle_snapshot:cmp:d7f8b98b":
        "the snapshot's generation compare is a second guard: every "
        "bump pops or clears the host's _snap entry under the same lock, "
        "so a cached snapshot with a stale generation never exists",
    "equivalence.lookup_many:cmp:f0936fe9":
        "the guard only skips a zero increment of the misses counter, "
        "and inc(0) changes nothing",
    "queue.pop_many:cmp:0b349004":
        "remaining is a monotonic-clock difference, strictly negative "
        "once the deadline passes: the instant it is exactly 0 cannot be "
        "observed, and the next loop turn returns either way",
    "queue.pop_many:minmax:2bfbf42c":
        "the wait chunk only sets how often a spurious wake-up polls: a "
        "push notifies the condition and wakes the waiter either way, "
        "and the deadline test still bounds the return, so min and max "
        "differ by at most one poll interval",
}

#: Fast subset (the mutation smoke): one representative per module x
#: operator family with a killable mutant (queue's one minmax mutant is
#: waived), each killed by a model check before the engine-driven
#: differentials — except the masked pass's dropped maintenance call,
#: which only an engine's warm pass (mask-memo) can see. Re-pin with
#: --list-mutants after editing a target.
PINNED_SMOKE: List[str] = [
    "vectorized._remember:cmp:49027822",         # memo bound flip
    "vectorized._remember:boundary:1cf83e54",    # eviction share off by one
    "vectorized._kernel_balanced:maskop:6d9eed74",  # score kernel drift
    "vectorized._remember:minmax:71ad1ae8",      # eviction floor flip
    "vectorized.run_filter:dropcall:bd4dcce8",   # reuse never counted
    "cache.set_node:cmp:6eb072e1",               # Ready-gate flip
    "cache._invalidate_locked:boundary:ef198049",  # generation stalls
    "cache._delta_view:maskop:1fd2059b",         # gen-only rows dropped
    "cache.set_node:minmax:71f7d7b9",            # taint any <-> all
    "cache.set_node:dropcall:f3a8c4fe",          # dropped column update
    "equivalence.lookup:cmp:a798df36",           # generation serving flip
    "batch.batch_class:cmp:aa1011d1",            # class-key routing flip
    "batch.pick_host:boundary:116c9a75",         # single-host fast path
    "batch.free_chip_count:minmax:84361069",     # free cards go negative
    "batch.note_award:dropcall:fa03ddf1",        # award never charged
    "queue.push_many:cmp:e913a200",              # lost queue-wait start
    "queue.pop_many:boundary:b6a2e98b",          # drain-bound off by one
]


class MutationError(RuntimeError):
    """The engine itself failed (source drift between enumerate and
    apply, unknown mutant id, missing numpy)."""


# ---- target discovery -------------------------------------------------------


_functions = walk_functions


def _matches(qual: str, prefixes: Tuple[str, ...]) -> bool:
    return any(qual == p or qual.startswith(p + ".") for p in prefixes)


def _module_tree(module_name: str) -> Tuple[types.ModuleType, ast.Module]:
    import importlib

    module = importlib.import_module(module_name)
    path = module.__file__
    if path is None:
        raise MutationError(f"{module_name} has no source file")
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    return module, tree


# ---- operators --------------------------------------------------------------


class _Site:
    __slots__ = ("op", "qualname", "lineno", "before", "after", "apply")

    def __init__(self, op: str, qualname: str, lineno: int, before: str,
                 after: str, apply: Callable[[], None]) -> None:
        self.op = op
        self.qualname = qualname
        self.lineno = lineno
        self.before = before
        self.after = after
        self.apply = apply


def _own_walk(fn: ast.AST) -> Iterator[ast.AST]:
    """ast.walk order, but nested function/class definitions belong to
    their own target entry (avoid double-mutating), and annotation
    subtrees are skipped — under ``from __future__ import annotations``
    they are never evaluated, so mutating them yields junk equivalent
    mutants (``dict | None`` is not a runtime ``|``)."""
    work = collections.deque(ast.iter_child_nodes(fn))
    skip: Set[int] = set()
    for node in ast.walk(fn):
        ann = getattr(node, "annotation", None)
        if ann is not None:
            skip.update(id(sub) for sub in ast.walk(ann))
        ret = getattr(node, "returns", None)
        if ret is not None:
            skip.update(id(sub) for sub in ast.walk(ret))
    while work:
        node = work.popleft()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) or id(node) in skip:
            continue
        yield node
        work.extend(ast.iter_child_nodes(node))


def _parents(fn: ast.AST) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(fn):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


_CMP_SWAP: Dict[type, type] = {
    ast.Lt: ast.LtE, ast.LtE: ast.Lt,
    ast.Gt: ast.GtE, ast.GtE: ast.Gt,
    ast.Eq: ast.NotEq, ast.NotEq: ast.Eq,
    ast.In: ast.NotIn, ast.NotIn: ast.In,
}

_BIT_SWAP: Dict[type, type] = {ast.BitAnd: ast.BitOr, ast.BitOr: ast.BitAnd}

_NAME_SWAP: Dict[str, str] = {
    "min": "max", "max": "min",
    "argmin": "argmax", "argmax": "argmin",
    "maximum": "minimum", "minimum": "maximum",
    "any": "all", "all": "any",
    "bitwise_and": "bitwise_or", "bitwise_or": "bitwise_and",
}

#: Statement calls ``dropcall`` deletes. The explorer's ``probe(...)``
#: seams are not among them: a seam has no effect outside an exploration.
_DROP_CALLS = frozenset({
    "set_gen", "bump_all_gens", "charge", "set_node", "drop", "_write_row",
    "_invalidate_locked", "_invalidate_all_locked", "drop_node",
    "store", "store_many", "record", "add", "discard", "_rebuild",
})

_MAX_BOUNDARY_CONST = 64


def _terminal(func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _clip(text: str, limit: int = 90) -> str:
    text = " ".join(text.split())
    return text if len(text) <= limit else text[:limit - 3] + "..."


def _sites_cmp(qual: str, fn: ast.AST) -> Iterator[_Site]:
    for node in _own_walk(fn):
        if not isinstance(node, ast.Compare):
            continue
        for i, op in enumerate(node.ops):
            new_cls = _CMP_SWAP.get(type(op))
            if new_cls is None:
                continue

            def apply(node: ast.Compare = node, i: int = i,
                      new_cls: type = new_cls) -> None:
                node.ops[i] = new_cls()

            yield _Site("cmp", qual, node.lineno, _clip(ast.unparse(node)),
                        f"{type(op).__name__}->{new_cls.__name__}", apply)


def _sites_boundary(qual: str, fn: ast.AST) -> Iterator[_Site]:
    parents = _parents(fn)
    for node in _own_walk(fn):
        if not (isinstance(node, ast.Constant)
                and type(node.value) is int
                and abs(node.value) <= _MAX_BOUNDARY_CONST):
            continue
        parent = parents.get(id(node))
        numeric = isinstance(parent, (ast.BinOp, ast.Compare, ast.Slice,
                                      ast.UnaryOp)) or (
            isinstance(parent, ast.Call)
            and _terminal(parent.func) in ("range", "islice"))
        if not numeric:
            continue
        ctx = _clip(ast.unparse(parent if parent is not None else node))
        for delta in (1, -1):
            def apply(node: ast.Constant = node,
                      delta: int = delta) -> None:
                node.value = node.value + delta

            yield _Site("boundary", qual, node.lineno, ctx,
                        f"{node.value}->{node.value + delta}", apply)


def _sites_maskop(qual: str, fn: ast.AST) -> Iterator[_Site]:
    for node in _own_walk(fn):
        if isinstance(node, (ast.BinOp, ast.AugAssign)):
            new_cls = _BIT_SWAP.get(type(node.op))
            if new_cls is not None:
                def apply(node: Any = node, new_cls: type = new_cls) -> None:
                    node.op = new_cls()

                yield _Site("maskop", qual, node.lineno,
                            _clip(ast.unparse(node)),
                            f"{type(node.op).__name__}->{new_cls.__name__}",
                            apply)
        elif isinstance(node, ast.Call):
            name = _terminal(node.func)
            if name in ("bitwise_and", "bitwise_or"):
                yield from _swap_call_name(qual, node, "maskop")


def _sites_minmax(qual: str, fn: ast.AST) -> Iterator[_Site]:
    for node in _own_walk(fn):
        if isinstance(node, ast.Call):
            name = _terminal(node.func)
            if name in _NAME_SWAP and name not in ("bitwise_and",
                                                   "bitwise_or"):
                yield from _swap_call_name(qual, node, "minmax")


def _swap_call_name(qual: str, node: ast.Call, op: str) -> Iterator[_Site]:
    name = _terminal(node.func)
    if name is None:
        return
    new = _NAME_SWAP[name]

    def apply(node: ast.Call = node, new: str = new) -> None:
        if isinstance(node.func, ast.Name):
            node.func.id = new
        else:
            assert isinstance(node.func, ast.Attribute)
            node.func.attr = new

    yield _Site(op, qual, node.lineno, _clip(ast.unparse(node)),
                f"{name}->{new}", apply)


def _sites_dropcall(qual: str, fn: ast.AST) -> Iterator[_Site]:
    for holder in itertools.chain([fn], _own_walk(fn)):
        for field in ("body", "orelse", "finalbody"):
            stmts = getattr(holder, field, None)
            if not isinstance(stmts, list):
                continue
            for i, stmt in enumerate(stmts):
                if not (isinstance(stmt, ast.Expr)
                        and isinstance(stmt.value, ast.Call)):
                    continue
                name = _terminal(stmt.value.func)
                if name not in _DROP_CALLS:
                    continue

                def apply(stmts: List[ast.stmt] = stmts,
                          stmt: ast.stmt = stmt) -> None:
                    idx = stmts.index(stmt)
                    stmts[idx] = ast.copy_location(ast.Pass(), stmt)

                yield _Site("dropcall", qual, stmt.lineno,
                            _clip(ast.unparse(stmt)), "deleted", apply)


_OPERATORS: Tuple[Callable[[str, ast.AST], Iterator[_Site]], ...] = (
    _sites_cmp, _sites_boundary, _sites_maskop, _sites_minmax,
    _sites_dropcall,
)


# ---- enumeration ------------------------------------------------------------


class MutantRef:
    __slots__ = ("mutant_id", "module", "qualname", "op", "lineno",
                 "before", "after")

    def __init__(self, mutant_id: str, module: str, qualname: str, op: str,
                 lineno: int, before: str, after: str) -> None:
        self.mutant_id = mutant_id
        self.module = module
        self.qualname = qualname
        self.op = op
        self.lineno = lineno
        self.before = before
        self.after = after

    def describe(self) -> Dict[str, Any]:
        return {"id": self.mutant_id, "module": self.module,
                "function": self.qualname, "op": self.op,
                "line": self.lineno, "before": self.before,
                "after": self.after}


def _enumerate_sites(module_name: str,
                     tree: ast.Module) -> List[_Site]:
    prefixes = dict(TARGETS)[module_name]
    sites: List[_Site] = []
    for qual, fn in _functions(tree):
        if not _matches(qual, prefixes):
            continue
        for operator in _OPERATORS:
            sites.extend(operator(qual, fn))
    return sites


def _refs_for(module_name: str, sites: List[_Site]) -> List[MutantRef]:
    short = module_name.rsplit(".", 1)[-1]
    dup: Dict[Tuple[str, str, str, str], int] = {}
    refs: List[MutantRef] = []
    for site in sites:
        key = (site.op, site.qualname, site.before, site.after)
        ordinal = dup.get(key, 0)
        dup[key] = ordinal + 1
        blob = "|".join((site.op, site.qualname, site.before, site.after,
                         str(ordinal)))
        digest = hashlib.sha1(blob.encode()).hexdigest()[:8]
        fn = site.qualname.rsplit(".", 1)[-1]
        refs.append(MutantRef(f"{short}.{fn}:{site.op}:{digest}",
                              module_name, site.qualname, site.op,
                              site.lineno, site.before, site.after))
    return refs


def enumerate_mutants() -> List[MutantRef]:
    """Every mutant over the targeted closure, deterministic order and
    content-addressed IDs (stable under unrelated source edits)."""
    out: List[MutantRef] = []
    for module_name, _prefixes in TARGETS:
        _module, tree = _module_tree(module_name)
        out.extend(_refs_for(module_name, _enumerate_sites(module_name,
                                                           tree)))
    return out


# ---- in-process application -------------------------------------------------


def _in_package(module_name: str) -> bool:
    """The package itself or one of its modules — never the reference
    package, whose name is a prefix of this one's."""
    return module_name == PACKAGE or module_name.startswith(PACKAGE + ".")


class ModulePatch:
    """One applied mutant: the target module re-executed with the
    mutated tree, and every ``from X import Y`` alias of a replaced
    top-level class/function rebound across the package. ``restore()``
    reverts both."""

    def __init__(self, module: types.ModuleType, tree: ast.Module) -> None:
        self._module = module
        self._snapshot = dict(module.__dict__)
        self._rebinds: List[Tuple[types.ModuleType, str, Any]] = []
        code = compile(tree, module.__file__ or "<mutant>", "exec")
        exec(code, module.__dict__)
        self._crossref()

    def _crossref(self) -> None:
        for name, old in self._snapshot.items():
            new = self._module.__dict__.get(name)
            if new is old or not isinstance(
                    old, (type, types.FunctionType)):
                continue
            for mod_name, mod in list(sys.modules.items()):
                if mod is None or mod is self._module or \
                        not _in_package(mod_name):
                    continue
                mod_dict = getattr(mod, "__dict__", None)
                if mod_dict is None:
                    continue
                for attr, val in list(mod_dict.items()):
                    if val is old:
                        self._rebinds.append((mod, attr, old))
                        mod_dict[attr] = new

    def restore(self) -> None:
        self._module.__dict__.clear()
        self._module.__dict__.update(self._snapshot)
        for mod, attr, old in self._rebinds:
            mod.__dict__[attr] = old


def apply_mutant(ref: MutantRef) -> ModulePatch:
    """Parse the target module fresh, re-derive the sites of the mutant's
    function (an id's hash inputs, the ordinal included, depend on that
    function's sites alone), apply the one with the mutant's id and
    re-exec in process. Raises :class:`MutationError` if the source
    drifted since enumeration."""
    module, tree = _module_tree(ref.module)
    sites = [site for qual, fn in _functions(tree) if qual == ref.qualname
             for operator in _OPERATORS for site in operator(qual, fn)]
    for site, again in zip(sites, _refs_for(ref.module, sites)):
        if again.mutant_id == ref.mutant_id:
            site.apply()
            return ModulePatch(module, tree)
    raise MutationError(f"{ref.mutant_id}: no such site in "
                        f"{ref.qualname} (source changed since "
                        f"enumeration?)")


def find_mutant(mutant_id: str,
                refs: Optional[List[MutantRef]] = None) -> MutantRef:
    for ref in refs if refs is not None else enumerate_mutants():
        if ref.mutant_id == mutant_id:
            return ref
    raise MutationError(f"unknown mutant id {mutant_id!r}")


# ---- the differential kill suite -------------------------------------------
#
# Ordered cheap-first. Each check raises on divergence (any exception =
# killed). Checks reach mutated code only through module objects, and
# every oracle recomputation is independent of the mutated functions.


def _np() -> Any:
    try:
        import numpy
    except ImportError as e:  # pragma: no cover - numpy ships in the image
        raise MutationError("mutation sweep requires numpy") from e
    return numpy


def _cache_mod() -> Any:
    from kubegpu_tpu_torch.scheduler import cache
    return cache


def _equiv_mod() -> Any:
    from kubegpu_tpu_torch.scheduler import equivalence
    return equivalence


def _vec_mod() -> Any:
    from kubegpu_tpu_torch.scheduler import vectorized
    return vectorized


def _device_scheduler() -> Any:
    from kubegpu_tpu_torch.scheduler.registry import build_device_scheduler

    return build_device_scheduler()


def _api() -> Any:
    from kubegpu_tpu_torch.cluster.apiserver import InMemoryAPIServer

    return InMemoryAPIServer()


G = DEVICE_GROUP_PREFIX


def _gpu_node(name: str, host: int, kind: str = "hgx", cpu: str = "8",
              failed: Tuple[int, ...] = (),
              taints: Optional[List[dict]] = None,
              unschedulable: bool = False,
              conditions: Optional[List[dict]] = None) -> dict:
    """A node advertising fake ``kind`` host ``host``'s cards through the
    port's device manager, as the node agent writes it; the cards at the
    indices in ``failed`` stay in capacity and leave allocatable."""
    from kubegpu_tpu_torch.node import fake
    from kubegpu_tpu_torch.node.backend import CHIP_FAILED
    from kubegpu_tpu_torch.node.manager import GPUDeviceManager

    inv = {"hgx": fake.hgx_h100_inventory, "pcie": fake.pcie_h100_inventory,
           "rig": fake.rig_inventory}[kind](host)
    backend = fake.FakeGPUBackend(inv)
    for i in failed:
        backend.set_chip_health(inv.gpus[i].uuid, CHIP_FAILED)
    info = NodeInfo(name=name)
    GPUDeviceManager(backend).update_node_info(info)
    meta = {"name": name}
    codec.node_info_to_annotation(meta, info)
    node: dict = {"metadata": meta,
                  "status": {"allocatable": {"cpu": cpu, "pods": 100}}}
    spec: dict = {}
    if taints:
        spec["taints"] = taints
    if unschedulable:
        spec["unschedulable"] = True
    if spec:
        node["spec"] = spec
    if conditions:
        node["status"]["conditions"] = conditions
    return node


def _card_paths(node: dict) -> List[str]:
    """The node's allocatable card leaves (``.../gpu/<UUID>/cards``)."""
    info = codec.annotation_to_node_info(node.get("metadata") or {})
    return sorted(p for p in info.allocatable
                  if grammar.gpu_id_from_path(p) is not None)


def _gpu_pod(name: str, cards: int, priority: int = 0,
             cpu: str = "1") -> dict:
    pi = PodInfo(name=name)
    pi.running_containers["main"] = ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: cards})
    meta = {"name": name}
    codec.pod_info_to_annotation(meta, pi)
    return {"metadata": meta,
            "spec": {"priority": priority,
                     "containers": [{"name": "main",
                                     "resources": {
                                         "requests": {"cpu": cpu}}}]}}


def _pinned_pod(name: str, node_name: str, path: str,
                priority: int = 0) -> dict:
    """A pod whose device annotation pins card leaf ``path`` of
    ``node_name``: an identity-specific request."""
    pinned = PodInfo(name=name, node_name=node_name)
    pinned.running_containers["main"] = ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: 1},
        dev_requests={path: 1}, allocate_from={path: path})
    meta = {"name": name}
    codec.pod_info_to_annotation(meta, pinned)
    return {"metadata": meta,
            "spec": {"priority": priority,
                     "containers": [{"name": "main", "resources": {
                         "requests": {"cpu": "1"}}}]}}


def _with_env(values: Dict[str, str], build: Callable[[], Any]) -> Any:
    """``build()`` with the engine's kill switches set to ``values``,
    which it reads when an engine is built; the environment as it was
    afterwards."""
    saved = {key: os.environ.get(key) for key in values}
    try:
        os.environ.update(values)
        return build()
    finally:
        for key, old in saved.items():
            if old is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = old


def _engine(api: Any, vectorize: bool, batch: bool = True) -> Any:
    from kubegpu_tpu_torch.scheduler.core import Scheduler

    return _with_env(
        {"KGTPU_VECTORIZE": "1" if vectorize else "0",
         "KGTPU_BATCH": "1" if batch else "0"},
        lambda: Scheduler(api, _device_scheduler()))


def _schedulers(api: Any) -> Tuple[Any, Any]:
    """(vectorized, scalar) engines over one API server."""
    vec = _engine(api, True)
    scalar = _engine(api, False)
    if vec.generic.vector is None:
        raise MutationError("vectorized engine unavailable (numpy?)")
    return vec, scalar


def _placements(api: Any, names: List[str]) -> Dict[str, Any]:
    """Each pod's ``(nodeName, sorted allocated card leaves)``, or
    ``"preempted"`` for a pod that is gone."""
    from kubegpu_tpu_torch.cluster.apiserver import NotFound

    out: Dict[str, Any] = {}
    for name in names:
        try:
            pod = api.get_pod(name)
        except (NotFound, KeyError):
            out[name] = "preempted"
            continue
        cards: List[str] = []
        pi = codec.annotation_to_pod_info(pod.get("metadata") or {})
        for cont in pi.running_containers.values():
            cards.extend(sorted(cont.allocate_from.values()))
        out[name] = ((pod.get("spec") or {}).get("nodeName"), tuple(cards))
    return out


# -- oracle recomputations (deliberately independent of the targets) ---------

_CARD_RE = re.compile(r"^(.*/" + grammar.GPU_LEAF + r"/)([^/]+)(/[^/]+)$")


def _oracle_canonical(allocatable: Dict[str, int]) -> Dict[str, str]:
    """Reference re-implementation of cache._canonical_paths — the
    independent oracle the mirror check compares against: every card
    attribute path (``.../gpu/<UUID>/<suffix>``) with its UUID replaced
    by the UUID's position among the node's UUIDs in sorted order."""
    parsed: Dict[str, Tuple[str, str, str]] = {}
    for res in allocatable:
        m = _CARD_RE.match(res)
        if m is not None:
            parsed[res] = (m.group(1), m.group(2), m.group(3))
    uuids = sorted({uuid for _head, uuid, _tail in parsed.values()})
    return {res: f"{head}{uuids.index(uuid)}{tail}"
            for res, (head, uuid, tail) in parsed.items()}


def _free_cards(node_ex: Any) -> int:
    return sum(
        max(node_ex.allocatable.get(p, 0) - node_ex.used.get(p, 0), 0)
        for p in node_ex.allocatable
        if grammar.gpu_id_from_path(p) is not None)


def _verify_columns(cache: Any, cols: Any) -> None:
    """Every column field vs a from-scratch recomputation off the
    CachedNode objects — the scalar oracle for the fleet mirror."""
    np = _np()
    assert cols is not None, "columnar view unavailable"
    assert cols.names == sorted(cache.nodes), "view membership drift"
    for i, name in enumerate(cols.names):
        cached = cache.nodes[name]
        kube = cached.kube_node
        spec = kube.get("spec") or {}
        conditions = (kube.get("status") or {}).get("conditions") or []
        assert bool(cols.unschedulable[i]) == bool(
            spec.get("unschedulable")), (name, "unschedulable")
        notready = sum(1 for c in conditions
                       if c.get("type") == "Ready"
                       and c.get("status") != "True")
        assert int(cols.n_notready[i]) == notready, (name, "n_notready")
        assert bool(cols.mem_pressure[i]) == any(
            c.get("type") == "MemoryPressure" and c.get("status") == "True"
            for c in conditions), (name, "mem_pressure")
        assert bool(cols.disk_pressure[i]) == any(
            c.get("type") == "DiskPressure" and c.get("status") == "True"
            for c in conditions), (name, "disk_pressure")
        assert bool(cols.tainted[i]) == any(
            t.get("effect") in ("NoSchedule", "NoExecute")
            for t in spec.get("taints") or []), (name, "tainted")
        node_ex = cached.node_ex
        assert int(cols.free_chips[i]) == _free_cards(node_ex), \
            (name, "free cards")
        assert bool(cols.vol_heavy[i]) == bool(cached.pod_volumes), \
            (name, "vol_heavy")
        want_prio = min(cached.pod_priorities.values()) \
            if cached.pod_priorities else 2 ** 62
        assert int(cols.min_pod_priority[i]) == want_prio, \
            (name, "min_pod_priority")
        assert int(cols.gen[i]) == cache.node_generation(name), \
            (name, "generation")
        core_alloc = cached.core_allocatable()
        for res, arr in cols.core_alloc.items():
            want = core_alloc.get(res)
            if want is None:
                assert np.isnan(arr[i]), (name, res, "core_alloc nan")
            else:
                assert arr[i] == want, (name, res, "core_alloc")
        for res, arr in cols.core_req.items():
            assert arr[i] == cached.requested_core.get(res, 0), \
                (name, res, "core_req")
        canon = _oracle_canonical(node_ex.allocatable)
        assert cols.canon_maps[i] == canon, (name, "canonical paths")
        want_key = tuple(sorted(
            (canon.get(k, k), v) for k, v in node_ex.used.items() if v))
        assert cols.dev_fps[i][1] == want_key, (name, "used_key")


# -- the checks ---------------------------------------------------------------


def _check_equivalence_model() -> None:
    """EquivalenceCache vs a transparent dict model: generation
    serving, monotonic stores, nomination fingerprints, batch forms,
    hit/miss accounting, node drop, and the per-node bound."""
    eq_mod = _equiv_mod()
    eq = eq_mod.EquivalenceCache()
    assert eq.lookup("n1", "c1", 5) is None
    eq.store("n1", "c1", 5, ("ok", [], 1.0))
    assert eq.lookup("n1", "c1", 5) == ("ok", [], 1.0)
    assert eq.lookup("n1", "c1", 6) is None, "stale generation served"
    assert (eq.hits, eq.misses) == (1, 2), "hit/miss accounting drift"
    eq.record(3, 2)
    assert (eq.hits, eq.misses) == (4, 4), "record() accounting drift"
    # monotonic-store guard: a slow pass must not clobber fresher state
    eq.store("n1", "c1", 9, ("new", [], 2.0))
    eq.store("n1", "c1", 7, ("old", [], 0.0))
    assert eq.lookup("n1", "c1", 9, record=False) == ("new", [], 2.0)
    # record=False peeks must not move the counters
    before = (eq.hits, eq.misses)
    eq.lookup("n1", "c1", 9, record=False)
    eq.lookup_many("c1", {"n1": 9, "n2": 1}, {}, record=False)
    assert (eq.hits, eq.misses) == before, "record=False moved counters"
    # nomination fingerprints partition the key space
    eq.store("n1", "c1", 9, ("nom", [], 3.0), nom_fp=("p1",))
    assert eq.lookup("n1", "c1", 9, nom_fp=("p1",),
                     record=False) == ("nom", [], 3.0)
    assert eq.lookup("n1", "c1", 9, record=False) == ("new", [], 2.0)
    # batch store/lookup agree with the scalar forms
    eq.store_many("c2", {"n1": ("a", [], 0.0), "n2": ("b", [], 0.0)},
                  {"n1": 3, "n2": 4})
    got = eq.lookup_many("c2", {"n1": 3, "n2": 9, "n3": 1}, {},
                         record=False)
    assert got == {"n1": ("a", [], 0.0)}, "lookup_many generation filter"
    assert eq.lookup("n2", "c2", 4, record=False) == ("b", [], 0.0)
    # store_many honors the monotonic guard too
    eq.store_many("c2", {"n1": ("stale", [], 0.0)}, {"n1": 2})
    assert eq.lookup("n1", "c2", 3, record=False) == ("a", [], 0.0)
    eq.drop_node("n1")
    assert eq.lookup("n1", "c2", 3, record=False) is None, \
        "drop_node left entries behind"
    # per-node class bound: oldest evicted, newest kept
    bound = eq_mod.MAX_CLASSES_PER_NODE
    for i in range(bound + 1):
        eq.store("nb", f"cls{i}", 1, (i, [], 0.0))
    assert eq.lookup("nb", "cls0", 1, record=False) is None, \
        "per-node bound not enforced"
    assert eq.lookup("nb", f"cls{bound}", 1,
                     record=False) == (bound, [], 0.0)
    # equal-generation stores OVERWRITE (only a strictly newer existing
    # entry refuses): the verdict-recompute paths rely on it
    eq.store("ng", "c", 5, ("first", [], 0.0))
    eq.store("ng", "c", 5, ("second", [], 0.0))
    assert eq.lookup("ng", "c", 5, record=False) == ("second", [], 0.0), \
        "equal-generation store must overwrite"
    eq.store_many("ng", {"nm": ("a", [], 0.0)}, {"nm": 5})
    eq.store_many("ng", {"nm": ("b", [], 0.0)}, {"nm": 5})
    assert eq.lookup("nm", "ng", 5, record=False) == ("b", [], 0.0), \
        "equal-generation store_many must overwrite"
    # ... and the bound holds on the batch path too
    eq2 = eq_mod.EquivalenceCache()
    for i in range(bound + 1):
        eq2.store_many(f"bcls{i}", {"nx": (i, [], 0.0)}, {"nx": 1})
    assert eq2.lookup("nx", "bcls0", 1, record=False) is None, \
        "store_many ignored the per-node bound"


def _check_score_kernels() -> None:
    """Every score kernel float-for-float against its scalar original,
    including the degenerate rows (no allocatable at all, cpu-only)
    where the count/denominator boundary mutants hide."""
    from kubegpu_tpu_torch.scheduler import factory, priorities
    from kubegpu_tpu_torch.scheduler.predicates import pod_core_requests

    vec_mod = _vec_mod()
    cache = _cache_mod().SchedulerCache(_device_scheduler())
    n0 = _gpu_node("k0", 0, cpu="8")
    n0["status"]["allocatable"]["memory"] = "16Gi"
    n0["metadata"]["labels"] = {"topology.kubernetes.io/zone": "z1"}
    n1 = _gpu_node("k1", 1, kind="pcie", cpu="4")
    n1["status"]["allocatable"]["memory"] = "8Gi"
    n1["metadata"]["labels"] = {"topology.kubernetes.io/zone": "z2",
                                "tier": "gold"}
    n2 = _gpu_node("k2", 2, kind="rig", cpu="16", taints=[
        {"key": "k", "value": "v", "effect": "PreferNoSchedule"}])
    n3 = _gpu_node("k3", 3)
    n3["status"]["allocatable"] = {}          # count == 0 row
    n3["metadata"]["annotations"] = dict(n3["metadata"]["annotations"])
    n3["metadata"]["annotations"][
        "scheduler.alpha.kubernetes.io/preferAvoidPods"] = \
        '{"preferAvoidPods": []}'
    for node in (n0, n1, n2, n3):
        cache.set_node(node)
    for i, (node, labels) in enumerate([("k0", {"app": "web"}),
                                        ("k0", {"app": "web"}),
                                        ("k1", {"app": "db"})]):
        cache.add_pod({"metadata": {"name": f"kb{i}", "labels": labels},
                       "spec": {"containers": [
                           {"name": "m",
                            "resources": {"requests": {"cpu": "1"}}}]}},
                      node)
    pod = {"metadata": {"name": "probe", "labels": {"app": "web"},
                        "ownerReferences": [{"uid": "u1",
                                             "kind": "ReplicaSet",
                                             "name": "rs"}]},
           "spec": {"containers": [
               {"name": "m", "resources": {"requests": {
                   "cpu": "2", "memory": "1Gi"}}}],
               "affinity": {"nodeAffinity": {
                   "preferredDuringSchedulingIgnoredDuringExecution": [
                       {"weight": 3, "preference": {"matchExpressions": [
                           {"key": "tier", "operator": "In",
                            "values": ["gold"]}]}}]}}}}
    names = sorted(cache.nodes)
    snaps = [cache.snapshot_node(n) for n in names]
    facts = {n: priorities.NodeFacts(s.kube_node, s.core_allocatable,
                                     s.requested_core, s.pod_labels)
             for n, s in zip(names, snaps)}
    req = pod_core_requests(pod)
    cols = vec_mod._ScoreColumns(snaps, req)
    pairs: List[Tuple[Any, Any]] = [
        (vec_mod._kernel_least_requested,
         lambda n: priorities.least_requested(req, facts[n])),
        (vec_mod._kernel_most_requested,
         lambda n: priorities.most_requested(req, facts[n])),
        (vec_mod._kernel_balanced,
         lambda n: priorities.balanced_allocation(req, facts[n])),
        (vec_mod._kernel_node_affinity,
         lambda n: priorities.node_affinity(pod, facts[n])),
        (vec_mod._kernel_taints,
         lambda n: priorities.taint_toleration(pod, facts[n])),
        (vec_mod._kernel_avoid,
         lambda n: priorities.node_prefer_avoid_pods(pod, facts[n])),
        (vec_mod._kernel_equal,
         lambda n: priorities.equal_priority(pod, facts[n])),
    ]
    for kernel, scalar in pairs:
        got = kernel(pod, req, cols, snaps, None)
        want = [scalar(n) for n in names]
        assert [float(v) for v in got] == want, (
            getattr(kernel, "__name__", "kernel"), list(got), want)
    for sels in (None, [{"app": "web"}], []):
        ctx = factory.PriorityContext(None, owner_selectors=sels)
        want_map = factory._pr_spreading(None)(pod, req, facts, ctx)
        got = vec_mod._kernel_spreading(pod, req, cols, snaps, sels)
        assert {n: float(got[i]) for i, n in enumerate(names)} == \
            want_map, ("spreading", sels)
    want_ip = factory._pr_interpod(None)(pod, req, facts,
                                         factory.PriorityContext(None))
    got_ip = vec_mod._kernel_interpod(pod, req, cols, snaps, None)
    assert {n: float(got_ip[i]) for i, n in enumerate(names)} == want_ip


class _StubDevice:
    """A device scheduler answering every fit with ``verdict``."""

    def __init__(self, verdict: Tuple[bool, list, float] = (True, [], 1.0)
                 ) -> None:
        self.verdict = verdict

    def pod_fits_resources(self, pod_info: Any, node_ex: Any,
                           flag: bool) -> Tuple[bool, list, float]:
        return self.verdict


class _StubSnap:
    node_ex = None


def _check_memo_capacity() -> None:
    """The scheduling-thread-owned memos hold their documented bounds
    and quarter-oldest eviction policy, and a verdict whose reasons name
    one of the representative's cards never enters the shape memo."""
    np = _np()
    vec_mod = _vec_mod()
    vec = vec_mod.VectorizedFitPass(None, _StubDevice())
    cap = vec_mod.MAX_SHAPE_VERDICTS
    for i in range(cap):
        vec._shape_verdicts[("prefill", i)] = (True, [], 0.0)
    vec._shape_verdict(("fp",), ("bc",), "rep", {"rep": _StubSnap()},
                       lambda name: object(), {})
    want = cap - cap // 4 + 1
    assert len(vec._shape_verdicts) == want, \
        ("shape-verdict eviction drift", len(vec._shape_verdicts), want)
    # the mask memo evicts exactly one oldest class per overflow
    class _Cols:
        names = ["x"]
        epoch = 1
        gen = np.zeros(1, dtype=np.int64)
    for i in range(vec_mod.MAX_MASK_CLASSES):
        vec._mask_memo[f"cls{i}"] = {"epoch": 0, "n": 1}
    vec._store_mask("fresh", _Cols(), None, {})
    assert len(vec._mask_memo) == vec_mod.MAX_MASK_CLASSES, \
        ("mask-memo bound drift", len(vec._mask_memo))
    assert "cls0" not in vec._mask_memo, "oldest class not evicted"
    assert "fresh" in vec._mask_memo
    # identity-specific verdicts: the reasons name a card of the
    # representative (in either attribute path), so the verdict is that
    # node's and the shape memo stays empty; a verdict naming no card of
    # this node, or no reason at all, is the shape's
    node = _gpu_node("rep", 5)
    canon = _oracle_canonical(
        codec.annotation_to_node_info(node["metadata"]).allocatable)
    uuids = sorted({grammar.gpu_id_from_path(p) for p in canon
                    if grammar.gpu_id_from_path(p) is not None})
    other = _gpu_node("other", 6)
    foreign = grammar.gpu_id_from_path(_card_paths(other)[0])
    cases = [([f"Insufficient {uuids[3]}/cards"], False),
             ([f"card {uuids[-1]} lost", "node(s) were unschedulable"],
              False),
             ([f"Insufficient {foreign}/cards"], True),
             (["Insufficient alpha.gpu/numgpu"], True),
             ([], True)]
    for reasons, shared in cases:
        dev = _StubDevice((False, reasons, 0.0))
        memo = vec_mod.VectorizedFitPass(None, dev)
        got = memo._shape_verdict(("fp",), ("bc",), "rep",
                                  {"rep": _StubSnap()},
                                  lambda name: object(), canon)
        assert (got is not None) == shared, (reasons, "card-naming verdict")
        assert len(memo._shape_verdicts) == int(shared), \
            (reasons, "shape memo")
    assert vec_mod._names_card([f"x {uuids[0]}"], canon)
    assert not vec_mod._names_card([f"x {foreign}"], canon)
    assert not vec_mod._names_card([], canon)
    assert _cache_mod().card_ids(canon) == frozenset(uuids), "card_ids"


def _check_columns_mirror() -> None:
    """The fleet mirror vs from-scratch recomputation across the full
    mutation vocabulary: set_node, charge/release, heartbeat no-ops,
    idempotent replays, anti-affinity flushes, node removal and
    re-registration — plus generation/staleness semantics."""
    cache_mod = _cache_mod()
    cache = cache_mod.SchedulerCache(_device_scheduler())
    cache.set_node(_gpu_node("n0", 0))
    cache.set_node(_gpu_node("n1", 1))                   # same shape
    cache.set_node(_gpu_node("n2", 2, failed=(1,)))
    cache.set_node(_gpu_node("n3", 3, kind="pcie", taints=[
        {"key": "k", "value": "v", "effect": "NoSchedule"}]))
    cache.set_node(_gpu_node("n4", 4, kind="rig", unschedulable=True,
                             conditions=[{"type": "MemoryPressure",
                                          "status": "True"}]))
    # explicit Ready conditions either way, plus an unrelated condition
    # with status False — the Ready-gate comparisons must not blur
    cache.set_node(_gpu_node("n5", 5, conditions=[
        {"type": "Ready", "status": "False"}]))
    cache.set_node(_gpu_node("n6", 6, conditions=[
        {"type": "Ready", "status": "True"},
        {"type": "NetworkUnavailable", "status": "False"}]))
    *_, cols = cache.cycle_snapshot(with_columns=True)
    _verify_columns(cache, cols)
    assert int(cols.n_notready[cols.idx["n5"]]) == 1
    assert int(cols.n_notready[cols.idx["n6"]]) == 0
    # the preemption prune key is the MIN bound-pod priority
    for pname, prio in (("pp-lo", 3), ("pp-hi", 40)):
        cache.add_pod({"metadata": {"name": pname},
                       "spec": {"priority": prio, "containers": [
                           {"name": "m", "resources": {
                               "requests": {"cpu": "1"}}}]}}, "n6")
    *_, cols = cache.cycle_snapshot(with_columns=True)
    assert int(cols.min_pod_priority[cols.idx["n6"]]) == 3
    _verify_columns(cache, cols)
    assert cols.dev_fps[cols.idx["n0"]][0] == \
        cols.dev_fps[cols.idx["n1"]][0], \
        "same canonical shape must share an alloc id"
    assert cols.dev_fps[cols.idx["n0"]][0] != \
        cols.dev_fps[cols.idx["n2"]][0], \
        "a failed card must not share the healthy shape"
    assert cols.dev_fps[cols.idx["n0"]][0] != \
        cols.dev_fps[cols.idx["n3"]][0], \
        "PCIe and HGX hosts must not share a shape"

    # charge: assume with a real allocation, then the staleness contract
    g0 = cache.node_generation("n0")
    cache.equivalence.store("n0", "probe-class", g0, (True, [], 1.0))
    pod = _gpu_pod("p0", 2)
    info = cache.pod_info_for_node(pod, "n0")
    cache.device_scheduler.pod_allocate(info, cache.nodes["n0"].node_ex)
    info.node_name = "n0"
    codec.pod_info_to_annotation(pod["metadata"], info)
    cache.assume_pod(pod, "n0")
    g1 = cache.node_generation("n0")
    assert g1 > g0, "fit-relevant mutation must bump the generation"
    assert cache.equivalence.lookup("n0", "probe-class", g1,
                                    record=False) is None, \
        "pre-mutation verdict served after the bump"
    *_, cols = cache.cycle_snapshot(with_columns=True)
    _verify_columns(cache, cols)
    assert int(cols.free_chips[cols.idx["n0"]]) == 6
    snaps = cache.cycle_snapshot()[1]
    assert snaps["n0"].requested_core.get("cpu", 0) > 0, \
        "cycle snapshot stale after charge"

    # heartbeat-only repatch: no generation movement, columns intact
    hb = _gpu_node("n1", 1)
    hb["metadata"]["annotations"] = dict(hb["metadata"]["annotations"])
    hb["metadata"]["annotations"][codec.NODE_HEARTBEAT_ANNOTATION] = \
        "999999"
    g_n1 = cache.node_generation("n1")
    cache.set_node(hb)
    assert cache.node_generation("n1") == g_n1, \
        "heartbeat repatch must not invalidate"
    _verify_columns(cache, cache.cycle_snapshot(with_columns=True)[3])

    # idempotent replay: a bound pod added twice charges once
    bound = _gpu_pod("b0", 1, cpu="2")
    binfo = cache.pod_info_for_node(bound, "n1")
    cache.device_scheduler.pod_allocate(binfo, cache.nodes["n1"].node_ex)
    binfo.node_name = "n1"
    codec.pod_info_to_annotation(bound["metadata"], binfo)
    cache.add_pod(bound, "n1")
    free_once = int(cache.cycle_snapshot(with_columns=True)[3]
                    .free_chips[cols.idx["n1"]])
    cache.add_pod(bound, "n1")
    *_, cols = cache.cycle_snapshot(with_columns=True)
    assert int(cols.free_chips[cols.idx["n1"]]) == free_once, \
        "watch replay double-charged"
    _verify_columns(cache, cols)

    # forget releases EXACTLY once; requested_core returns to absolute
    # zero (the release sign is a contract, not mirror-consistency)
    cache.forget_pod(pod)
    *_, cols = cache.cycle_snapshot(with_columns=True)
    assert int(cols.free_chips[cols.idx["n0"]]) == 8, "forget leaked cards"
    assert cache.nodes["n0"].requested_core.get("cpu", 0) == 0, \
        "release did not return the charge to zero"
    _verify_columns(cache, cols)
    # release must unmark the pod: add -> remove -> add recharges
    cache.remove_pod(bound, "n1")
    assert cache.nodes["n1"].requested_core.get("cpu", 0) == 0, \
        "remove_pod did not zero the core charge"
    cache.add_pod(bound, "n1")
    *_, cols = cache.cycle_snapshot(with_columns=True)
    assert int(cols.free_chips[cols.idx["n1"]]) == free_once, \
        "re-added pod was not recharged (release left it marked)"
    _verify_columns(cache, cols)
    cache.remove_pod(bound, "n1")

    # required anti-affinity flushes EVERY node's generation
    gens_before = {n: cache.node_generation(n) for n in cache.nodes}
    anti = {"metadata": {"name": "anti", "labels": {"app": "a"}},
            "spec": {"containers": [{"name": "m", "resources": {
                "requests": {"cpu": "1"}}}],
                "affinity": {"podAntiAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": [
                        {"labelSelector": {"matchLabels": {"app": "a"}},
                         "topologyKey": "kubernetes.io/hostname"}]}}}}
    cache.add_pod(anti, "n2")
    for n, g in gens_before.items():
        assert cache.node_generation(n) > g, \
            f"anti-affinity admit must flush {n}"
    _verify_columns(cache, cache.cycle_snapshot(with_columns=True)[3])

    # with a required-anti pod placed, a LABEL MOVE on any node flips
    # the symmetry veto on every node sharing the domain: all-flush
    gens_before = {n: cache.node_generation(n) for n in cache.nodes}
    relabeled = _gpu_node("n0", 0)
    relabeled["metadata"]["labels"] = {"topology.kubernetes.io/zone": "zX"}
    cache.set_node(relabeled)
    for n, g in gens_before.items():
        assert cache.node_generation(n) > g, \
            f"label move with anti pods placed must flush {n}"
    _verify_columns(cache, cache.cycle_snapshot(with_columns=True)[3])

    # ... and an ordinary fit-relevant change bumps ITS node
    g_cpu = cache.node_generation("n1")
    cache.set_node(_gpu_node("n1", 1, cpu="6"))
    assert cache.node_generation("n1") > g_cpu, \
        "allocatable change must invalidate the node"
    _verify_columns(cache, cache.cycle_snapshot(with_columns=True)[3])

    # a card fails on a registered host: its canonicalization moves
    # with the shrunken inventory (the UUID ranks shift), and the next
    # view must carry the new map and shape
    g_fail = cache.node_generation("n6")
    cache.set_node(_gpu_node("n6", 6, failed=(3,), conditions=[
        {"type": "Ready", "status": "True"},
        {"type": "NetworkUnavailable", "status": "False"}]))
    assert cache.node_generation("n6") > g_fail, \
        "a failed card must invalidate its host"
    *_, cols = cache.cycle_snapshot(with_columns=True)
    _verify_columns(cache, cols)
    assert int(cols.free_chips[cols.idx["n6"]]) == 7

    # a generation-only bump (no row write) reaches the next view on its
    # own: the mirror's set_gen contract, whatever row write the cache's
    # own paths pair it with today
    with cache._lock:
        cache._invalidate_locked("n5")
    _verify_columns(cache, cache.cycle_snapshot(with_columns=True)[3])

    # removing the NODE that hosts the anti pod departs its veto: the
    # remaining fleet must flush too
    gens_before = {n: cache.node_generation(n) for n in cache.nodes
                   if n != "n2"}
    cache.remove_node("n2")
    for n, g in gens_before.items():
        assert cache.node_generation(n) > g, \
            f"departed anti pod must flush {n}"
    cache.set_node(_gpu_node("n2", 2, failed=(1,)))

    # node removal: the mirror row must go, and the retained generation
    # must keep moving so a re-add cannot resurrect stale verdicts
    g_rm = cache.node_generation("n3")
    cache.remove_node("n3")
    *_, cols = cache.cycle_snapshot(with_columns=True)
    assert cols is not None and "n3" not in cols.names, \
        "removed node lingers in the mirror"
    _verify_columns(cache, cols)
    cache.set_node(_gpu_node("n3", 3, kind="pcie"))
    assert cache.node_generation("n3") > g_rm, \
        "re-added node resumed a generation an old pass may hold"
    _verify_columns(cache, cache.cycle_snapshot(with_columns=True)[3])

    # node flap: delete + re-add + watch replay of the bound pod as
    # ADDED must re-charge it against the fresh node (the un-mark
    # discipline in remove_node)
    flap = _gpu_pod("flap", 1, cpu="2")
    finfo = cache.pod_info_for_node(flap, "n3")
    cache.device_scheduler.pod_allocate(finfo, cache.nodes["n3"].node_ex)
    finfo.node_name = "n3"
    codec.pod_info_to_annotation(flap["metadata"], finfo)
    cache.add_pod(flap, "n3")
    *_, cols = cache.cycle_snapshot(with_columns=True)
    charged_free = int(cols.free_chips[cols.idx["n3"]])
    assert charged_free == 7
    cache.remove_node("n3")
    cache.set_node(_gpu_node("n3", 3, kind="pcie"))
    cache.add_pod(flap, "n3")  # the watch replays current objects
    *_, cols = cache.cycle_snapshot(with_columns=True)
    assert int(cols.free_chips[cols.idx["n3"]]) == charged_free, \
        "flap replay did not re-charge the bound pod"
    _verify_columns(cache, cols)


def _check_filter_differential() -> None:
    """Masked filter/score vs the scalar chain: verdicts, reasons and
    scores over a mixed fleet, plus the cross-path sharing contract
    (vector-stored verdicts readable through the equivalence memo)."""
    eq_mod = _equiv_mod()
    api = _api()
    api.create_node(_gpu_node("h0", 0))
    api.create_node(_gpu_node("h1", 1))
    api.create_node(_gpu_node("h2", 2, kind="pcie"))
    api.create_node(_gpu_node("h3", 3, failed=(0,)))
    api.create_node(_gpu_node("h4", 4, unschedulable=True))
    api.create_node(_gpu_node("h5", 5, cpu="1", conditions=[
        {"type": "DiskPressure", "status": "True"}]))
    # discriminators: a tainted node (mask-eligibility poisoning), a
    # NotReady node (condition-count boundary), an exact-fit cpu node
    # (the Insufficient >-vs->= boundary) and a one-card host
    api.create_node(_gpu_node("h6", 6, taints=[
        {"key": "k", "value": "v", "effect": "NoSchedule"}]))
    api.create_node(_gpu_node("h7", 7, conditions=[
        {"type": "Ready", "status": "False"}]))
    api.create_node(_gpu_node("h8", 8, cpu="2"))
    api.create_node(_gpu_node("h9", 9, kind="rig"))
    vec, scalar = _schedulers(api)
    try:
        for i in range(3):
            api.create_pod(_gpu_pod(f"seed{i}", 1 + i % 2))
            vec.run_until_idle()
        probes = [_gpu_pod("q1", 1), _gpu_pod("q2", 2, cpu="4"),
                  _gpu_pod("q4", 4), _gpu_pod("q8", 8),
                  _gpu_pod("q16", 16),
                  _gpu_pod("qx", 1, cpu="2"),  # exact fit on h8
                  {"metadata": {"name": "be"},
                   "spec": {"containers": [{"name": "m"}]}}]
        for _round in range(2):  # warm pass: memo-reuse paths live too
            for probe in probes:
                name = probe["metadata"]["name"]
                vf, vfail, vsnaps, vmeta = \
                    vec.generic.find_nodes_that_fit(probe)
                sf, sfail, ssnaps, smeta = \
                    scalar.generic.find_nodes_that_fit(probe)
                assert vf == sf, (name, _round, "feasible", vf, sf)
                assert vfail == sfail, (name, _round, "reasons",
                                        vfail, sfail)
                if vf:
                    vs = vec.generic.prioritize_nodes(probe, vf, vsnaps,
                                                      vmeta)
                    ss = scalar.generic.prioritize_nodes(probe, sf,
                                                         ssnaps, smeta)
                    assert vs == ss, (name, _round, "scores", vs, ss)
        # cross-path sharing: the masked pass's verdicts must be
        # readable through the equivalence memo at the same generations
        pod = _gpu_pod("share", 1)
        feasible, _, _, _ = vec.generic.find_nodes_that_fit(pod)
        eq_class = eq_mod.equivalence_class(pod)
        hit_somewhere = False
        for n in feasible:
            hit = vec.cache.equivalence.lookup(
                n, eq_class, vec.cache.node_generation(n), record=False)
            if hit is not None:
                assert hit[0] is True, (n, "shared verdict polarity")
                hit_somewhere = True
        assert hit_somewhere, "vector verdicts never reached the memo"
        # pinned-pod pass, then a same-demand unpinned pod: the pinned
        # variant's identity-specific verdict must never be broadcast
        h0_card = _card_paths(api.get_node("h0"))[0]
        for probe in (_pinned_pod("pin", "h0", h0_card),
                      _gpu_pod("unpinned", 1)):
            name = probe["metadata"]["name"]
            vf, vfail, vsnaps, vmeta = vec.generic.find_nodes_that_fit(
                probe)
            sf, sfail, _s, _m = scalar.generic.find_nodes_that_fit(probe)
            assert vf == sf, (name, "pinned-path feasible", vf, sf)
            assert vfail == sfail, (name, "pinned-path reasons")
        assert not vec.generic._device_verdicts, \
            "masked pass leaked into the locked scalar device cache"
    finally:
        vec.stop()
        scalar.stop()


def _check_mask_memo() -> None:
    """The generation-vector mask memo across membership churn: after a
    same-size node swap the row alignment changes, and a memo that
    survives the epoch (or mis-keys generations) broadcasts one node's
    verdict as another's. Plus the memo-effectiveness accounting: a
    warm pass must fold its mask-memo reuse into the equivalence
    hit/miss counters."""
    api = _api()
    api.create_node(_gpu_node("a", 0, cpu="1"))   # tiny cpu
    api.create_node(_gpu_node("b", 1, cpu="8"))
    vec, scalar = _schedulers(api)
    try:
        probe = _gpu_pod("align", 1, cpu="4")

        def both() -> None:
            vf, vfail, _vs, _vm = vec.generic.find_nodes_that_fit(probe)
            sf, sfail, _ss, _sm = scalar.generic.find_nodes_that_fit(
                probe)
            assert vf == sf, ("feasible", vf, sf)
            assert vfail == sfail, ("reasons", vfail, sfail)

        both()
        hits0 = vec.cache.equivalence.hits
        both()  # warm: reuse must be counted through record()
        assert vec.cache.equivalence.hits >= hits0 + 1, \
            "mask-memo reuse missing from the hit accounting"
        # same-size membership swap: rows realign, generations collide
        # (fresh nodes restart at the same small counters) — only the
        # epoch distinguishes the memo's rows from the new fleet's
        api.delete_node("a")
        api.create_node(_gpu_node("c", 2, cpu="1"))
        vec.run_until_idle()
        scalar.run_until_idle()
        both()
    finally:
        vec.stop()
        scalar.stop()
    _check_pinned_poison()


def _check_pinned_poison() -> None:
    """A pinned pod's identity-specific device verdict must never enter
    the broadcast shape memo: two shape-and-usage-identical hosts, the
    pinned card occupied on the pinned host, then a same-demand
    unpinned pod — a poisoned memo broadcasts the pinned failure."""
    api = _api()
    for name, host in (("pa", 0), ("pb", 1)):
        node = _gpu_node(name, host)
        node["metadata"]["labels"] = {"host": name}
        api.create_node(node)
    vec, scalar = _schedulers(api)
    try:
        # occupy the same canonical card on BOTH hosts (identical fps)
        for name in ("pa", "pb"):
            seed = _gpu_pod(f"occ-{name}", 1)
            seed["spec"]["nodeSelector"] = {"host": name}
            api.create_pod(seed)
            vec.run_until_idle()
        occ = codec.annotation_to_pod_info(
            api.get_pod("occ-pa").get("metadata") or {})
        taken = next(iter(
            occ.running_containers["main"].allocate_from.values()))
        # a second pod of the same class pinned to pb's FREE card: its
        # host is shape-and-usage-identical to pa, so a poisoned memo
        # serves it the first pin's failure
        occ_b = codec.annotation_to_pod_info(
            api.get_pod("occ-pb").get("metadata") or {})
        taken_b = set(occ_b.running_containers["main"]
                      .allocate_from.values())
        free_b = [p for p in _card_paths(api.get_node("pb"))
                  if p not in taken_b][0]
        # ... and the taken pin again, under another equivalence class (a
        # label) so the mask memo cannot answer for it: a shape memo the
        # free pin's success reached would now serve pa that success
        again = _pinned_pod("pin-again", "pa", taken)
        again["metadata"]["labels"] = {"probe": "again"}
        for probe in (_pinned_pod("pin-poison", "pa", taken),
                      _pinned_pod("pin-free", "pb", free_b),
                      again, _gpu_pod("post-pin", 1)):
            name = probe["metadata"]["name"]
            vf, vfail, vsnaps, vmeta = vec.generic.find_nodes_that_fit(
                probe)
            sf, sfail, _ss, _sm = scalar.generic.find_nodes_that_fit(
                probe)
            assert vf == sf, (name, "poison feasible", vf, sf)
            assert vfail == sfail, (name, "poison reasons", vfail, sfail)
    finally:
        vec.stop()
        scalar.stop()


def _check_preempt_differential() -> None:
    """Preemption choice vs the scalar path, the FastPreemptFit.fits
    twin verdict for verdict, the pinned-node sim-key exclusion and the
    card-capacity prune against free + evictable cards."""
    vec_mod = _vec_mod()
    four = (4, 5, 6, 7)  # an HGX host with one socket's cards failed
    api = _api()
    for i in range(3):
        api.create_node(_gpu_node(f"m{i}", i, failed=four))
    # unhealthy rows: fits() gates these off the columns
    api.create_node(_gpu_node("m-nr", 3, failed=four, conditions=[
        {"type": "Ready", "status": "False"}]))
    api.create_node(_gpu_node("m-dp", 4, failed=four, conditions=[
        {"type": "DiskPressure", "status": "True"}]))
    # exact-cpu host: the preemptor's request lands exactly on the cap
    # (one cpu-1 filler + the cpu-2 preemptor == 3)
    api.create_node(_gpu_node("m-cpu", 5, failed=four, cpu="3"))
    # two-card host: free+evictable lands BETWEEN the init-max demand
    # and a min-folded undercount, so demand arithmetic is observable
    api.create_node(_gpu_node("m-two", 6, failed=(2, 3) + four))
    # a one-card host holding a priority-5 pod: the strict `<` victim
    # gate and the zero-free prune boundary are only visible here
    meq = _gpu_node("m-eq", 7, kind="rig")
    meq["metadata"]["labels"] = {"role": "eq"}
    api.create_node(meq)
    vec, scalar = _schedulers(api)
    try:
        eqv = _gpu_pod("eqv", 1, priority=5)
        eqv["spec"]["nodeSelector"] = {"role": "eq"}
        api.create_pod(eqv)
        vec.run_until_idle()
        assert (api.get_pod("eqv").get("spec") or {}).get("nodeName") \
            == "m-eq", "eq-priority pod missed its host"
        i = 0
        while True:
            api.create_pod(_gpu_pod(f"low{i}", 1, priority=0))
            vec.run_until_idle()
            if not (api.get_pod(f"low{i}").get("spec") or {}) \
                    .get("nodeName"):
                api.delete_pod(f"low{i}")
                vec.run_until_idle()
                break
            i += 1
            assert i < 64, "filler never saturated the fleet"
        pre = _gpu_pod("pre", 2, priority=100, cpu="2")
        # fits() vs the scalar evict-and-reprieve chain
        gen = vec.generic
        names, _s, _g, cols = gen.cache.cycle_snapshot(with_columns=True)
        assert cols is not None
        fast = vec_mod.FastPreemptFit(gen.vector, pre,
                                      gen._pod_info_provider(pre), cols)
        sgen = scalar.generic
        pig = sgen._pod_info_provider(pre)
        dc = sgen._device_class(pre)
        for name in names:
            vsnap = gen.cache.snapshot_node(name)
            ssnap = sgen.cache.snapshot_node(name)
            if vsnap is None or ssnap is None:
                continue
            verdict = fast.fits(vsnap)
            if verdict is None:
                continue
            want = sgen._fits_after_evictions(pre, ssnap, None, set(),
                                              pig, None, dc)
            assert verdict == want, (name, "fits twin divergence")
        # pinned preemptor: its host's simulation is identity-specific
        m0_card = _card_paths(api.get_node("m0"))[0]
        ppod = _pinned_pod("pinned", "m0", m0_card, priority=100)
        pfast = vec_mod.FastPreemptFit(gen.vector, ppod,
                                       gen._pod_info_provider(ppod), cols)
        s0 = gen.cache.snapshot_node("m0")
        s1 = gen.cache.snapshot_node("m1")
        no_cands: Any = lambda p: None
        assert pfast.sim_key(s0, [], [], no_cands) is None, \
            "pinned host entered the simulation memo"
        assert pfast.sim_key(s1, [], [], no_cands) is not None, \
            "shape memo dead for unpinned hosts"
        # card-capacity prune EXACTNESS: the prune must agree with the
        # free+evictable arithmetic recomputed from the cache — an
        # over-eager prune silently drops placeable hosts, a demand
        # under-count admits unplaceable ones. Preemptors exercise the
        # init-vs-running max fold and the strict victim-priority gate.
        pods_by_name = {p["metadata"]["name"]: p
                        for p in api.list_pods() if p.get("spec")}
        cycle_snaps = gen.cache.cycle_snapshot()[1]
        init_pre = PodInfo(name="initpre")
        init_pre.running_containers["main"] = ContainerInfo(
            requests={grammar.RESOURCE_NUM_GPU: 2})
        init_pre.init_containers["setup"] = ContainerInfo(
            requests={grammar.RESOURCE_NUM_GPU: 4})
        init_pre.init_containers["stage"] = ContainerInfo(
            requests={grammar.RESOURCE_NUM_GPU: 1})
        imeta = {"name": "initpre"}
        codec.pod_info_to_annotation(imeta, init_pre)
        ipod = {"metadata": imeta,
                "spec": {"priority": 100, "containers": [
                    {"name": "main",
                     "resources": {"requests": {"cpu": "1"}}}]}}
        for probe_pod, prio in ((pre, 100), (ipod, 100),
                                (_gpu_pod("one", 1, priority=5), 5),
                                (_gpu_pod("zero", 0, priority=5), 5)):
            pf = vec_mod.FastPreemptFit(
                gen.vector, probe_pod,
                gen._pod_info_provider(probe_pod), cols)
            # demand recomputed INDEPENDENTLY (running sum, init max) —
            # an oracle through the mutated _chips_demand proves nothing
            inv = gen._pod_info_provider(probe_pod).inv_info
            running = sum(
                int(c.requests.get(grammar.RESOURCE_NUM_GPU, 0))
                for c in inv.running_containers.values())
            init = max(
                (int(c.requests.get(grammar.RESOURCE_NUM_GPU, 0))
                 for c in inv.init_containers.values()), default=0)
            demand = max(running, init)
            for name in names:
                snap = cycle_snaps.get(name)
                cached = gen.cache.get_node(name)
                if snap is None or cached is None or \
                        cols.idx.get(name) is None:
                    continue
                free = _free_cards(cached.node_ex)
                evictable = 0
                for pod_name in snap.pod_names:
                    vic = pods_by_name.get(pod_name)
                    if vic is None:
                        continue
                    if int((vic.get("spec") or {}).get("priority")
                           or 0) < prio:
                        evictable += cached.pod_chips.get(pod_name, 0)
                want = demand <= 0 or free + evictable >= demand
                got = pf.might_fit_after_full_eviction(
                    name, prio, pods_by_name, snap)
                assert got == want, ("prune exactness", name,
                                     probe_pod["metadata"]["name"],
                                     got, want, free, evictable, demand)
        # sim_key's PDB-match vectors, against a direct recomputation
        pdb_state = [{"selector": {"app": "web"}, "allowed": 1},
                     {"selector": {"app": "web", "tier": "gold"},
                      "allowed": 0}]
        cands = [
            {"metadata": {"name": "full", "labels": {
                "app": "web", "tier": "gold"}},
             "spec": {"priority": 1, "containers": []}},
            {"metadata": {"name": "partial", "labels": {"app": "web"}},
             "spec": {"priority": 2, "containers": []}},
            {"metadata": {"name": "none", "labels": {"app": "db"}},
             "spec": {"priority": 3, "containers": []}},
        ]
        info_of = lambda p: codec.kube_pod_to_pod_info(  # noqa: E731
            p, invalidate_existing=False)
        key = fast.sim_key(gen.cache.snapshot_node("m1"), cands,
                           pdb_state, info_of)
        assert key is not None
        got_matches = [part[3] for part in key[1]]
        want_matches = []
        for cand in cands:
            labels = cand["metadata"]["labels"]
            want_matches.append(tuple(
                j for j, s in enumerate(pdb_state)
                if all(labels.get(k) == v
                       for k, v in s["selector"].items())))
        assert got_matches == want_matches, \
            ("sim_key pdb vectors", got_matches, want_matches)
        # capacity probes: fits() and sim_key() own copies of the
        # quarter-oldest eviction policy
        cap = vec_mod.MAX_SHAPE_VERDICTS
        snap_ok = gen.cache.snapshot_node("m1")
        gen.vector._shape_verdicts.clear()
        for i in range(cap):
            gen.vector._shape_verdicts[("prefill", i)] = (True, [], 0.0)
        fast.fits(snap_ok)
        want_len = cap - cap // 4 + 1
        assert len(gen.vector._shape_verdicts) == want_len, \
            ("fits eviction drift", len(gen.vector._shape_verdicts))
        gen.vector._contrib_fps.clear()
        for i in range(cap):
            gen.vector._contrib_fps[("prefill", i)] = ()
        fast.sim_key(snap_ok, cands[:1], [], info_of)
        want_len = cap - cap // 4 + 1
        assert len(gen.vector._contrib_fps) == want_len, \
            ("sim_key eviction drift", len(gen.vector._contrib_fps))
        # the actual preemption decision, vec vs scalar
        got_vec = vec.generic.preempt(pre)
        got_scalar = scalar.generic.preempt(pre)
        assert (got_vec is None) == (got_scalar is None), \
            ("preempt verdict", got_vec, got_scalar)
        if got_vec is not None:
            vnode, vvictims = got_vec
            snode, svictims = got_scalar
            assert vnode == snode, ("preempt node", vnode, snode)
            assert [v["metadata"]["name"] for v in vvictims] == \
                [v["metadata"]["name"] for v in svictims], "victim drift"
    finally:
        vec.stop()
        scalar.stop()


def _check_stream_differential() -> None:
    """A short randomized pod stream (churn, volumes, priorities, a
    forced preemption) driven through a vectorized and a scalar engine on
    identically-built clusters: placements must be identical pod for
    pod, card for card."""
    placements = [_drive_stream(vectorize) for vectorize in (True, False)]
    assert placements[0] == placements[1], "stream placement drift"


def _drive_stream(vectorize: bool) -> Dict[str, Any]:
    from kubegpu_tpu_torch.cluster.apiserver import NotFound

    rng = random.Random(42)
    api = _api()
    for i in range(6):
        failed = (4, 5, 6, 7)
        if rng.random() < 0.3:
            failed += (rng.randrange(4),)
        api.create_node(_gpu_node(f"s{i}", i, kind=("hgx", "pcie")[i % 2],
                                  failed=failed))
    for i in range(2):
        api.create_pv({"metadata": {"name": f"pv{i}"},
                       "spec": {"capacity": {"storage": "10Gi"},
                                "storageClassName": ""}})
        api.create_pvc({"metadata": {"name": f"pvc{i}"},
                        "spec": {"resources":
                                 {"requests": {"storage": "10Gi"}},
                                 "storageClassName": ""}})
    sched = _engine(api, vectorize)
    assert (sched.generic.vector is not None) == vectorize
    placements: Dict[str, Any] = {}
    try:
        created: List[str] = []
        for i in range(10):
            if i % 4 == 3:
                pod = _gpu_pod(f"v{i}", 1)
                pod["spec"]["volumes"] = [
                    {"name": "data",
                     "persistentVolumeClaim": {"claimName": f"pvc{i % 2}"}}]
            else:
                pod = _gpu_pod(f"p{i}", rng.choice([1, 1, 2, 4]),
                               priority=rng.choice([0, 0, 10]))
            api.create_pod(pod)
            created.append(pod["metadata"]["name"])
            sched.run_until_idle()
            if i % 5 == 4 and created:
                victim = created.pop(rng.randrange(len(created)))
                try:
                    api.delete_pod(victim)
                except (NotFound, KeyError):
                    pass
                sched.run_until_idle()
                placements[f"deleted-{victim}"] = True
        api.create_pod(_gpu_pod("pre", 2, priority=100))
        sched.run_until_idle()
        placements.update(_placements(api, created + ["pre"]))
    finally:
        sched.stop()
    return placements


def _check_batch_model() -> None:
    """Direct drives of the batch cycle's cycle-local pieces: the
    capacity ledger's exact decrement/boundary behavior (off-by-one
    mutants die here) and `pick_host`'s cursor-threaded tie-break."""
    from kubegpu_tpu_torch.scheduler import batch as batch_mod

    led = batch_mod.CapacityLedger()
    assert led.covers("n", 99, {"cpu": 10 ** 9}), "unseeded must not prune"
    cards = [f"{G}/gpugrp1/0/gpugrp0/0/{grammar.GPU_LEAF}/GPU-{i}/"
             f"{grammar.CARDS_SUFFIX}" for i in range(4)]
    node_ex = types.SimpleNamespace(
        allocatable={**{p: 1 for p in cards},
                     cards[0].replace(grammar.CARDS_SUFFIX,
                                      grammar.MEMORY_SUFFIX): 2 ** 30},
        used={cards[0]: 1})
    snap = types.SimpleNamespace(node_ex=node_ex,
                                 core_allocatable={"cpu": 8000},
                                 requested_core={"cpu": 2000})
    assert batch_mod.free_chip_count(node_ex) == 3, \
        "free cards must count card leaves only"
    led.seed("n", snap)  # 3 cards free, 6000 cpu headroom
    assert led.covers("n", 3, {"cpu": 6000}), "exact fit must cover"
    assert not led.covers("n", 4, {}), "card over-ask must prune"
    assert not led.covers("n", 0, {"cpu": 6001}), "core over-ask must prune"
    led.charge("n", 2, {"cpu": 4000})
    assert led.covers("n", 1, {"cpu": 2000}), "post-charge exact fit"
    assert not led.covers("n", 2, {}), "charge must decrement cards"
    assert not led.covers("n", 0, {"cpu": 2001}), "charge must decrement core"
    # note_award: FIRST touch seeds from the post-award snapshot (award
    # already subtracted there — seeding AND charging would double-count)
    led2 = batch_mod.CapacityLedger()
    led2.note_award("n", snap, 2, {"cpu": 1000})
    assert led2.covers("n", 3, {}), "first award must not double-charge"
    led2.note_award("n", snap, 1, {})
    assert led2.covers("n", 2, {}) and not led2.covers("n", 3, {}), \
        "second award must charge"
    # the broadcastable demand the ledger charges: the running
    # containers' cards, summed
    inv = PodInfo(name="d")
    inv.running_containers["a"] = ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: 2})
    inv.running_containers["b"] = ContainerInfo(
        requests={grammar.RESOURCE_NUM_GPU: 1})
    assert batch_mod.pod_chip_demand(inv) == 3, "running cards must sum"

    cp = batch_mod.ClassPass()
    cp.feasible = {"a": 1.0, "b": 1.0, "c": 0.5}
    cp.scored = {"a": 2.0, "b": 2.0, "c": 1.0}
    g = types.SimpleNamespace(_last_node_index=0)
    assert batch_mod.pick_host(g, cp) == "b", "tie-break cursor step 1"
    assert batch_mod.pick_host(g, cp) == "a", "tie-break cursor wrap"
    single = batch_mod.ClassPass()
    single.feasible = {"z": 9.0}
    single.scored = None
    assert batch_mod.pick_host(g, single) == "z"
    assert g._last_node_index == 2, "single-node fast path must not bump"
    none = batch_mod.ClassPass()
    none.feasible = {}
    assert batch_mod.pick_host(g, none) is None

    # class routing: a pod holding a live nomination must NOT take the
    # batch path (its preemption-freed reservation would be charged
    # against it by a shared representative pass)
    stub = types.SimpleNamespace(
        vector=types.SimpleNamespace(pod_eligible=lambda pod, inv: True),
        _memo_safe=True,
        extenders=(),
        _requests_auto_topology=lambda pod: False,
        cache=types.SimpleNamespace(has_affinity_pods=lambda: False),
        _volume_snapshot=lambda pod: None,
        _nominations={"nom": object()})
    assert batch_mod.batch_class(stub, _gpu_pod("nom", 1)) is None, \
        "nominated pod must route serial"
    assert isinstance(batch_mod.batch_class(stub, _gpu_pod("plain", 1)),
                      str), "eligible pod must get a class key"

    # score decomposition: single-node rescore is only sound when no
    # configured priority normalizes across the candidate set
    from kubegpu_tpu_torch.scheduler import factory as factory_mod
    spread = next(iter(factory_mod.SPREADING_PRIORITY_NAMES))

    def decompose(priorities: list, labels: dict, sels: Any) -> bool:
        gen = types.SimpleNamespace(
            algorithm=types.SimpleNamespace(vector_priorities=True,
                                            priorities=priorities),
            _owner_selectors=lambda pod: sels)
        pod = {"metadata": {"name": "d", "labels": labels}}
        return batch_mod.scores_decompose(gen, pod)

    other = ("other", None, 1)
    assert decompose([other], {"app": "x"}, None), \
        "no spreading configured => decomposable"
    assert not decompose([(spread, None, 1), other], {"app": "x"}, None), \
        "identifying label under spreading => full rescore"
    assert decompose([(spread, None, 1), other], {"name": "d"}, None), \
        "'name' label alone keeps spreading flat"
    assert not decompose([(spread, None, 1)], {"name": "d", "app": "x"},
                         None), "mixed labels => full rescore"
    assert decompose([(spread, None, 1)], {"app": "x"}, []), \
        "empty owner selectors keep spreading flat"
    assert not decompose([(spread, None, 1)], {}, [object()]), \
        "owner selectors => full rescore"


def _check_queue_model() -> None:
    """Direct drives of the batch queue intake: bounded heap-order
    drain, queue-wait admission accounting, replace-in-place on
    re-push, and the pop timeout actually being honored."""
    from kubegpu_tpu_torch.scheduler import queue as queue_mod

    q = queue_mod.SchedulingQueue()
    q.push_many([_gpu_pod("qa", 1, priority=1), _gpu_pod("qb", 1)])
    assert "qa" in q._enqueued and "qb" in q._enqueued, \
        "push_many must start queue-wait accounting"
    got = [p["metadata"]["name"] for p in q.pop_many(1, timeout=0.0)]
    assert got == ["qa"], "bounded drain, heap order"
    got = [p["metadata"]["name"] for p in q.pop_many(5, timeout=0.0)]
    assert got == ["qb"], "drain remainder"
    t0 = time.monotonic()
    assert q.pop_many(4, timeout=0.0) == []
    assert time.monotonic() - t0 < 0.5, "timeout=0 must not block"
    t0 = time.monotonic()
    assert q.pop_many(4, timeout=0.05) == []
    assert time.monotonic() - t0 >= 0.04, "empty-queue timeout honored"
    q.push_many([_gpu_pod("qc", 1, cpu="1")])
    q.push_many([_gpu_pod("qc", 1, cpu="7")])
    drained = q.pop_many(8, timeout=0.0)
    assert [p["metadata"]["name"] for p in drained] == ["qc"], \
        "re-push of a queued name replaces in place, no duplicate"
    assert drained[0]["spec"]["containers"][0]["resources"] \
        ["requests"]["cpu"] == "7", "replace must keep the newest object"


def _check_batch_differential() -> None:
    """Mass release driven through the batch cycle and the pod-at-a-time
    oracle on identically-built fleets: same pods bound to the same
    hosts and cards, and the assignment's losers parked for retry —
    never dropped."""
    placements = [_drive_batch(batch_on) for batch_on in (True, False)]
    assert placements[0] == placements[1], "batch placement drift"


def _drive_batch(batch_on: bool) -> Dict[str, Any]:
    rng = random.Random(7)
    api = _api()
    for i in range(4):
        api.create_node(_gpu_node(f"b{i}", i, kind=("hgx", "pcie")[i % 2],
                                  failed=(4, 5, 6, 7)))
    sched = _engine(api, True, batch=batch_on)
    placements: Dict[str, Any] = {}
    try:
        names: List[str] = []
        for i in range(12):
            # the whole burst lands BEFORE the first pass: several
            # equivalence classes, over-subscribing the 16-card fleet
            pod = _gpu_pod(f"m{i}", rng.choice([1, 1, 2, 4]),
                           priority=rng.choice([0, 0, 10]))
            api.create_pod(pod)
            names.append(pod["metadata"]["name"])
        sched.run_until_idle()
        placements = _placements(api, names)
        unbound = sum(1 for name in names if placements[name][0] is None)
        assert unbound > 0, "fleet not over-subscribed — widen the burst"
        assert sched.queue.pending_count() == unbound, "losers not requeued"
    finally:
        sched.stop()
    return placements


#: Cheap first. The queue model runs before the engines: a mutant that
#: stretches an empty pop would otherwise slow every engine-driving check
#: by its extra wait before the queue model could kill it.
KILL_CHECKS: Tuple[Tuple[str, Callable[[], None]], ...] = (
    ("batch-model", _check_batch_model),
    ("equivalence-model", _check_equivalence_model),
    ("score-kernels", _check_score_kernels),
    ("memo-capacity", _check_memo_capacity),
    ("columns-mirror", _check_columns_mirror),
    ("queue-model", _check_queue_model),
    ("filter-differential", _check_filter_differential),
    ("mask-memo", _check_mask_memo),
    ("preempt-differential", _check_preempt_differential),
    ("stream-differential", _check_stream_differential),
    ("batch-differential", _check_batch_differential),
)


# ---- the sweep --------------------------------------------------------------


class _Timeout(Exception):
    pass


def _run_checks(timeout_s: float) -> Optional[str]:
    """Run the kill suite; the name of the first failing check, or None
    (the mutant survived). A wedged mutant trips the alarm and counts
    as killed — hanging the suite IS an observable difference."""
    use_alarm = (hasattr(signal, "SIGALRM")
                 and threading.current_thread()
                 is threading.main_thread())
    if use_alarm:
        def _fire(_sig: int, _frm: Any) -> None:
            raise _Timeout()

        old_handler = signal.signal(signal.SIGALRM, _fire)
        signal.alarm(max(1, int(timeout_s)))
    try:
        for name, check in KILL_CHECKS:
            try:
                check()
            except _Timeout:
                return "timeout"
            except MutationError:
                raise
            except Exception:
                return name
        return None
    finally:
        if use_alarm:
            signal.alarm(0)
            signal.signal(signal.SIGALRM, old_handler)


def run_sweep(ids: Optional[List[str]] = None,
              budget_s: Optional[float] = None,
              log: Optional[Callable[[str], None]] = None) -> Dict[str, Any]:
    """Apply each mutant, run the kill suite, restore, report.

    ``ids`` restricts the sweep (CI's pinned subset); ``budget_s``
    stops cleanly when the wall clock runs out (remaining mutants are
    reported ``skipped``, never silently dropped)."""
    _np()  # fail early with a typed error when numpy is absent
    from kubegpu_tpu_torch.analysis import explore

    if explore._ACTIVE is not None:
        raise MutationError(
            "the interleaving explorer is running: its virtualized locks "
            "and clocks would run the kill suite — sweep outside it")
    refs = enumerate_mutants()
    if ids is not None:
        by_id = {r.mutant_id: r for r in refs}
        missing = [i for i in ids if i not in by_id]
        if missing:
            raise MutationError(
                f"unknown mutant id(s): {', '.join(missing)} — "
                f"re-pin after changing the targeted closure "
                f"(--list-mutants)")
        refs = [by_id[i] for i in ids]
    saved_metrics = _save_metrics()
    try:
        return _sweep(refs, budget_s, log)
    finally:
        _restore_metrics(saved_metrics)


def _sweep(refs: List[MutantRef], budget_s: Optional[float],
           log: Optional[Callable[[str], None]]) -> Dict[str, Any]:
    t0 = time.monotonic()
    results: List[Dict[str, Any]] = []
    killed = survived = waived = skipped = 0
    # sanity: the unmutated tree must pass its own kill suite, or every
    # "kill" below would be noise
    baseline = _run_checks(MUTANT_TIMEOUT_S * 2)
    if baseline is not None:
        raise MutationError(
            f"kill suite fails on the UNMUTATED tree (check "
            f"{baseline!r}) — fix the oracle before measuring mutants")
    for ref in refs:
        entry = ref.describe()
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            entry["status"] = "skipped"
            skipped += 1
            results.append(entry)
            continue
        t_m = time.monotonic()
        waiver = WAIVERS.get(ref.mutant_id)
        if waiver is not None:
            entry["status"] = "waived"
            entry["justification"] = waiver
            waived += 1
            results.append(entry)
            continue
        try:
            patch = apply_mutant(ref)
        except SyntaxError:
            entry["status"] = "killed"
            entry["killed_by"] = "compile"
            killed += 1
            results.append(entry)
            continue
        try:
            failed = _run_checks(MUTANT_TIMEOUT_S)
        finally:
            patch.restore()
        entry["ms"] = round((time.monotonic() - t_m) * 1e3, 1)
        if failed is None:
            entry["status"] = "survived"
            survived += 1
        else:
            entry["status"] = "killed"
            entry["killed_by"] = failed
            killed += 1
        results.append(entry)
        if log is not None:
            log(f"{entry['status']:8s} {ref.mutant_id} "
                f"({entry.get('killed_by', '-')}, {entry.get('ms', 0)} ms)")
    measured = killed + survived
    return {
        "targets": [m for m, _p in TARGETS],
        "checks": [n for n, _c in KILL_CHECKS],
        "total": len(refs),
        "killed": killed,
        "survived": survived,
        "waived": waived,
        "skipped": skipped,
        "kill_rate": round(killed / measured, 4) if measured else None,
        "elapsed_s": round(time.monotonic() - t0, 2),
        "mutants": results,
    }


_METRIC_FIELDS = ("counts", "total", "n", "value")


def _metric_fields(obj: Any) -> Dict[str, Any]:
    return {f: list(getattr(obj, f)) if f == "counts" else getattr(obj, f)
            for f in _METRIC_FIELDS if hasattr(obj, f)}


def _save_metrics() -> List[Tuple[Any, Any, Any]]:
    """Every package metric's values, and each labeled family's children
    (the objects themselves): the kill suite's engines move them, and the
    sweep hands the process back as it found it."""
    from kubegpu_tpu_torch import metrics

    saved: List[Tuple[Any, Any, Any]] = []
    for metric in metrics.all_metrics():
        children = getattr(metric, "_children", None)
        if children is None:
            saved.append((metric, None, _metric_fields(metric)))
        else:
            saved.append((metric, dict(children),
                          {key: _metric_fields(child)
                           for key, child in children.items()}))
    return saved


def _restore_metrics(saved: List[Tuple[Any, Any, Any]]) -> None:
    for metric, children, fields in saved:
        if children is None:
            for field, value in fields.items():
                setattr(metric, field, value)
            continue
        metric._children = children
        for key, child in children.items():
            for field, value in fields[key].items():
                setattr(child, field, value)


def render_report(report: Dict[str, Any]) -> str:
    rate = report["kill_rate"]
    lines = [
        f"mutation sweep: {report['total']} mutant(s) over "
        f"{len(report['targets'])} module(s) — "
        f"{report['killed']} killed, {report['survived']} survived, "
        f"{report['waived']} waived, {report['skipped']} skipped "
        f"in {report['elapsed_s']}s"
        + (f" (kill rate {rate * 100:.1f}%)" if rate is not None else "")]
    by_check: Dict[str, int] = {}
    for m in report["mutants"]:
        if m["status"] == "killed":
            by_check[m["killed_by"]] = by_check.get(m["killed_by"], 0) + 1
    if by_check:
        lines.append("  kills by check: " + ", ".join(
            f"{n}={c}" for n, c in sorted(by_check.items(),
                                          key=lambda kv: -kv[1])))
    for m in report["mutants"]:
        if m["status"] == "survived":
            lines.append(
                f"  SURVIVOR {m['id']} — {m['function']} line {m['line']}"
                f": {m['before']}  [{m['op']}: {m['after']}]")
    for m in report["mutants"]:
        if m["status"] == "waived":
            lines.append(f"  waived   {m['id']} — {m['justification']}")
    if report["survived"]:
        lines.append(
            f"{report['survived']} unexplained survivor(s): each one is "
            f"a missing differential assertion (add it) or a real bug "
            f"(fix it) — or carries a justified WAIVERS entry")
    return "\n".join(lines)


def render_mutant_list(refs: List[MutantRef]) -> str:
    lines = [f"{len(refs)} mutant(s):"]
    for ref in refs:
        lines.append(f"  {ref.mutant_id:46s} {ref.module.rsplit('.', 1)[-1]}"
                     f":{ref.lineno:<5d} {ref.before}  -> {ref.after}")
    return "\n".join(lines)
