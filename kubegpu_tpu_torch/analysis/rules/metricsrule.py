"""metric-registration: one metrics registry, consistent names.

Every metric the system emits is declared exactly once, at module level,
in ``metrics.py`` — so dashboards have one place to discover names and a
renamed metric cannot half-exist. Names are snake_case; counters carry
the ``_total`` suffix and histograms a unit suffix, Prometheus-style.
Modules emit through the declared module-level objects
(``metrics.EVICTIONS.inc()``); referencing an undeclared ``metrics.X``
is a typo that would otherwise surface as an AttributeError mid-flight.

Completeness is checked too: a metric declared in the registry must be
covered by ``reset_all()`` (or its value leaks across test/bench runs)
and by the Prometheus exposition (``prometheus_text``, wherever it
lives) — a function that iterates ``all_metrics()`` is exhaustive by
construction; one that hand-enumerates must name every declared metric.
This closes the drift class where a new metric silently never exports.

The port's copy of ``kubegpu_tpu/analysis/rules/metricsrule.py``.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator

from kubegpu_tpu_torch.analysis.engine import (Context, Finding, SourceFile,
                                         dotted_name)

_METRIC_TYPES = frozenset({"Counter", "Gauge", "Histogram",
                           "LabeledHistogram", "LabeledCounter",
                           "LabeledGauge"})
_SNAKE_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_HISTOGRAM_UNITS = ("_microseconds", "_milliseconds", "_seconds", "_us",
                    "_ms", "_bytes", "_total")


def _metric_ctor(node: ast.AST) -> str | None:
    """'Counter'/'Gauge'/'Histogram' when ``node`` constructs one."""
    if not isinstance(node, ast.Call):
        return None
    func = node.func
    if isinstance(func, ast.Name) and func.id in _METRIC_TYPES:
        return func.id
    if isinstance(func, ast.Attribute) and func.attr in _METRIC_TYPES:
        return func.attr
    return None


class MetricRegistration:
    name = "metric-registration"
    description = ("metrics are declared once in metrics.py, snake_case, "
                   "with the conventional unit suffix")

    def run(self, sources: list, ctx: Context) -> Iterator[Finding]:
        registry_src = None
        declared: set = set()
        for src in sources:
            if src.name == "metrics.py" and len(src.relparts) == 1:
                registry_src = src
        if registry_src is not None:
            declared = {
                t.id
                for node in registry_src.tree.body
                if isinstance(node, ast.Assign)
                for t in node.targets
                if isinstance(t, ast.Name)
            }
            yield from self._check_registry(registry_src)
            instances = self._metric_instances(registry_src)
            yield from self._check_coverage(
                registry_src, "reset_all", instances,
                "not reset by reset_all() — its value would leak across "
                "test/bench runs")
            for src in sources:
                yield from self._check_coverage(
                    src, "prometheus_text", instances,
                    "absent from the Prometheus exposition — it would "
                    "never export")
        for src in sources:
            yield from self._check_module(src, registry_src, declared)

    @staticmethod
    def _metric_instances(registry_src: SourceFile) -> dict:
        """{instance variable name: line} for every module-level metric
        declaration in the registry."""
        out: dict = {}
        for node in registry_src.tree.body:
            if isinstance(node, ast.Assign) and \
                    _metric_ctor(node.value) is not None:
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        out[t.id] = node.lineno
        return out

    def _check_coverage(self, src: SourceFile, fn_name: str,
                        instances: dict, why: str) -> Iterator[Finding]:
        """Every declared metric must be referenced inside ``fn_name``
        (by bare name or as ``metrics.X``) — unless the function calls
        ``all_metrics()``, which makes it registry-driven and exhaustive
        by construction."""
        fn = next((node for node in src.tree.body
                   if isinstance(node, ast.FunctionDef)
                   and node.name == fn_name), None)
        if fn is None:
            return
        referenced: set = set()
        registry_driven = False
        for node in ast.walk(fn):
            if isinstance(node, ast.Name):
                referenced.add(node.id)
            elif isinstance(node, ast.Attribute):
                referenced.add(node.attr)
            if isinstance(node, ast.Call):
                dotted = dotted_name(node.func) or ""
                if dotted.split(".")[-1] == "all_metrics":
                    registry_driven = True
        if registry_driven:
            return
        for name in sorted(set(instances) - referenced):
            yield Finding(
                self.name, src.path, fn.lineno,
                f"metric `{name}` is declared in metrics.py but {why}; "
                f"enumerate it in {fn_name}() or iterate all_metrics()")

    def _check_registry(self, src: SourceFile) -> Iterator[Finding]:
        seen: dict = {}
        for node in src.tree.body:
            if not isinstance(node, ast.Assign):
                continue
            kind = _metric_ctor(node.value)
            if kind is None:
                continue
            call = node.value
            if not call.args or not isinstance(call.args[0], ast.Constant) \
                    or not isinstance(call.args[0].value, str):
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"{kind} declared without a literal name — the "
                    f"registry must be greppable")
                continue
            metric_name = call.args[0].value
            if metric_name in seen:
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"metric name `{metric_name}` declared twice (first at "
                    f"line {seen[metric_name]})")
            seen[metric_name] = node.lineno
            if not _SNAKE_RE.match(metric_name):
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"metric name `{metric_name}` is not snake_case")
                continue
            if kind in ("Counter", "LabeledCounter") and \
                    not metric_name.endswith("_total"):
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"counter `{metric_name}` must end in `_total`")
            if kind == "Histogram" and \
                    not metric_name.endswith(_HISTOGRAM_UNITS):
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"histogram `{metric_name}` needs a unit suffix "
                    f"({', '.join(_HISTOGRAM_UNITS)})")

    def _check_module(self, src: SourceFile,
                      registry_src: SourceFile | None,
                      declared: set) -> Iterator[Finding]:
        for node in ast.walk(src.tree):
            kind = _metric_ctor(node)
            if kind is not None and src is not registry_src:
                # metric classes may be *defined* anywhere (fixtures,
                # forks of the registry), but instances live in metrics.py
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"{kind} instantiated outside metrics.py — declare it "
                    f"in the registry so the name exists exactly once")
            if registry_src is not None and isinstance(node, ast.Attribute) \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "metrics" and node.attr.isupper() \
                    and node.attr not in declared:
                yield Finding(
                    self.name, src.path, node.lineno,
                    f"`metrics.{node.attr}` is not declared in metrics.py "
                    f"— emitting an unregistered metric")
