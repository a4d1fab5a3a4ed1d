"""Deterministic helpers of the device side and the scheduling engine (the
port's copy of ``kubegpu_tpu/utils.py``'s ``sorted_keys``,
``assign_nested`` and ``list_bound_pods``, and of
``kubegpu_tpu/plugins.py``'s loader).

Every map iteration that feeds an allocation decision is sorted, so
repeated runs of the scheduler give identical placements (reference:
`utils/utils.go:34-47`).
"""

from __future__ import annotations

import importlib.util
import logging
import os
from typing import Any, Iterable, Mapping

log = logging.getLogger(__name__)


def sorted_keys(m: Mapping[str, Any]) -> list[str]:
    """Deterministic iteration order for any string-keyed mapping.

    Reference: `utils/utils.go:34-47` (SortedStringKeys).
    """
    return sorted(m.keys())


def assign_nested(d: dict, keys: Iterable[str], value: Any) -> None:
    """Assign ``value`` at the nested path ``keys``, creating dicts on the way.

    Reference: `utils/maputils.go:43-55` (AssignMap).
    """
    keys = list(keys)
    for k in keys[:-1]:
        d = d.setdefault(k, {})
    d[keys[-1]] = value


def list_bound_pods(api: Any) -> list:
    """Every pod with ``spec.nodeName`` set, via the API server's
    pods-by-node index when the client exposes it (``bound=True``),
    falling back to a full list + filter for clients without one — the
    shared read behind preemption's victim scan and its PDB state."""
    try:
        return api.list_pods(bound=True)
    except TypeError:
        return [p for p in api.list_pods()
                if (p.get("spec") or {}).get("nodeName")]


def load_plugins(directory: str, symbol: str) -> list:
    """Import every ``*.py`` in ``directory`` (sorted; names starting with
    ``_`` skipped) and call its ``symbol`` factory. A file that fails to
    import, lacks the factory or whose factory raises is skipped with a
    log line: one broken plugin must not take the node agent or the
    scheduler down."""
    plugins: list = []
    if not directory or not os.path.isdir(directory):
        return plugins
    for fname in sorted(os.listdir(directory)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        path = os.path.join(directory, fname)
        try:
            spec = importlib.util.spec_from_file_location(
                f"kubegpu_tpu_torch_plugin_{fname[:-3]}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            plugins.append(getattr(mod, symbol)())
        except Exception:
            log.exception("plugin %s failed to load, skipping", path)
    return plugins
