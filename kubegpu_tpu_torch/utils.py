"""Deterministic iteration helpers of the device side (the port's copy of
``kubegpu_tpu/utils.py``'s ``sorted_keys`` and ``assign_nested``).

Every map iteration that feeds an allocation decision is sorted, so
repeated runs of the scheduler give identical placements (reference:
`utils/utils.go:34-47`).
"""

from __future__ import annotations

from typing import Any, Iterable, Mapping


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
