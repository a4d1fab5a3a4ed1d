"""Resource translation: promote requests up the topology hierarchy (the
port's copy of ``kubegpu_tpu/allocator/translate.py``).

A node may advertise its cards nested deeper than the pod requested — e.g.
the pod asks for ``gpu/0/cards`` but the node advertises
``gpugrp1/0/gpugrp0/1/gpu/<UUID>/cards``. Translation rewrites request paths
one topology level at a time so the request tree matches the node's
advertised shape, assigning fresh group indices deterministically
(reference: `grpalloc/resource/resourcetranslate.go:35-95`).

Also defines the predicate-failure type the scheduler surfaces when a node
cannot satisfy a request (`resourcetranslate.go:101-126`).
"""

from __future__ import annotations

import functools
import re

from kubegpu_tpu_torch.utils import sorted_keys


@functools.lru_cache(maxsize=256)
def _stage_patterns(this_stage: str, next_stage: str):
    return (
        re.compile(rf".*/{this_stage}/(.*?)/{next_stage}(.*)"),
        re.compile(rf"(.*?/){next_stage}/((.*?)/(.*))"),
    )


def translate_resource(
    node_resources: dict,
    container_requests: dict,
    this_stage: str,
    next_stage: str,
) -> tuple[bool, dict]:
    """Promote ``next_stage`` requests under a ``this_stage`` level.

    Returns ``(modified, new_requests)``. No-op unless the node actually
    advertises ``this_stage`` above ``next_stage``. Requests already at
    ``this_stage`` keep their indices; promoted requests get fresh indices
    starting past the highest numeric index already present, one per
    distinct ``next_stage`` group, assigned in sorted-key order so the
    rewrite is deterministic (`resourcetranslate.go:52-94`).
    """
    staged_re, promote_re = _stage_patterns(this_stage, next_stage)
    # Does the node nest next_stage under this_stage at all?
    if not any(staged_re.match(res) for res in node_resources):
        return False, container_requests

    max_index = -1
    for res in container_requests:
        m = staged_re.match(res)
        if m:
            try:
                max_index = max(max_index, int(m.group(1)))
            except ValueError:
                pass

    next_index = max_index + 1
    group_map: dict = {}
    new_requests: dict = {}
    modified = False
    for res in sorted_keys(container_requests):
        val = container_requests[res]
        new_key = res
        if not staged_re.match(res):
            m = promote_re.match(res)
            if m:
                grp = m.group(3)
                if grp not in group_map:
                    group_map[grp] = str(next_index)
                    next_index += 1
                new_key = f"{m.group(1)}{this_stage}/{group_map[grp]}/{next_stage}/{m.group(2)}"
                modified = True
        new_requests[new_key] = val

    return modified, new_requests


class InsufficientResourceError(Exception):
    """Predicate failure: a resource limit blocked the fit.

    Reference: `resourcetranslate.go:101-126`. Carried as a reason list,
    not raised, on the normal path.
    """

    def __init__(self, resource_name: str, requested: int = 0, used: int = 0,
                 capacity: int = 0):
        self.resource_name = resource_name
        self.requested = requested
        self.used = used
        self.capacity = capacity
        super().__init__(self.reason())

    def reason(self) -> str:
        return f"Insufficient {self.resource_name}"

    def info(self) -> tuple:
        return (self.resource_name, self.requested, self.used, self.capacity)

    def __eq__(self, other):
        return isinstance(other, InsufficientResourceError) and self.info() == other.info()

    def __hash__(self):
        return hash(self.info())
