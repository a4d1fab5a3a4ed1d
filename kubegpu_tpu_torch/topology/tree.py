"""Canonical inventory-shape trees (the port's copy of
``kubegpu_tpu/topology/tree.py``, defaulting to the GPU grammar's names).

A node's advertised group hierarchy canonicalizes to a sorted tree whose
shape is independent of group labels, so identical topologies dedup across
nodes and "which node shape fits this request best" is a tree lookup.
Reference: `device-scheduler/types/typeutils.go` (sorted tree) and
`plugins/gpuschedulerplugin/gpu.go:68-129` (building/scoring from the
resource list).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

from kubegpu_tpu_torch.core import grammar
from kubegpu_tpu_torch.utils import sorted_keys


@dataclass
class SortedTreeNode:
    """Tree node; children kept in descending (val, score) order.

    Reference: `device-scheduler/types/types.go:38-42`.
    """

    val: int = 0
    score: float = 0.0
    children: list = field(default_factory=list)

    def add_child(self, child: "SortedTreeNode") -> "SortedTreeNode":
        """Insert keeping descending order (`typeutils.go:5-29`)."""
        at = len(self.children)
        for i, existing in enumerate(self.children):
            if existing.val < child.val or (
                existing.val == child.val and existing.score < child.score
            ):
                at = i
                break
        # racer: single-writer -- a tree is built, then read, by the one
        # allocation call that made it; no tree is shared between threads
        self.children.insert(at, child)
        return child

    def add_value(self, val: int, score: float = 0.0) -> "SortedTreeNode":
        return self.add_child(SortedTreeNode(val=val, score=score))


def compare_trees(a: SortedTreeNode | None, b: SortedTreeNode | None) -> bool:
    """Structural equality on (val, children) — scores excluded
    (`typeutils.go:53-70`)."""
    if a is None and b is None:
        return True
    if a is None or b is None:
        return False
    if a.val != b.val or len(a.children) != len(b.children):
        return False
    return all(compare_trees(x, y) for x, y in zip(a.children, b.children))


def _score_at_level(node: SortedTreeNode, level: int, num_children: int) -> float:
    score = (node.val * level / num_children) if num_children else 0.0
    for child in node.children:
        score += _score_at_level(child, level + 1, len(node.children))
    return score


def compute_tree_score(node: SortedTreeNode) -> float:
    """Depth-weighted capacity score: deeper, denser hierarchies score
    higher, so auto-topology prefers the best-connected shape
    (`gpu.go:119-129`)."""
    return _score_at_level(node, 0, len(node.children))


def tree_from_resources(
    resources: dict,
    partition_prefix: str = grammar.GPU_GRP_STEM,
    suffix: str = grammar.CARDS_SUFFIX,
    levels: int = 1,
) -> SortedTreeNode:
    """Canonicalize a group-resource list into a shape tree.

    ``levels=1`` consumes ``gpugrp1`` then ``gpugrp0`` (two grouping levels
    above the leaf), matching the reference call
    ``addToNode(nil, res, "gpugrp", "cards", 1)`` (`gpu.go:136`).
    """
    return _add_level(None, resources, partition_prefix, suffix, levels)


def _add_level(node, resources, partition_prefix, suffix, level):
    pattern = re.compile(
        rf".*/{partition_prefix}{level}/(.*?)/.*/{suffix}$")
    by_group: dict = {}
    total = 0
    for res_key in sorted_keys(resources):
        m = pattern.match(res_key)
        if m:
            by_group.setdefault(m.group(1), {})[res_key] = resources[res_key]
            total += 1
    if node is None:
        node = SortedTreeNode(val=total)
    for group_key in sorted_keys(by_group):
        sub = by_group[group_key]
        child = SortedTreeNode(val=len(sub))
        if level > 0:
            _add_level(child, sub, partition_prefix, suffix, level - 1)
            child.score = compute_tree_score(child)
        node.add_child(child)
    return node
