"""Pluggable per-resource scoring functions (the port's copy of
``kubegpu_tpu/allocator/scorers.py``).

A scorer answers, for one resource, "does the request fit, how good is this
placement, and what do pod/node usage become if we take it?" — signature
mirrors `grpalloc/scorer/types.go:6`:

    score(allocatable, used_by_pod, used_by_node, requested, init_container)
        -> ScoreResult(found, score, used_by_container,
                       new_used_by_pod, new_used_by_node)

Two families exist (reference `grpalloc/scorer/scorer.go`):

- **leftover** (`scorer.go:12-47`): packing score ``1 - leftover/allocatable``
  for countable resources (cards, memory bytes). Init containers use
  *max-not-sum* semantics: an init container runs before the main
  containers, so its usage overlaps rather than adds
  (`scorer.go:24-34`).
- **enum** (`scorer.go:77-108`): bitmask resources (``enum*`` leaves). A request fits if any requested bit is available; score is the
  popcount fraction in use. Enum resources are attributes, not consumed:
  node usage is never incremented (`scorer.go:105`).

Selection is by a small int enum carried in pod/node specs
(`device-scheduler/types/types.go:32-36`); resources whose leaf segment
starts with ``enum`` auto-route to the enum scorer.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

from kubegpu_tpu_torch.core import grammar

# Scorer-selection enum (reference: `device-scheduler/types/types.go:32-36`).
DEFAULT_SCORER = 0
LEFTOVER_SCORER = 1
ENUM_LEFTOVER_SCORER = 2


class ScoreResult(NamedTuple):
    found: bool
    score: float
    used_by_container: int
    new_used_by_pod: int
    new_used_by_node: int


ScoreFunc = Callable[[int, int, int, Sequence[int], bool], ScoreResult]


def leftover_score(
    allocatable: int,
    used_by_pod: int,
    used_by_node: int,
    requested: Sequence[int],
    init_container: bool,
) -> ScoreResult:
    """Packing score for countable resources (`scorer.go:12-47`)."""
    total = sum(requested) if requested else 0
    if not init_container:
        new_used_by_pod = used_by_pod + total
    else:
        # Init containers run sequentially before main containers: the pod's
        # demand is the max over phases, not the sum (`scorer.go:24-34`).
        new_used_by_pod = max(used_by_pod, total)
    new_used_by_node = used_by_node + (new_used_by_pod - used_by_pod)

    leftover = allocatable - new_used_by_node
    score = 1.0 - (leftover / allocatable) if allocatable != 0 else 0.0
    return ScoreResult(leftover >= 0, score, total, new_used_by_pod, new_used_by_node)


def always_found_score(
    allocatable: int,
    used_by_pod: int,
    used_by_node: int,
    requested: Sequence[int],
    init_container: bool,
) -> ScoreResult:
    """Soft variant: never rejects, scores proximity (`scorer.go:49-60`)."""
    r = leftover_score(allocatable, used_by_pod, used_by_node, requested, init_container)
    diff = max(-1.0, 1.0 - r.score)
    return ScoreResult(True, 1.0 - abs(diff), r.used_by_container,
                       r.new_used_by_pod, r.new_used_by_node)


def enum_score(
    allocatable: int,
    used_by_pod: int,
    used_by_node: int,
    requested: Sequence[int],
    init_container: bool,
) -> ScoreResult:
    """Bitmask match for enum-typed attributes (`scorer.go:77-108`)."""
    total = 0
    for r in requested or ():
        total |= r
    used_mask = allocatable & (used_by_pod | total)
    bits_alloc = bin(allocatable & ((1 << 64) - 1)).count("1")
    bits_used = bin(used_mask & ((1 << 64) - 1)).count("1")
    score = 1.0 - (bits_alloc - bits_used) / bits_alloc if bits_alloc else 0.0
    found = (allocatable & total) != 0 if total != 0 else True
    # Attributes are matched, not consumed: node usage stays untouched.
    return ScoreResult(found, score, total, used_mask, 0)


def default_scorer(resource: str) -> ScoreFunc | None:
    """Scorer for a resource with no explicit selection (`scorer.go:111-119`)."""
    if grammar.prechecked_resource(resource):
        return None
    if grammar.is_enum_resource(resource):
        return enum_score
    return leftover_score


def scorer_for(resource: str, scorer_type: int) -> ScoreFunc | None:
    """Resolve the scorer enum for one resource (`scorer.go:121-132`)."""
    if scorer_type == DEFAULT_SCORER:
        return default_scorer(resource)
    if scorer_type == LEFTOVER_SCORER:
        return leftover_score
    if scorer_type == ENUM_LEFTOVER_SCORER:
        return enum_score
    return None
