"""Mutant twins of `tests/test_racer_fixes.py` over the port's classes.

Each race a static lockset pass found in the JAX package has a fix the port
carries too: the fix is mutated back out as a minimal subclass, the port's
interleaving explorer rediscovers the race deterministically within
``BUDGET`` schedules, and the fixed class passes the identical scenario on
every schedule. The scenarios and mutants are in
`kubegpu_tpu_torch/analysis/races.py`. The three races:

1. ``HTTPAPIClient._count_retry``: an unguarded ``+= 1`` from every thread
   with a keep-alive connection loses updates.
2. ``Elector._count_transition``: ``stop()`` on the owner thread can bump
   concurrently with a ``tick()`` still finishing on the elector thread.
3. ``NodeLifecycle._flush_pending_requeues``: stop()'s last-chance drain
   runs after a timed join, so a wedged tick can still be flushing;
   without the claim under the lock both flushers walk the same map and
   create and count the same replacement pod twice.

(The JAX file's last test holds its static racer rule to the first twin;
the port has no such rule.)
"""

import pytest

pytest.importorskip("torch")

from kubegpu_tpu_torch.analysis import races  # noqa: E402
from kubegpu_tpu_torch.analysis import schedules as sch  # noqa: E402
from kubegpu_tpu_torch.cluster.httpapi import HTTPAPIClient  # noqa: E402
from kubegpu_tpu_torch.cluster.lease import Elector  # noqa: E402
from kubegpu_tpu_torch.scheduler.lifecycle import NodeLifecycle  # noqa: E402

BUDGET = races.RACER_BUDGET  # 400


# ---- 1. client retry counter ------------------------------------------------


def test_unguarded_retry_count_race_rediscovered():
    res = sch.explore(races.retry_count(races.UnguardedRetryClient),
                      max_schedules=BUDGET, seed=0)
    assert res.failure is not None, "mutant race not found"
    assert "lost retry count" in res.failure.summary
    # the recorded schedule replays to the same failing decisions
    again = sch.replay(races.retry_count(races.UnguardedRetryClient),
                       res.failure)
    assert again.decisions == res.failure.decisions
    assert "lost retry count" in again.summary


def test_guarded_retry_count_is_clean_every_schedule():
    res = sch.explore(races.retry_count(HTTPAPIClient),
                      max_schedules=BUDGET, seed=0)
    assert res.ok, res.failure and res.failure.summary
    assert res.exhausted


# ---- 2. elector transition counter -----------------------------------------


def test_unguarded_transitions_race_rediscovered():
    res = sch.explore(races.transitions(races.UnguardedTransitionElector),
                      max_schedules=BUDGET, seed=0)
    assert res.failure is not None
    assert "lost transition count" in res.failure.summary


def test_guarded_transitions_clean_every_schedule():
    res = sch.explore(races.transitions(Elector),
                      max_schedules=BUDGET, seed=0)
    assert res.ok, res.failure and res.failure.summary
    assert res.exhausted


# ---- 3. lifecycle pending-requeue double drain -----------------------------


def test_unclaimed_double_drain_race_rediscovered():
    res = sch.explore(races.double_drain(races.UnclaimedFlushLifecycle),
                      max_schedules=BUDGET, seed=0)
    assert res.failure is not None, "mutant double-drain not found"
    # the race shows as a double-counted requeue OR as the shared map
    # mutating under a concurrent flusher's feet (KeyError), whichever
    # schedule the explorer hits first
    assert "counted 2 times" in res.failure.summary or \
        "KeyError" in res.failure.summary


def test_claimed_drain_is_exactly_once_every_schedule():
    res = sch.explore(races.double_drain(NodeLifecycle),
                      max_schedules=BUDGET, seed=0)
    assert res.ok, res.failure and res.failure.summary
    assert res.exhausted
