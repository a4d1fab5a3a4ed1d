"""Systematic schedule enumeration over the cooperative runtime (the
port's copy of ``kubegpu_tpu/analysis/schedules.py``).

:mod:`explore` executes ONE schedule; this module searches the schedule
space the way CHESS and Loom do, with two standard reductions:

- **Bounded preemptions** — a context switch away from a thread that
  could have kept running costs one preemption; schedules are explored
  in order of preemption count up to a small bound (default 2). Almost
  every real concurrency bug, the lost updates the tests pin among
  them, needs only one or two preemptions to manifest.
- **Sleep sets** — after exploring the branch that runs thread *t* from
  a state, *t* is put to sleep for the sibling branches and only woken
  when a *dependent* operation executes (same lock/condition object;
  probes conservatively conflict with everything). A run that would
  schedule a sleeping thread is redundant — some explored run already
  covers its behavior — and is pruned without running its body further.

The search is **stateless** (re-execution based): a schedule is just the
decision prefix that forces the first N choices, after which the default
policy runs the current thread until it blocks. Every completed run
donates new frontier entries — one per (decision point, unexplored
runnable alternative). Determinism end to end: the same scenario, seed,
and budget produce the identical sequence of schedules, and a recorded
failure trace replays to the identical failure (:func:`replay`).

Public API::

    result = explore(scenario, max_schedules=500, preemption_bound=2)
    result.failure            # None, or a Failure with the full trace
    replay(scenario, result.failure)   # deterministic re-execution
    result.raise_if_failed()  # for use directly inside a test

A scenario is the same callable :func:`explore.run_one_schedule` takes:
``() -> (bodies, invariant)``, rebuilt fresh for every schedule.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import traceback
from typing import Callable

from kubegpu_tpu_torch.analysis.explore import (PruneRun,
                                                ReplayDivergence, RunRecord,
                                                run_one_schedule)


def _dependent(op_a: tuple, op_b: tuple) -> bool:
    """May these two operations NOT commute? Conservative: unknown
    first-ops and probes (which mark unguarded-state seams) conflict
    with everything; sync ops conflict when they touch the same
    object; virtual sleeps commute with everything else."""
    ka, kb = op_a[0], op_b[0]
    if ka == "sleep" or kb == "sleep":
        return False
    if ka in ("start", "probe") or kb in ("start", "probe"):
        return True
    obj_a = op_a[1] if len(op_a) > 1 else None
    obj_b = op_b[1] if len(op_b) > 1 else None
    return obj_a == obj_b


@dataclasses.dataclass
class Failure:
    """A failing schedule: what broke plus the exact decision trace that
    reproduces it. Serializable so a run can archive it as an artifact and
    a developer can replay it locally."""

    kind: str               # "body" | "deadlock" | "invariant"
    summary: str
    decisions: tuple        # full decision list of the failing run
    trace: list             # per-step dicts (chosen, op, runnable set)
    schedule_index: int     # how many schedules ran before this one
    seed: int
    traceback: str = ""

    def to_json(self) -> dict:
        return {"kind": self.kind, "summary": self.summary,
                "decisions": list(self.decisions), "trace": self.trace,
                "schedule_index": self.schedule_index, "seed": self.seed,
                "traceback": self.traceback}

    @classmethod
    def from_json(cls, data: dict) -> "Failure":
        return cls(kind=data["kind"], summary=data["summary"],
                   decisions=tuple(data["decisions"]),
                   trace=list(data.get("trace") or []),
                   schedule_index=int(data.get("schedule_index", 0)),
                   seed=int(data.get("seed", 0)),
                   traceback=data.get("traceback", ""))

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=2)

    @classmethod
    def load(cls, path: str) -> "Failure":
        with open(path, encoding="utf-8") as fh:
            return cls.from_json(json.load(fh))

    def render(self) -> str:
        lines = [f"{self.kind} failure after {self.schedule_index} "
                 f"schedule(s): {self.summary}", "schedule:"]
        for step in self.trace:
            op = step.get("op") or ["?"]
            lines.append(
                f"  [{step.get('i'):>3}] t{step.get('chosen')} "
                f"{' '.join(str(p) for p in op)}"
                + ("  (preempt)" if step.get("preempt") else ""))
        if self.traceback:
            lines.append(self.traceback.rstrip())
        return "\n".join(lines)


class ExplorationFailure(AssertionError):
    """Raised by :meth:`Result.raise_if_failed`: carries the Failure so
    the pytest output IS the replayable schedule."""

    def __init__(self, failure: Failure) -> None:
        super().__init__(failure.render())
        self.failure = failure


@dataclasses.dataclass
class Result:
    schedules: int = 0
    pruned: int = 0
    failure: Failure | None = None
    exhausted: bool = False   # frontier emptied within budget
    runs: list = dataclasses.field(default_factory=list)  # decision tuples

    @property
    def ok(self) -> bool:
        return self.failure is None

    def raise_if_failed(self) -> "Result":
        if self.failure is not None:
            raise ExplorationFailure(self.failure)
        return self

    def signature(self) -> tuple:
        """Determinism witness: the exact schedules executed, in order."""
        return tuple(self.runs)


def _failure_from_record(record: RunRecord, index: int,
                         seed: int) -> Failure:
    trace = [s.to_json() for s in record.steps]
    if record.body_excs:
        tid, exc = record.body_excs[0]
        tb = "".join(traceback.format_exception(
            type(exc), exc, exc.__traceback__))
        return Failure("body", f"thread {tid}: {type(exc).__name__}: {exc}",
                       record.decisions, trace, index, seed, tb)
    if record.deadlock is not None:
        return Failure("deadlock", record.deadlock, record.decisions,
                       trace, index, seed)
    exc = record.invariant_exc
    assert exc is not None
    tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
    return Failure("invariant", f"{type(exc).__name__}: {exc}",
                   record.decisions, trace, index, seed, tb)


class _Policy:
    """Schedule policy for one run: forced decision prefix, then
    run-to-block, with live sleep-set tracking (and pruning)."""

    def __init__(self, decisions: tuple, sleeps: dict,
                 prune: bool, strict: bool = False) -> None:
        self.decisions = decisions
        self.sleeps = sleeps          # step index -> frozenset of tids
        self.prune = prune
        self.strict = strict          # replay mode: diverge loudly
        self.sleep_history: list = []  # sleep set at entry to each step
        self._sleeping: set = set()

    def __call__(self, step: int, cands: list, last: int | None) -> int:
        self._sleeping |= self.sleeps.get(step, frozenset())
        self.sleep_history.append(frozenset(self._sleeping))
        tids = [t for t, _ in cands]
        if step < len(self.decisions):
            choice = self.decisions[step]
            if choice not in tids:
                raise ReplayDivergence(
                    f"step {step}: forced thread t{choice} is not "
                    f"runnable (candidates: {tids}) — scenario is "
                    f"nondeterministic or the code under test changed")
        else:
            if self.strict:
                raise ReplayDivergence(
                    f"step {step}: replayed trace ended but threads are "
                    f"still runnable ({tids})")
            avail = [t for t in tids if t not in self._sleeping]
            if not avail:
                if self.prune:
                    raise PruneRun()
                avail = tids
            choice = last if last in avail else avail[0]
        ops = dict(cands)
        op = ops[choice]
        self._sleeping = {t for t in self._sleeping if t != choice and
                          not _dependent(ops.get(t, ("start", "?")), op)}
        return choice


@dataclasses.dataclass(frozen=True)
class _Entry:
    decisions: tuple
    sleeps: tuple  # ((step, frozenset), ...) — hashable form


def explore(scenario: Callable[[], tuple], *,
            max_schedules: int = 1000,
            preemption_bound: int = 2,
            seed: int = 0,
            prune: bool = True,
            stop_on_failure: bool = True,
            watchdog_s: float = 20.0,
            keep_runs: int = 4096) -> Result:
    """Systematically execute schedules of ``scenario`` until a failure,
    the frontier is exhausted, or ``max_schedules`` runs have executed.

    ``seed`` only permutes the order alternatives are pushed (the search
    remains exhaustive within its budget); the same seed always yields
    the identical exploration sequence.
    """
    rng = random.Random(seed)
    result = Result()
    seen: set = set()
    stack: list = [_Entry((), ())]
    while stack and result.schedules < max_schedules:
        entry = stack.pop()
        if entry.decisions in seen:
            continue
        seen.add(entry.decisions)
        policy = _Policy(entry.decisions, dict(entry.sleeps), prune=prune)
        record = run_one_schedule(scenario, policy, watchdog_s=watchdog_s)
        result.schedules += 1
        if len(result.runs) < keep_runs:
            result.runs.append(record.decisions)
        if record.pruned:
            result.pruned += 1
            continue
        if record.failed:
            result.failure = _failure_from_record(
                record, result.schedules - 1, seed)
            _archive_failure(scenario, result.failure)
            if stop_on_failure:
                return result
            continue
        _push_branches(stack, entry, record, policy, preemption_bound, rng)
    result.exhausted = not stack
    return result


def _archive_failure(scenario: Callable, failure: Failure) -> None:
    """When ``KGTPU_EXPLORE_TRACE_DIR`` is set (a deep-exploration
    job), every failing schedule trace is written there so the artifact
    IS the reproducer: ``replay(scenario, Failure.load(path))``."""
    trace_dir = os.environ.get("KGTPU_EXPLORE_TRACE_DIR")
    if not trace_dir:
        return
    os.makedirs(trace_dir, exist_ok=True)
    name = getattr(scenario, "__name__", "scenario")
    # schedule_index in the name: distinct failing schedules of the same
    # scenario+seed (stop_on_failure=False, or re-runs at other budgets)
    # must not overwrite each other's reproducer
    failure.dump(os.path.join(
        trace_dir,
        f"{name}-seed{failure.seed}-s{failure.schedule_index}.json"))


def _push_branches(stack: list, entry: _Entry, record: RunRecord,
                   policy: _Policy, preemption_bound: int,
                   rng: random.Random) -> None:
    """Frontier expansion: for every decision point at or beyond this
    entry's own branch point, one child per unexplored, awake,
    within-preemption-budget alternative. Children are pushed deepest-
    first so the DFS finishes one subtree before starting the next."""
    preemptions = 0
    floor = len(entry.decisions)
    children: list = []
    for step in record.steps:
        i = step.index
        if i < floor:
            preemptions += 1 if step.preempt else 0
            continue
        sleeping = policy.sleep_history[i] if i < len(policy.sleep_history) \
            else frozenset()
        tids = [t for t, _ in step.runnable]
        alts = [t for t in tids
                if t != step.chosen and t not in sleeping]
        rng.shuffle(alts)
        explored = [step.chosen]
        for alt in alts:
            cost = 1 if (step.last is not None and step.last in tids
                         and alt != step.last) else 0
            if preemptions + cost > preemption_bound:
                explored.append(alt)
                continue
            sleeps = dict(entry.sleeps)
            sleeps[i] = frozenset(sleeping | set(explored))
            children.append(_Entry(
                record.decisions[:i] + (alt,),
                tuple(sorted(sleeps.items()))))
            explored.append(alt)
        preemptions += 1 if step.preempt else 0
    for child in reversed(children):
        stack.append(child)


def replay(scenario: Callable[[], tuple],
           failure: "Failure | tuple | list",
           watchdog_s: float = 20.0) -> Failure:
    """Re-execute a recorded failing schedule exactly. Returns the fresh
    Failure (raises :class:`ReplayDivergence` when the trace no longer
    matches, and :class:`ExplorationFailure` is NOT raised — callers
    compare the returned failure to the recorded one)."""
    decisions = tuple(failure.decisions) \
        if isinstance(failure, Failure) else tuple(failure)
    seed = failure.seed if isinstance(failure, Failure) else 0
    policy = _Policy(decisions, {}, prune=False, strict=True)
    record = run_one_schedule(scenario, policy, watchdog_s=watchdog_s)
    if not record.failed:
        raise ReplayDivergence(
            "replayed schedule did not fail — scenario is "
            "nondeterministic or the code under test changed")
    return _failure_from_record(record, 0, seed)


__all__ = ["ExplorationFailure", "Failure", "Result", "explore", "replay"]
