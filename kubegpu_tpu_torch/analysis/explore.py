"""Deterministic interleaving explorer, the cooperative runtime half (the
port's copy of ``kubegpu_tpu/analysis/explore.py``).

A stress test observes whatever interleaving the OS happens to produce,
and the OS almost never produces the bad one. This module removes the OS
from the picture: during an exploration run every lock, condition, queue
wait and clock the port's package creates is *virtualized* onto a
cooperative scheduler, the "threads" of a scenario are serialized so
exactly one runs at a time, and the one schedule decision, *who runs
next*, is made explicitly at every synchronization point. A schedule is
therefore a replayable list of decisions, and :mod:`schedules` enumerates
them systematically (a CHESS/Loom-style bounded search).

Layering:

- :class:`CoopLock` / :class:`CoopCondition`: drop-in lock/condition
  primitives that yield to the controller at every acquire/release/wait/
  notify. The ``threading`` factories are patched for the duration of a
  run, gated on the *creating module* being inside ``kubegpu_tpu_torch``
  (the name is the package's, or starts with it and a dot), so stdlib,
  third-party and the JAX package's locks keep their native types.
  Whatever factories were installed before a run (a lock-order harness's,
  say) are saved and restored exactly.
- Virtual time: ``time.monotonic``/``time.time``/``time.perf_counter``
  return a virtual clock (and ``time.sleep`` parks cooperatively) for
  explorer threads only; the clock advances exactly when every thread is
  blocked, so a ``Condition.wait(timeout)`` in ``queue.pop`` times out
  deterministically instead of racing a wall clock.
- :func:`probe`: the package-side sync-point hook. Production code calls
  ``probe("cache.assume_pod")`` at seams the lock structure alone cannot
  see (the gap between two locked regions); when no exploration is
  active this is a single global load and ``is None`` test, so the
  production hot path is untouched.
- :func:`run_one_schedule`: execute one scenario under one schedule
  policy and return the full decision record. :mod:`schedules` builds the
  systematic search (and the public ``explore``/``replay`` API) on top of
  this.

A *scenario* is a zero-argument callable returning ``(bodies,
invariant)``: ``bodies`` is the list of thread callables to interleave and
``invariant`` (may be ``None``) is called after every body finished and
must raise (normally ``AssertionError``) when a safety property is
violated. The scenario is re-built from scratch for every schedule, so it
must be deterministic.

The JAX package's explorer gates on the prefix ``kubegpu_tpu``, which the
port's module names also carry: a run of either explorer refuses to nest
inside a run of the same one, but the two must not be nested in each
other either.

Stdlib only.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Sequence

_real_lock_factory = threading.Lock
_real_rlock_factory = threading.RLock
_real_condition = threading.Condition
_real_monotonic = time.monotonic
_real_perf_counter = time.perf_counter
# clock virtualization must capture the wall clock itself
_real_time = time.time  # analysis: disable=monotonic-time -- the virtualization layer wraps the real wall clock
_real_sleep = time.sleep

_PACKAGE_PREFIX = "kubegpu_tpu_torch"

# The controller of the schedule run in progress, or None. `probe` and
# the patched time functions read it on every call — keep it a single
# module global so the inactive cost is one load + identity test.
_ACTIVE: "Controller | None" = None

_tls = threading.local()  # .vthread -> the VThread running on this OS thread


def probe(label: str) -> None:
    """Package-side sync-point hook: a schedule decision point at a seam
    the lock structure cannot see. No-op unless an exploration run is
    active AND the calling thread is one of its virtual threads."""
    ctl = _ACTIVE
    if ctl is not None:
        ctl.probe(label)


def current_vthread() -> "VThread | None":
    vt = getattr(_tls, "vthread", None)
    if vt is not None and _ACTIVE is not None and vt.ctl is _ACTIVE:
        return vt
    return None


class ExploreError(Exception):
    """Explorer misuse or a wedged schedule (non-cooperative blocking)."""


class PruneRun(Exception):
    """Raised by a schedule policy: this run is redundant (sleep-set
    equivalent to an explored one); abandon it without running bodies
    further or checking the invariant."""


class ReplayDivergence(ExploreError):
    """A forced decision trace no longer matches the scenario — the
    scenario is nondeterministic or the code under test changed."""


class _Abort(BaseException):
    # BaseException so scenario code's `except Exception` cannot swallow
    # the teardown signal that unwinds a parked virtual thread.
    pass


def _site_label(depth: int) -> str:
    frame = sys._getframe(depth)
    path = frame.f_code.co_filename
    parts = path.replace(os.sep, "/").split("/")
    if _PACKAGE_PREFIX in parts:
        path = "/".join(parts[parts.index(_PACKAGE_PREFIX):])
    else:
        path = "/".join(parts[-2:])
    return f"{path}:{frame.f_lineno}"


def _caller_module(depth: int) -> str:
    return sys._getframe(depth + 1).f_globals.get("__name__", "")


def _in_package(module: str) -> bool:
    """Whether ``module`` is the port's package or one of its modules (a
    module boundary: ``kubegpu_tpu_torchx`` is not inside)."""
    return module == _PACKAGE_PREFIX or \
        module.startswith(_PACKAGE_PREFIX + ".")


# ---- virtual threads --------------------------------------------------------

RUNNABLE = "runnable"
BLOCKED = "blocked"
DONE = "done"


class VThread:
    """One logical thread of a scenario, carried by a real (token-
    passing) OS thread: it runs only while it holds the controller's
    token, and hands the token back at every synchronization point."""

    def __init__(self, tid: int, fn: Callable[[], object],
                 ctl: "Controller") -> None:
        self.tid = tid
        self.fn = fn
        self.ctl = ctl
        self.state = RUNNABLE
        self.next_op: tuple = ("start", f"t{tid}")
        self.deadline: float | None = None
        self.wake_reason: str | None = None
        self.exc: BaseException | None = None
        self._event = threading.Event()
        self._thread = threading.Thread(
            target=self._main, name=f"explore-t{tid}", daemon=True)
        self._thread.start()

    def _main(self) -> None:
        _tls.vthread = self
        try:
            self._wait_turn()
            self.fn()
        except _Abort:
            pass
        except BaseException as e:  # recorded, surfaced as the failure
            self.exc = e
        finally:
            self.state = DONE
            _tls.vthread = None
            self.ctl._token.set()

    def _wait_turn(self) -> None:
        self._event.wait()
        # racer: single-writer -- explorer token-passing: at most one
        # thread runs between sync points
        self._event.clear()
        if self.ctl._aborting:
            raise _Abort()

    def _resume(self) -> None:
        self._event.set()

    def join(self, timeout: float) -> None:
        self._thread.join(timeout)


# ---- cooperative primitives -------------------------------------------------


def _guard_foreign_thread(label: str) -> None:
    """A cooperative primitive touched by a NON-virtual thread while the
    scenario's bodies are still live means the scenario spawned a real
    OS thread the explorer cannot serialize — mutual exclusion and
    notify delivery would silently diverge from the model. Fail loudly
    instead (the vt-None fallback is only safe during scenario build
    and the post-run invariant phase, when no virtual thread is live)."""
    ctl = _ACTIVE
    if ctl is not None and ctl.bodies_live:
        raise ExploreError(
            f"non-virtual thread touched cooperative {label} during an "
            f"exploration run — the scenario spawns real threads the "
            f"explorer cannot serialize; drive that code from a scenario "
            f"body instead")


class CoopLock:
    """Cooperative Lock/RLock. Outside a run (or from a non-virtual
    thread, e.g. the invariant check after every body finished) it
    degrades to a real RLock; inside a run, ownership is tracked
    explicitly — only one virtual thread executes at a time, so no real
    locking is needed — and every acquire/release is a schedule decision
    point."""

    def __init__(self, reentrant: bool, site: str | None = None) -> None:
        self.reentrant = reentrant
        ctl = _ACTIVE
        n = ctl.next_object_index() if ctl is not None else 0
        kind = "rlock" if reentrant else "lock"
        self.label = f"{kind}#{n}@{site or _site_label(2)}"
        self.owner: VThread | None = None
        self.depth = 0
        self._fallback = _real_rlock_factory()

    # -- lock protocol --------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        vt = current_vthread()
        if vt is None:
            _guard_foreign_thread(self.label)
            if not blocking:
                return self._fallback.acquire(False)
            if timeout is not None and timeout >= 0:
                return self._fallback.acquire(True, timeout)
            return self._fallback.acquire()
        ctl = vt.ctl
        ctl.yield_op(vt, ("acquire", self.label))
        if self.owner is vt:
            if not self.reentrant:
                raise ExploreError(
                    f"non-reentrant {self.label} re-acquired by its owner "
                    f"(self-deadlock)")
            self.depth += 1
            return True
        deadline = None
        if blocking and timeout is not None and timeout >= 0:
            deadline = ctl.clock + timeout
        while self.owner is not None:
            if not blocking:
                return False
            reason = ctl.yield_blocked(vt, self, deadline,
                                       ("blocked", self.label))
            if reason == "timeout":
                return False
        self.owner = vt
        self.depth = 1
        return True

    def release(self) -> None:
        vt = current_vthread()
        if vt is None:
            _guard_foreign_thread(self.label)
            self._fallback.release()
            return
        if self.owner is not vt:
            raise RuntimeError(f"release of un-owned {self.label}")
        self.depth -= 1
        if self.depth == 0:
            self.owner = None
            vt.ctl.wake_lock_waiters(self)
            # the region boundary is itself a decision point: the gap
            # between two locked regions is where lost updates live
            vt.ctl.yield_op(vt, ("release", self.label))

    def locked(self) -> bool:
        if current_vthread() is None and _ACTIVE is None:
            if self._fallback.acquire(False):
                self._fallback.release()
                return False
            return True
        return self.owner is not None

    def __enter__(self) -> "CoopLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<CoopLock {self.label} owner={self.owner}>"

    # -- internal: full release/restore for Condition.wait --------------------

    def _release_all(self, vt: VThread) -> int:
        if self.owner is not vt:
            raise RuntimeError(f"wait() on un-owned {self.label}")
        # racer: single-writer -- explorer token-passing: at most one
        # thread runs between sync points
        depth, self.depth, self.owner = self.depth, 0, None
        vt.ctl.wake_lock_waiters(self)
        return depth

    def _reacquire(self, vt: VThread, depth: int) -> None:
        ctl = vt.ctl
        ctl.yield_op(vt, ("reacquire", self.label))
        while self.owner is not None:
            ctl.yield_blocked(vt, self, None, ("blocked", self.label))
        self.owner = vt
        self.depth = depth


class CoopCondition:
    """Cooperative Condition over a :class:`CoopLock`. ``wait`` parks the
    thread with a *virtual* deadline — the controller advances the clock
    to it exactly when nothing else can run, so timeout-polling loops
    (``SchedulingQueue.pop``) explore deterministically."""

    def __init__(self, lock: CoopLock | None = None,
                 site: str | None = None) -> None:
        if lock is None:
            lock = CoopLock(reentrant=True, site=site or _site_label(2))
        self._lock = lock
        # the condition shares its lock's dependency identity: a wait
        # releases the lock and a notify races its acquirers, so the
        # enumerator must treat cond ops and lock ops as conflicting
        self.label = lock.label
        self._waiters: list[VThread] = []
        self._fallback = _real_condition()

    def acquire(self, *a: Any, **kw: Any) -> bool:
        return self._lock.acquire(*a, **kw)

    def release(self) -> None:
        self._lock.release()

    def __enter__(self) -> "CoopCondition":
        self._lock.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self._lock.release()

    def wait(self, timeout: float | None = None) -> bool:
        vt = current_vthread()
        if vt is None:
            # invariant-phase fallback: nothing can notify (every virtual
            # thread has finished), so a bounded real sleep stands in
            _guard_foreign_thread(self.label)
            _real_sleep(min(timeout, 0.005) if timeout is not None else 0.005)
            return False
        ctl = vt.ctl
        depth = self._lock._release_all(vt)
        # racer: single-writer -- explorer token-passing: at most one
        # thread runs between sync points
        self._waiters.append(vt)
        deadline = ctl.clock + timeout if timeout is not None else None
        reason = ctl.yield_blocked(vt, None, deadline,
                                   ("wait", self.label))
        if vt in self._waiters:  # timed out before any notify reached us
            self._waiters.remove(vt)
        self._lock._reacquire(vt, depth)
        return reason == "notify"

    def wait_for(self, predicate: Callable[[], bool],
                 timeout: float | None = None) -> bool:
        result = predicate()
        ctl = _ACTIVE
        endtime = None
        while not result:
            waittime = timeout
            if timeout is not None and ctl is not None:
                if endtime is None:
                    endtime = ctl.clock + timeout
                waittime = endtime - ctl.clock
                if waittime <= 0:
                    break
            self.wait(waittime)
            result = predicate()
            if timeout is not None and ctl is None:
                break
        return result

    def notify(self, n: int = 1) -> None:
        vt = current_vthread()
        if vt is None:
            # outside a run no virtual waiters can exist; DURING a run a
            # non-virtual caller would silently drop a wake-up — loud error
            _guard_foreign_thread(self.label)
            return
        vt.ctl.yield_op(vt, ("notify", self.label))
        for _ in range(min(n, len(self._waiters))):
            waiter = self._waiters.pop(0)
            vt.ctl.wake(waiter, "notify")

    def notify_all(self) -> None:
        self.notify(len(self._waiters) or 1)


# ---- the controller ---------------------------------------------------------


class Step:
    """One schedule decision: which runnable thread proceeds with its
    announced operation. ``runnable`` snapshots every candidate and its
    pending op — the enumerator branches on these."""

    __slots__ = ("index", "chosen", "op", "runnable", "last", "preempt")

    def __init__(self, index: int, chosen: int, op: tuple,
                 runnable: tuple, last: int | None, preempt: bool) -> None:
        self.index = index
        self.chosen = chosen
        self.op = op
        self.runnable = runnable  # tuple of (tid, op) sorted by tid
        self.last = last
        self.preempt = preempt

    def to_json(self) -> dict:
        return {"i": self.index, "chosen": self.chosen,
                "op": list(self.op),
                "runnable": [[t, list(o)] for t, o in self.runnable],
                "preempt": self.preempt}

    def __repr__(self) -> str:
        return (f"Step({self.index}: t{self.chosen} {self.op[0]} "
                f"{self.op[1] if len(self.op) > 1 else ''})")


class RunRecord:
    """The outcome of one schedule: the decision trace plus whatever
    failed (body exception, deadlock, invariant violation)."""

    def __init__(self) -> None:
        self.steps: list[Step] = []
        self.body_excs: list[tuple[int, BaseException]] = []
        self.deadlock: str | None = None
        self.invariant_exc: BaseException | None = None
        self.pruned = False

    @property
    def decisions(self) -> tuple:
        return tuple(s.chosen for s in self.steps)

    @property
    def failed(self) -> bool:
        return bool(self.body_excs) or self.deadlock is not None or \
            self.invariant_exc is not None

    def failure_summary(self) -> str:
        if self.body_excs:
            tid, exc = self.body_excs[0]
            return f"thread {tid}: {type(exc).__name__}: {exc}"
        if self.deadlock is not None:
            return f"deadlock: {self.deadlock}"
        if self.invariant_exc is not None:
            exc = self.invariant_exc
            return f"invariant: {type(exc).__name__}: {exc}"
        return "ok"


class Controller:
    """The cooperative scheduler for one run: owns the token, the
    virtual clock, and the decision record. Runs on the caller's thread;
    virtual threads hand control back here at every sync point."""

    MAX_STEPS = 50_000

    def __init__(self, policy: Callable[[int, list, int | None], int],
                 watchdog_s: float = 20.0) -> None:
        self.policy = policy
        self.watchdog_s = watchdog_s
        self.clock = _real_monotonic()
        self._wall_offset = _real_time() - self.clock
        self.threads: list[VThread] = []
        self.record = RunRecord()
        self._token = threading.Event()  # vthread -> controller handoff
        self._aborting = False
        self.bodies_live = False
        self._objects = 0
        self._last: int | None = None
        self._current: VThread | None = None

    # -- services used by the primitives --------------------------------------

    def next_object_index(self) -> int:
        self._objects += 1
        return self._objects

    def probe(self, label: str) -> None:
        vt = current_vthread()
        if vt is not None:
            self.yield_op(vt, ("probe", label))

    def yield_op(self, vt: VThread, op: tuple) -> None:
        """Announce ``op`` and hand the token back; returns when the
        scheduler picks this thread again (possibly immediately)."""
        if self._aborting:
            # teardown: an unwinding `with lock:` body releases its lock
            # on the way out — it must not park waiting for a scheduler
            # that already stopped
            raise _Abort()
        vt.next_op = op
        vt.state = RUNNABLE
        self._token.set()
        vt._wait_turn()

    def yield_blocked(self, vt: VThread, lock: "CoopLock | None",
                      deadline: float | None, op: tuple) -> str:
        """Park until woken by ``wake`` (lock release / notify) or by the
        virtual clock reaching ``deadline``. Returns the wake reason."""
        if self._aborting:
            raise _Abort()
        vt.next_op = op
        vt.state = BLOCKED
        vt.deadline = deadline
        vt.blocked_on = lock
        vt.wake_reason = None
        self._token.set()
        vt._wait_turn()
        return vt.wake_reason or "wake"

    def wake(self, vt: VThread, reason: str) -> None:
        if vt.state == BLOCKED:
            vt.state = RUNNABLE
            vt.deadline = None
            vt.blocked_on = None
            vt.wake_reason = reason

    def wake_lock_waiters(self, lock: "CoopLock") -> None:
        for vt in self.threads:
            if vt.state == BLOCKED and getattr(vt, "blocked_on", None) is lock:
                self.wake(vt, "lock")

    def sleep(self, seconds: float) -> None:
        vt = current_vthread()
        if vt is None:
            _real_sleep(seconds)
            return
        self.yield_blocked(vt, None, self.clock + max(0.0, seconds),
                           ("sleep", f"{seconds:g}s"))

    def monotonic(self) -> float:
        return self.clock if current_vthread() is not None \
            else _real_monotonic()

    def wall_time(self) -> float:
        return self.clock + self._wall_offset \
            if current_vthread() is not None else _real_time()

    # -- the run --------------------------------------------------------------

    def run(self, bodies: Sequence[Callable[[], object]]) -> RunRecord:
        # controller state below is written by the exploring thread and,
        # between sync points, by exactly one token-holding VThread
        self.bodies_live = True  # racer: single-writer
        self.threads = [VThread(i, fn, self)  # racer: single-writer
                        for i, fn in enumerate(bodies)]
        try:
            self._loop()
        except PruneRun:
            self.record.pruned = True  # racer: single-writer
        finally:
            self._teardown()
            self.bodies_live = False
        for vt in self.threads:
            if vt.exc is not None:
                self.record.body_excs.append((vt.tid, vt.exc))
        return self.record

    def _loop(self) -> None:
        step = 0
        while True:
            runnable = [t for t in self.threads if t.state == RUNNABLE]
            if not runnable:
                if all(t.state == DONE for t in self.threads):
                    return
                if not self._advance_clock():
                    self.record.deadlock = self._blocked_digest()
                    return
                continue
            if step >= self.MAX_STEPS:
                raise ExploreError(
                    f"schedule exceeded {self.MAX_STEPS} steps "
                    f"(livelock in scenario?)")
            cands = sorted((t.tid, t.next_op) for t in runnable)
            chosen_tid = self.policy(step, cands, self._last)
            chosen = next(t for t in runnable if t.tid == chosen_tid)
            preempt = self._last is not None and self._last != chosen_tid \
                and any(t.tid == self._last for t in runnable)
            self.record.steps.append(Step(
                step, chosen_tid, chosen.next_op, tuple(cands),
                self._last, preempt))
            self._switch_to(chosen)
            # exploring-thread-owned cursor
            # racer: single-writer -- exploring-thread-owned cursor
            self._last = chosen_tid if chosen.state != DONE else None
            step += 1

    def _switch_to(self, vt: VThread) -> None:
        self._current = vt  # racer: single-writer -- token protocol
        self._token.clear()  # racer: single-writer -- token protocol
        vt._resume()
        if not self._token.wait(self.watchdog_s):
            self._aborting = True  # racer: single-writer -- abort latch
            raise ExploreError(
                f"schedule wedged: thread {vt.tid} did not reach a sync "
                f"point within {self.watchdog_s}s — a non-cooperative "
                f"blocking call (real lock / IO) inside the scenario?")

    def _advance_clock(self) -> bool:
        deadlines = [t.deadline for t in self.threads
                     if t.state == BLOCKED and t.deadline is not None]
        if not deadlines:
            return False
        # advanced only when every thread blocks
        # racer: single-writer -- advanced only when every thread blocks
        self.clock = max(self.clock, min(deadlines))
        for t in self.threads:
            if t.state == BLOCKED and t.deadline is not None \
                    and t.deadline <= self.clock:
                self.wake(t, "timeout")
        return True

    def _blocked_digest(self) -> str:
        parts = []
        for t in self.threads:
            if t.state == BLOCKED:
                parts.append(f"t{t.tid} blocked at {t.next_op}")
        return "; ".join(parts) or "no runnable threads"

    def _teardown(self) -> None:
        self._aborting = True
        for vt in self.threads:
            if vt.state != DONE:
                vt._resume()
        for vt in self.threads:
            vt.join(5.0)


# ---- installation (factory + clock patching) --------------------------------


def _coop_lock_factory() -> object:
    if _ACTIVE is not None and _in_package(_caller_module(1)):
        return CoopLock(reentrant=False, site=_site_label(2))
    return _real_lock_factory()


def _coop_rlock_factory() -> object:
    if _ACTIVE is not None and _in_package(_caller_module(1)):
        return CoopLock(reentrant=True, site=_site_label(2))
    return _real_rlock_factory()


def _coop_condition_factory(lock: object = None) -> object:
    if _ACTIVE is not None and (isinstance(lock, CoopLock) or (
            lock is None
            and _in_package(_caller_module(1)))):
        return CoopCondition(lock if isinstance(lock, CoopLock) else None,
                             site=_site_label(2))
    return _real_condition(lock)


def _virt_monotonic() -> float:
    ctl = _ACTIVE
    return ctl.monotonic() if ctl is not None else _real_monotonic()


def _virt_perf_counter() -> float:
    ctl = _ACTIVE
    return ctl.monotonic() if ctl is not None else _real_perf_counter()


def _virt_time() -> float:
    ctl = _ACTIVE
    return ctl.wall_time() if ctl is not None else _real_time()


def _virt_sleep(seconds: float) -> None:
    ctl = _ACTIVE
    if ctl is not None:
        ctl.sleep(seconds)
    else:
        _real_sleep(seconds)


class _Patch:
    """Swap the threading factories and clock functions in, remembering
    whatever was there (a lock-order harness may already have patched
    the factories: its instrumentation is restored afterwards)."""

    def __init__(self) -> None:
        self.saved: dict = {}

    def install(self) -> None:
        self.saved = {
            "Lock": threading.Lock, "RLock": threading.RLock,
            "Condition": threading.Condition,
            "monotonic": time.monotonic,
            "perf_counter": time.perf_counter,
            # analysis: disable=monotonic-time -- saving whatever wall clock is installed, to restore it
            "time": time.time, "sleep": time.sleep,
        }
        threading.Lock = _coop_lock_factory  # type: ignore[assignment]
        threading.RLock = _coop_rlock_factory  # type: ignore[assignment]
        threading.Condition = _coop_condition_factory  # type: ignore[misc,assignment]
        time.monotonic = _virt_monotonic
        time.perf_counter = _virt_perf_counter
        time.time = _virt_time  # analysis: disable=monotonic-time -- installing the virtual wall clock
        time.sleep = _virt_sleep

    def uninstall(self) -> None:
        threading.Lock = self.saved["Lock"]
        threading.RLock = self.saved["RLock"]
        threading.Condition = self.saved["Condition"]
        time.monotonic = self.saved["monotonic"]
        time.perf_counter = self.saved["perf_counter"]
        time.time = self.saved["time"]  # analysis: disable=monotonic-time -- restoring the saved wall clock
        time.sleep = self.saved["sleep"]


def run_one_schedule(
        scenario: Callable[[], tuple],
        policy: Callable[[int, list, int | None], int],
        watchdog_s: float = 20.0) -> RunRecord:
    """Build ``scenario`` and execute its bodies under ``policy``,
    returning the full decision record. The cooperative patches cover
    the scenario build, the run, and the invariant check, and are always
    restored (the previous patch state, a lock-order harness's say, comes back
    exactly as it was)."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise ExploreError("nested exploration runs are not supported")
    patch = _Patch()
    ctl = Controller(policy, watchdog_s=watchdog_s)
    patch.install()
    _ACTIVE = ctl
    try:
        bodies, invariant = scenario()
        record = ctl.run(list(bodies))
        if not record.failed and not record.pruned and invariant is not None:
            try:
                invariant()
            except Exception as e:
                record.invariant_exc = e
        return record
    finally:
        _ACTIVE = None
        patch.uninstall()


# re-exported conveniences for scenario authors (tests)
def Lock() -> CoopLock:
    """An explicitly-cooperative lock for scenario code itself."""
    return CoopLock(reentrant=False, site=_site_label(2))


def RLock() -> CoopLock:
    return CoopLock(reentrant=True, site=_site_label(2))


def Condition(lock: CoopLock | None = None) -> CoopCondition:
    return CoopCondition(lock, site=_site_label(2))


__all__ = [
    "CoopCondition", "CoopLock", "Condition", "Controller", "ExploreError",
    "Lock", "PruneRun", "ReplayDivergence", "RLock", "RunRecord", "Step",
    "current_vthread", "probe", "run_one_schedule",
]
