"""Continuous sampling profiler: CPU and lock-wait attribution of the
scheduler's hot path (the port's copy of ``kubegpu_tpu/obs/profile.py``).

- A **sampler thread** (default ~125 Hz) walks ``sys._current_frames()``
  and folds every thread's stack into a weighted trie, the collapsed-stack
  shape of a flamegraph, built from inside the process.
- Each sampled thread is classified by its **registered role** (fit-pool
  worker, binder, informer, elector, ...): threads call
  :func:`register_thread` at entry, which works whether or not a sampler
  runs, and a thread-name table catches the rest.
- Samples are attributed to the **active scheduling phase** through the
  span context ``obs.trace`` publishes per thread while a sampler runs.
- **Lock waits** are split out by a per-thread "waiting" stamp at the
  acquire seam of the package's locks (:func:`install_lock_probe` patches
  the ``threading`` lock factories for callers in this package).

Exports: collapsed-stack text (``Sampler.collapsed()``) and a JSON
attribution table (``Sampler.attribution()``), which ``/debug/profile``
serves.

``KGTPU_PROFILE=0`` disables the profiler everywhere. The state of a
sample is a heuristic: a thread whose innermost frame waits in
``threading.py`` (or a selector or socket read) is **idle**, one stamped
by the lock probe is **lock_wait**, and everything else is **cpu**.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Iterable, Optional

import _thread

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.obs import trace

ENV_ENABLE = "KGTPU_PROFILE"
ENV_HZ = "KGTPU_PROFILE_HZ"
ENV_DIR = "KGTPU_PROFILE_DIR"
DEFAULT_HZ = 125.0
MAX_STACK_DEPTH = 48

#: The scheduling-pipeline phases the attribution table keys (the span
#: names scheduler/core.py and queue.py emit).
SCHED_PHASES = ("filter", "score", "allocate", "bind_commit")


def enabled() -> bool:
    """Master switch: ``KGTPU_PROFILE=0`` disables profiling everywhere
    (flags and API calls become no-ops)."""
    return os.environ.get(ENV_ENABLE, "1") != "0"


# ---- thread roles ----------------------------------------------------------

_role_lock = threading.Lock()
_ROLES: dict = {}  # thread ident -> registered role

# Thread-name fallbacks (substring match, first hit wins) for threads
# that never call register_thread — the package names every thread it
# starts, so this table is the classification backstop.
_NAME_ROLES: tuple = (
    ("fit", "fit-pool"),
    ("bind-", "binder"),
    ("watch-fanout", "stream-pump"),
    ("watch-push", "stream-pump"),
    ("apf", "apf-drain"),
    ("elector-", "elector"),
    ("shard-coord-", "elector"),
    ("api-watch", "informer"),
    ("apiserver-http", "apiserver"),
    ("process_request_thread", "apiserver"),  # ThreadingHTTPServer handlers
    ("mock-kube", "apiserver"),
    ("sched", "sched-loop"),
    ("node-lifecycle", "lifecycle"),
    ("advertiser-", "advertiser"),
    ("tenant-flood", "chaos"),
    ("health", "health"),
    ("metrics-ts", "timeseries"),
    ("profile-sampler", "sampler"),
    ("cri-", "runtime"),
    ("wal", "wal"),
    ("MainThread", "main"),
)


def register_thread(role: str, ident: Optional[int] = None) -> None:
    """Bind the calling thread (or ``ident``) to an attribution role.
    Threads the package starts call this at entry; registration wins
    over the name-pattern fallback."""
    with _role_lock:
        _ROLES[threading.get_ident() if ident is None else ident] = role


def _classify(ident: int, name: str) -> str:
    with _role_lock:
        role = _ROLES.get(ident)
    if role is not None:
        return role
    for pattern, role in _NAME_ROLES:
        if pattern in name:
            return role
    return "other"


def _prune_roles(live: Iterable[int]) -> None:
    """Drop registrations for dead thread idents (idents recycle)."""
    live_set = set(live)
    with _role_lock:
        for ident in [i for i in _ROLES if i not in live_set]:
            del _ROLES[ident]


# ---- lock-wait probe -------------------------------------------------------

# thread ident -> construction site of the package lock it is currently
# blocked on. Written only by the waiting thread itself (stamp before
# the blocking acquire, clear after), read by the sampler; individual
# dict get/set/pop are GIL-atomic.
_WAITING: dict = {}

_RAW_LOCK = _thread.allocate_lock
_RAW_RLOCK: Any = getattr(_thread, "RLock", None) or threading._PyRLock  # type: ignore[attr-defined]
_REAL_CONDITION = threading.Condition

_probe_lock = threading.Lock()
_probe_prev: Optional[tuple] = None  # saved (Lock, RLock, Condition)
_PKG_PREFIX = "kubegpu_tpu_torch"


def _caller_module(depth: int) -> str:
    return sys._getframe(depth + 1).f_globals.get("__name__", "")


def _site_label(depth: int) -> str:
    frame = sys._getframe(depth)
    path = frame.f_code.co_filename
    parts = path.replace(os.sep, "/").split("/")
    if _PKG_PREFIX in parts:
        path = "/".join(parts[parts.index(_PKG_PREFIX):])
    else:
        path = "/".join(parts[-2:])
    return f"{path}:{frame.f_lineno}"


class _WaitLock:
    """Wraps a real lock primitive: a blocked ``acquire`` stamps the
    calling thread's ident into ``_WAITING`` (keyed to this lock's
    construction site) for the duration of the wait. The uncontended
    path is one extra non-blocking acquire attempt."""

    __slots__ = ("_inner", "_site")

    def __init__(self, inner: Any, site: str) -> None:
        self._inner = inner
        self._site = site

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._inner.acquire(False):
            return True
        if not blocking:
            return False
        ident = _thread.get_ident()
        _WAITING[ident] = self._site
        try:
            return self._inner.acquire(True, timeout)
        finally:
            _WAITING.pop(ident, None)

    def release(self) -> None:
        self._inner.release()

    def __enter__(self) -> "_WaitLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def locked(self) -> bool:
        return bool(self._inner.locked())

    def _at_fork_reinit(self) -> None:
        self._inner._at_fork_reinit()

    # -- RLock protocol used by threading.Condition --------------------------

    def _is_owned(self) -> bool:
        inner_owned = getattr(self._inner, "_is_owned", None)
        if inner_owned is not None:
            return bool(inner_owned())
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self) -> object:
        inner_save = getattr(self._inner, "_release_save", None)
        if inner_save is None:
            self.release()
            return None
        return inner_save()

    def _acquire_restore(self, state: object) -> None:
        inner_restore = getattr(self._inner, "_acquire_restore", None)
        ident = _thread.get_ident()
        # the post-wait reacquire contends like any other acquire
        _WAITING[ident] = self._site
        try:
            if inner_restore is None:
                self._inner.acquire()
            else:
                inner_restore(state)
        finally:
            _WAITING.pop(ident, None)

    def __repr__(self) -> str:
        return f"<_WaitLock {self._site} wrapping {self._inner!r}>"


def _probe_lock_factory() -> Any:
    if _caller_module(1).startswith(_PKG_PREFIX):
        return _WaitLock(_RAW_LOCK(), _site_label(2))
    return _RAW_LOCK()


def _probe_rlock_factory() -> Any:
    if _caller_module(1).startswith(_PKG_PREFIX):
        return _WaitLock(_RAW_RLOCK(), _site_label(2))
    return _RAW_RLOCK()


class _ProbeCondition(_REAL_CONDITION):
    """``threading.Condition`` that, when created lock-less from package
    code, wires a wait-stamping RLock in as its lock — so the monitor
    acquires of queue/binder condition variables show up as lock waits."""

    def __init__(self, lock: Any = None) -> None:
        if lock is None and _caller_module(1).startswith(_PKG_PREFIX):
            lock = _WaitLock(_RAW_RLOCK(), _site_label(2))
        super().__init__(lock)


def install_lock_probe() -> bool:
    """Patch the ``threading`` lock factories so package-created locks
    stamp their blocked acquirers. Returns False (and installs nothing)
    when another instrumentation layer already owns the factories (the
    lockgraph pytest plugin / the interleaving explorer) — stacking
    would collapse their construction-site keying. Idempotent."""
    global _probe_prev
    with _probe_lock:
        if _probe_prev is not None:
            return True
        if threading.Lock is not _RAW_LOCK:
            return False
        _probe_prev = (threading.Lock, threading.RLock, threading.Condition)
        threading.Lock = _probe_lock_factory  # type: ignore[assignment]
        threading.RLock = _probe_rlock_factory  # type: ignore[assignment]
        threading.Condition = _ProbeCondition  # type: ignore[assignment,misc]
        return True


def uninstall_lock_probe() -> None:
    global _probe_prev
    with _probe_lock:
        if _probe_prev is None:
            return
        threading.Lock, threading.RLock, threading.Condition = \
            _probe_prev  # type: ignore[assignment,misc]
        _probe_prev = None


def lock_probe_installed() -> bool:
    return _probe_prev is not None


# ---- stack folding ---------------------------------------------------------

# Innermost Python frames that mean "this thread is parked, not
# burning CPU": condition/event waits, selector polls, blocking socket
# reads, executor workers blocked on their work queue (SimpleQueue.get
# blocks in C, so the worker-loop frame stays innermost). (time.sleep
# is invisible — its caller's frame is innermost — so sleeping threads
# count as cpu; they are rare and short here.)
_IDLE_FRAMES = (
    ("threading.py", "wait"),
    ("threading.py", "_wait_for_tstate_lock"),
    ("selectors.py", "select"),
    ("socket.py", "readinto"),
    ("socket.py", "accept"),
    ("futures/thread.py", "_worker"),
)

# Stack-marker phase inference for threads doing pipeline work WITHOUT
# an active span of their own — above all the fit-pool workers, which
# execute the filter pass's per-node predicate calls dispatched by the
# scheduling thread (whose "filter" span is thread-local and invisible
# to them). Innermost marker wins; the published span phase (when
# present) always wins over inference.
_STACK_PHASES = {
    "find_nodes_that_fit": "filter",
    "_fits_on_node": "filter",
    "_run_predicates": "filter",
    "prioritize_nodes": "score",
    "allocate_devices": "allocate",
    "_process_bind_items": "bind_commit",
    "_drain_bind_spool": "bind_commit",
    "bind_many": "bind_commit",
    "bind_pod": "bind_commit",
}


def _frame_key(frame: Any) -> str:
    code = frame.f_code
    path = code.co_filename
    parts = path.replace(os.sep, "/").split("/")
    if _PKG_PREFIX in parts:
        path = "/".join(parts[parts.index(_PKG_PREFIX):])
    else:
        path = parts[-1]
    return f"{path}:{code.co_name}"


def _is_idle(frame: Any) -> bool:
    name = frame.f_code.co_name
    fname = frame.f_code.co_filename
    for suffix, fn in _IDLE_FRAMES:
        if name == fn and fname.endswith(suffix):
            return True
    return False


class Sampler:
    """The sampling profiler: one daemon thread, a weighted stack trie,
    and per-role / per-phase / per-state tallies. All mutable tallies
    live under ``_lock`` (the sampler writes, attribution readers
    read)."""

    def __init__(self, hz: Optional[float] = None,
                 max_depth: int = MAX_STACK_DEPTH) -> None:
        env_hz = os.environ.get(ENV_HZ)
        self.hz = float(hz if hz is not None
                        else (env_hz if env_hz else DEFAULT_HZ))
        self.hz = max(1.0, min(self.hz, 1000.0))
        self.max_depth = max_depth
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # racer: single-writer -- start()/stop() are owner-thread calls
        self._thread: Optional[threading.Thread] = None
        self._started_mono = 0.0
        self._stopped_mono: Optional[float] = None
        # everything below is guarded by _lock
        self._root: dict = {}       # frame key -> [self_count, children]
        self._ticks = 0
        self._thread_samples = 0
        self._by_role: dict = {}
        self._by_state: dict = {}   # cpu / idle / lock_wait
        self._cpu_by_phase: dict = {}
        self._phase_samples = 0     # samples carrying any phase
        self._attributed = 0        # role known or phase known
        self._lock_wait_by_site: dict = {}
        self._lock_wait_by_role: dict = {}
        self._work_s = 0.0          # sampler's own busy time

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Sampler":
        if self._thread is not None:
            return self
        trace.enable_phase_tracking()
        # racer: single-writer -- start()/stop() are owner-thread calls
        self._started_mono = time.monotonic()
        # racer: single-writer -- stop() joins the loop before clearing
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="profile-sampler")
        self._thread.start()
        return self

    def stop(self) -> dict:
        """Stop sampling (joins the thread) and return the final
        attribution table. Idempotent."""
        t = self._thread
        if t is not None:
            self._stop.set()
            t.join(timeout=5.0)
            self._thread = None
            trace.disable_phase_tracking()
        if self._stopped_mono is None:
            # racer: single-writer -- start()/stop() are owner-thread calls
            self._stopped_mono = time.monotonic()
        return self.attribution()

    def running(self) -> bool:
        return self._thread is not None

    def _run(self) -> None:
        register_thread("sampler")
        interval = 1.0 / self.hz
        next_t = time.monotonic()
        while not self._stop.is_set():
            t0 = time.perf_counter()
            try:
                self._sample_once()
            except Exception:  # analysis: disable=no-swallowed-exceptions -- a failed tick self-heals at the next one; logging at 125 Hz would be the outage
                pass
            busy = time.perf_counter() - t0
            with self._lock:
                self._work_s += busy
            next_t += interval
            delay = next_t - time.monotonic()
            if delay <= 0:
                # fell behind (a tick cost >= the interval): skip the
                # missed ticks AND still yield a full interval — never
                # sample back-to-back, or a slow walk (many threads,
                # deep stacks) turns the sampler into a GIL-pegging
                # busy loop that inflates the latencies it measures
                next_t = time.monotonic() + interval
                delay = interval
            self._stop.wait(delay)

    # -- sampling ------------------------------------------------------------

    def _sample_once(self) -> None:
        own = threading.get_ident()
        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()
                 if t.ident is not None}
        metrics.PROFILE_SAMPLES.inc()
        with self._lock:
            self._ticks += 1
            if self._ticks % 512 == 1:
                _prune_roles(frames.keys())
            for ident, frame in frames.items():
                if ident == own:
                    continue
                role = _classify(ident, names.get(ident, ""))
                wait_site = _WAITING.get(ident)
                # one stack walk serves folding, idle detection, and
                # phase inference (innermost-first)
                stack = []      # frame keys, innermost first
                inferred = None
                f = frame
                while f is not None and len(stack) < self.max_depth:
                    stack.append(_frame_key(f))
                    if inferred is None:
                        inferred = _STACK_PHASES.get(f.f_code.co_name)
                    f = f.f_back
                phase = trace.thread_phase(ident)
                if phase is None:
                    phase = inferred
                if wait_site is not None:
                    state = "lock_wait"
                elif _is_idle(frame):
                    state = "idle"
                else:
                    state = "cpu"
                self._thread_samples += 1
                self._by_role[role] = self._by_role.get(role, 0) + 1
                self._by_state[state] = self._by_state.get(state, 0) + 1
                if phase is not None:
                    self._phase_samples += 1
                    if state == "cpu":
                        self._cpu_by_phase[phase] = \
                            self._cpu_by_phase.get(phase, 0) + 1
                if role != "other" or phase is not None:
                    self._attributed += 1
                if state == "lock_wait":
                    self._lock_wait_by_site[wait_site] = \
                        self._lock_wait_by_site.get(wait_site, 0) + 1
                    self._lock_wait_by_role[role] = \
                        self._lock_wait_by_role.get(role, 0) + 1
                self._fold_locked(role, stack, wait_site)

    def _fold_locked(self, role: str, stack: list,
                     wait_site: Optional[str]) -> None:
        path = [role] + stack[::-1]   # role root, outermost-first
        if wait_site is not None:
            path.append(f"[lock-wait {wait_site}]")
        node = self._root
        entry = None
        for key in path:
            entry = node.get(key)
            if entry is None:
                entry = [0, {}]
                node[key] = entry
            node = entry[1]
        if entry is not None:
            entry[0] += 1

    # -- export --------------------------------------------------------------

    def _wall_s(self) -> float:
        end = self._stopped_mono if self._stopped_mono is not None \
            else time.monotonic()
        return max(1e-9, end - self._started_mono) \
            if self._started_mono else 0.0

    def attribution(self) -> dict:
        """The JSON attribution table: per-role / per-phase / per-state
        shares, the headline ``sched_cpu_share{phase=...}`` map, the
        ``lock_wait_share``, the top lock-wait sites, and the sampler's
        own overhead."""
        wall = self._wall_s()
        with self._lock:
            total = self._thread_samples
            cpu = self._by_state.get("cpu", 0)
            lock_wait = self._by_state.get("lock_wait", 0)
            denom = max(1, total)
            busy_denom = max(1, cpu + lock_wait)
            sched_cpu_share = {
                ph: round(self._cpu_by_phase.get(ph, 0) / max(1, cpu), 4)
                for ph in SCHED_PHASES}
            other_phase = sum(v for ph, v in self._cpu_by_phase.items()
                              if ph not in SCHED_PHASES)
            sched_cpu_share["other"] = round(other_phase / max(1, cpu), 4)
            top_sites = sorted(self._lock_wait_by_site.items(),
                               key=lambda kv: -kv[1])[:10]
            return {
                "proc": trace.RECORDER.proc,
                "hz": self.hz,
                "wall_s": round(wall, 3),
                "ticks": self._ticks,
                "thread_samples": total,
                "sampler_overhead_pct": round(
                    100.0 * self._work_s / wall, 3) if wall else 0.0,
                "states": {s: {"samples": n,
                               "share": round(n / denom, 4)}
                           for s, n in sorted(self._by_state.items())},
                "roles": {r: {"samples": n,
                              "share": round(n / denom, 4)}
                          for r, n in sorted(self._by_role.items())},
                "cpu_by_phase": {ph: {"samples": n,
                                      "share": round(n / max(1, cpu), 4)}
                                 for ph, n in
                                 sorted(self._cpu_by_phase.items())},
                "sched_cpu_share": sched_cpu_share,
                "lock_wait_share": round(lock_wait / busy_denom, 4),
                "lock_wait_sites": {site: n for site, n in top_sites},
                "lock_wait_by_role": dict(sorted(
                    self._lock_wait_by_role.items())),
                "unattributed_share": round(
                    (total - self._attributed) / denom, 4),
                "lock_probe": lock_probe_installed(),
            }

    def collapsed(self) -> str:
        """Collapsed-stack text (``a;b;c N`` per line) — the input
        format of every flamegraph renderer."""
        lines: list = []

        def walk(node: dict, prefix: list) -> None:
            for key in sorted(node):
                count, children = node[key]
                path = prefix + [key]
                if count:
                    lines.append(f"{';'.join(path)} {count}")
                walk(children, path)

        with self._lock:
            walk(self._root, [])
        return "\n".join(lines) + ("\n" if lines else "")

    def dump(self, directory: str, basename: Optional[str] = None) -> tuple:
        """Write ``<base>.collapsed`` + ``<base>.json`` under
        ``directory``; returns the two paths."""
        base = basename or f"profile-{os.getpid()}"
        os.makedirs(directory, exist_ok=True)
        collapsed_path = os.path.join(directory, base + ".collapsed")
        json_path = os.path.join(directory, base + ".json")
        with open(collapsed_path, "w") as f:
            f.write(self.collapsed())
        with open(json_path, "w") as f:
            json.dump(self.attribution(), f, indent=2)
        return collapsed_path, json_path


# ---- process-global profiler ----------------------------------------------

_active_lock = threading.Lock()
_ACTIVE: Optional[Sampler] = None


def start_profiler(hz: Optional[float] = None) -> Optional[Sampler]:
    """Start (or return) the process-global sampler. Returns None when
    ``KGTPU_PROFILE=0`` disables profiling."""
    global _ACTIVE
    if not enabled():
        return None
    with _active_lock:
        if _ACTIVE is None:
            _ACTIVE = Sampler(hz=hz).start()
        return _ACTIVE


def stop_profiler() -> Optional[dict]:
    """Stop the process-global sampler; returns its final attribution
    table (None when no sampler was running)."""
    global _ACTIVE
    with _active_lock:
        sampler, _ACTIVE = _ACTIVE, None
    if sampler is None:
        return None
    return sampler.stop()


def active_profiler() -> Optional[Sampler]:
    return _ACTIVE


def current_attribution() -> Optional[dict]:
    """The live attribution table of the active sampler, or None — what
    the anomaly watchdog attaches to flight dumps."""
    sampler = _ACTIVE
    if sampler is None:
        return None
    return sampler.attribution()


def profile_status(include_collapsed: bool = True) -> dict:
    """The ``/debug/profile`` payload (``serve_health`` serves it)."""
    sampler = _ACTIVE
    if sampler is None:
        return {"active": False, "enabled": enabled(),
                "note": "no sampler running (start with --profile-dir, "
                        "or obs.profile.start_profiler())"}
    out = {"active": True, "enabled": enabled(),
           "attribution": sampler.attribution()}
    if include_collapsed:
        out["collapsed"] = sampler.collapsed()
    return out


def stop_and_dump(directory: Optional[str]) -> Optional[dict]:
    """Stop the global sampler and, when ``directory`` is set, dump the
    collapsed stacks + attribution JSON there. Returns the attribution
    (None when nothing was running)."""
    global _ACTIVE
    with _active_lock:
        sampler, _ACTIVE = _ACTIVE, None
    if sampler is None:
        return None
    att = sampler.stop()
    if directory:
        sampler.dump(directory)
    return att
