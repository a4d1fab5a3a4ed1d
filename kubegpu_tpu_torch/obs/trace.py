"""Distributed scheduling traces: spans, propagation, and export.

One pod's life crosses the queue, the scheduling cycle, the binder pool,
the apiserver's conflict arbiter, the WAL, and the watch stream back into
every replica's informer — under HA, across *processes*. This module is
the spine that stitches that life back together:

- A **trace id is deterministic per pod** (``trace_id_for_pod``): every
  replica and the apiserver mint the same id from the pod name alone, so
  a per-pod timeline assembles across processes with no id handshake.
- **Spans** land in a bounded per-process ring (``SpanRecorder``); the
  process-global ``RECORDER`` is what the debug endpoints, the flight
  recorder, and ``--trace-out`` read.
- **Propagation** is thread-local context (``span(...)`` nests children
  on the same thread) plus a wire header (``TRACE_HEADER``) the HTTP
  clients attach and the HTTP server re-installs, so the apiserver's
  arbiter-commit and WAL-append spans parent under the scheduler's bind
  span even across a real process boundary. Batched verbs carry one
  parent per pod (``batch_context``).
- **Export** is Chrome trace-event JSON (``chrome_trace`` — loadable in
  Perfetto; one process row per component, one thread row per pod) and
  a per-pod explanation (``explain_pod`` — the "why is this pod
  Pending/slow" answer behind ``/debug/pod/<name>``).

Span timestamps are wall-clock so rows from different processes on one
machine align in a merged view; durations are measured with
``perf_counter`` so a clock step cannot stretch a span.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Iterator, Optional

log = logging.getLogger(__name__)

# Wire header carrying span context across an HTTP hop:
# {"parent": "<trace>/<span>", "pods": {"<pod>": "<trace>/<span>", ...}}.
TRACE_HEADER = "X-KGTPU-Trace"

_SPAN_SEQ = itertools.count(1)
# Per-process nonce so span ids from different processes never collide
# in a merged trace file.
_PROC_NONCE = os.urandom(4).hex()


def _new_span_id() -> str:
    return f"{_PROC_NONCE}-{next(_SPAN_SEQ):x}"


def wall_now() -> float:
    """Wall-clock seconds — span timestamps only (cross-process display
    alignment); durations always come from ``perf_counter``."""
    return time.time()  # analysis: disable=monotonic-time -- trace timestamps cross process boundaries, display only


def trace_id_for_pod(pod_name: str) -> str:
    """Deterministic per-pod trace id: every process derives the same id
    from the pod name, so cross-process timelines need no id handshake
    and nothing is ever stamped into the pod object (which would defeat
    the equivalence memo's shape sharing)."""
    return hashlib.sha1(f"pod:{pod_name}".encode()).hexdigest()[:16]


class Span:
    """One timed operation. Mutate ``attrs`` freely before ``finish``."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "pod", "proc",
                 "start_s", "dur_s", "attrs", "_t0", "_recorder", "_done")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], pod: Optional[str], proc: str,
                 recorder: "SpanRecorder", attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.pod = pod
        self.proc = proc
        # wall clock deliberately: span start times must align across
        # processes in a merged trace view
        self.start_s = wall_now()
        self.dur_s = 0.0
        self.attrs = attrs
        self._t0 = time.perf_counter()
        self._recorder = recorder
        self._done = False

    def context(self) -> tuple:
        return (self.trace_id, self.span_id)

    def finish(self, **attrs: Any) -> "Span":
        """End the span (idempotent) and record it."""
        if self._done:
            return self
        # a span is finished by the thread that opened it; the recorder
        # ring beyond this point has its own lock
        self._done = True   # racer: single-writer
        self.dur_s = time.perf_counter() - self._t0  # racer: single-writer
        if attrs:
            self.attrs.update(attrs)  # racer: single-writer
        self._recorder.record(self)
        return self

    def to_dict(self) -> dict:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "pod": self.pod, "proc": self.proc,
                "start_s": self.start_s, "dur_ms": self.dur_s * 1e3,
                "attrs": dict(self.attrs)}


class SpanRecorder:
    """Bounded per-process span ring. Append is a lock + deque push —
    cheap enough to stay always-on in the scheduling hot path."""

    def __init__(self, capacity: int = 16384, proc: Optional[str] = None):
        self._lock = threading.Lock()
        self._spans: deque = deque(maxlen=capacity)
        self.capacity = capacity
        self.proc = proc or f"proc-{os.getpid()}"
        self.enabled = True

    def record(self, span: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            self._spans.append(span)

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def pod_spans(self, pod_name: str) -> list:
        tid = trace_id_for_pod(pod_name)
        return [s for s in self.spans()
                if s.pod == pod_name or s.trace_id == tid]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


#: The process-global ring: the debug endpoints, the flight recorder,
#: and ``--trace-out`` all read this.
RECORDER = SpanRecorder()


class _Ctx(threading.local):
    def __init__(self) -> None:
        self.stack: list = []          # active Span objects, innermost last
        self.batch: Optional[dict] = None  # pod -> (trace_id, span_id)


_CTX = _Ctx()

# ---- per-thread phase publication (for the sampling profiler) --------------
#
# A sampler thread cannot read another thread's thread-local span stack,
# so while any sampler is running, span() publishes the innermost active
# span name into this plain dict keyed by thread ident. Off by default:
# the tracing hot path pays ONE global load + is-None test per span
# transition (the explore.probe precedent); on, it pays one GIL-atomic
# dict store. Refcounted so overlapping samplers compose.

_PHASE_SINK: Optional[dict] = None
_phase_refs = 0
_phase_lock = threading.Lock()


def enable_phase_tracking() -> None:
    global _PHASE_SINK, _phase_refs
    with _phase_lock:
        _phase_refs += 1
        if _PHASE_SINK is None:
            _PHASE_SINK = {}


def disable_phase_tracking() -> None:
    global _PHASE_SINK, _phase_refs
    with _phase_lock:
        _phase_refs = max(0, _phase_refs - 1)
        if _phase_refs == 0:
            _PHASE_SINK = None


def thread_phase(ident: int) -> Optional[str]:
    """The innermost active span name on thread ``ident``, or None —
    how the sampling profiler attributes a stack sample to the
    scheduling phase that thread is executing."""
    sink = _PHASE_SINK
    if sink is None:
        return None
    return sink.get(ident)


def _publish_phase(name: Optional[str]) -> None:
    sink = _PHASE_SINK
    if sink is None:
        return
    ident = threading.get_ident()
    if name is None:
        sink.pop(ident, None)
    else:
        sink[ident] = name


def current() -> Optional[Span]:
    """The innermost active span on this thread, or None."""
    return _CTX.stack[-1] if _CTX.stack else None


def parent_for(pod_name: Optional[str]) -> Optional[tuple]:
    """(trace_id, span_id) a new span for ``pod_name`` should parent
    under on this thread: the batch mapping's entry for the pod (set by
    a batched verb or an incoming HTTP header) wins over the innermost
    active span."""
    batch = _CTX.batch
    if pod_name is not None and batch is not None:
        ctx = batch.get(pod_name)
        if ctx is not None:
            return ctx
    cur = current()
    return cur.context() if cur is not None else None


def _resolve(pod: Optional[str], parent: Any) -> tuple:
    """(trace_id, parent_id) for a new span."""
    if isinstance(parent, Span):
        parent = parent.context()
    if parent is None:
        parent = parent_for(pod)
    if parent is not None:
        trace_id, parent_id = parent
        if pod is not None:
            # a pod-scoped span always lives in the POD's trace; the
            # parent link may legitimately point into another trace
            # (e.g. a batch-wide parent)
            trace_id = trace_id_for_pod(pod)
        return trace_id, parent_id
    if pod is not None:
        return trace_id_for_pod(pod), None
    return _new_span_id(), None


def start_span(name: str, pod: Optional[str] = None, parent: Any = None,
               proc: Optional[str] = None,
               recorder: Optional[SpanRecorder] = None,
               **attrs: Any) -> Span:
    """Manual span (not pushed on the thread stack): the caller owns
    ``finish()``. Used where start and end live on different call paths
    (the pipelined binder)."""
    rec = recorder or RECORDER
    trace_id, parent_id = _resolve(pod, parent)
    return Span(name, trace_id, _new_span_id(), parent_id, pod,
                proc or rec.proc, rec, dict(attrs))


def record_span(name: str, start_s: float, dur_s: float,
                pod: Optional[str] = None, parent: Any = None,
                proc: Optional[str] = None,
                recorder: Optional[SpanRecorder] = None,
                **attrs: Any) -> Span:
    """Record an already-measured span (wall-clock start + duration):
    the shape used where the measurement happened before the span could
    be opened (queue wait reconstructed at pop, the arbiter's post-hoc
    per-pod commit spans)."""
    rec = recorder or RECORDER
    trace_id, parent_id = _resolve(pod, parent)
    sp = Span(name, trace_id, _new_span_id(), parent_id, pod,
              proc or rec.proc, rec, dict(attrs))
    sp.start_s = start_s
    sp.dur_s = max(0.0, dur_s)
    sp._done = True
    rec.record(sp)
    return sp


@contextmanager
def span(name: str, pod: Optional[str] = None, parent: Any = None,
         proc: Optional[str] = None, recorder: Optional[SpanRecorder] = None,
         slow_log_s: Optional[float] = None,
         **attrs: Any) -> Iterator[Span]:
    """Scoped span, pushed on the thread-local stack so children created
    inside (same thread) nest under it automatically. ``slow_log_s``
    preserves the old utiltrace behavior: a span slower than the
    threshold logs its child steps."""
    sp = start_span(name, pod=pod, parent=parent, proc=proc,
                    recorder=recorder, **attrs)
    _CTX.stack.append(sp)
    if _PHASE_SINK is not None:
        _publish_phase(name)
    try:
        yield sp
    finally:
        _CTX.stack.pop()
        if _PHASE_SINK is not None:
            cur = _CTX.stack[-1] if _CTX.stack else None
            _publish_phase(cur.name if cur is not None else None)
        sp.finish()
        if slow_log_s is not None and sp.dur_s >= slow_log_s:
            rec = recorder or RECORDER
            steps = "; ".join(
                f"{s.dur_s * 1e3:.1f}ms {s.name}" for s in rec.spans()
                if s.parent_id == sp.span_id)
            log.warning("trace %s (%s) took %.1fms: %s", name,
                        pod or "-", sp.dur_s * 1e3, steps)


def event(name: str, pod: Optional[str] = None, parent: Any = None,
          proc: Optional[str] = None,
          recorder: Optional[SpanRecorder] = None, **attrs: Any) -> Span:
    """Zero-duration span: a point-in-time fact on a pod's timeline
    (assume, watch delivery, conflict loss, backoff park)."""
    return start_span(name, pod=pod, parent=parent, proc=proc,
                      recorder=recorder, **attrs).finish()


@contextmanager
def batch_context(mapping: dict) -> Iterator[None]:
    """Install a {pod -> (trace_id, span_id)} parent mapping on this
    thread — the batched-verb analogue of span nesting. The HTTP clients
    serialize it into ``TRACE_HEADER``; the in-process apiserver reads
    it directly via ``parent_for``."""
    prev = _CTX.batch
    _CTX.batch = dict(mapping)
    try:
        yield
    finally:
        _CTX.batch = prev


def header_value() -> Optional[str]:
    """Serialize this thread's span context for an outgoing HTTP request,
    or None when nothing is active (no header, zero cost)."""
    out: dict = {}
    batch = _CTX.batch
    if batch:
        out["pods"] = {pod: f"{t}/{s}" for pod, (t, s) in batch.items()}
    cur = current()
    if cur is not None:
        out["parent"] = f"{cur.trace_id}/{cur.span_id}"
    return json.dumps(out) if out else None


def _parse_ctx(value: str) -> Optional[tuple]:
    trace_id, _, span_id = value.partition("/")
    if trace_id and span_id:
        return (trace_id, span_id)
    return None


@contextmanager
def remote_context(header: Optional[str]) -> Iterator[None]:
    """Install the span context carried by an incoming request's
    ``TRACE_HEADER`` for the duration of its handling. A malformed or
    absent header installs nothing — tracing must never fail a
    request."""
    if not header:
        yield
        return
    try:
        doc = json.loads(header)
        mapping = {pod: ctx for pod, raw in (doc.get("pods") or {}).items()
                   if (ctx := _parse_ctx(str(raw))) is not None}
        parent = _parse_ctx(str(doc.get("parent") or ""))
    except (TypeError, ValueError):
        yield
        return
    prev_batch, prev_stack = _CTX.batch, _CTX.stack
    _CTX.batch = mapping or None
    _CTX.stack = []
    anchor = None
    if parent is not None:
        # a phantom entry standing in for the remote caller's span: it
        # is never recorded, only parented under
        anchor = Span("remote", parent[0], parent[1], None, None,
                      "remote", RECORDER, {})
        anchor._done = True
        _CTX.stack = [anchor]
    try:
        yield
    finally:
        _CTX.batch = prev_batch
        _CTX.stack = prev_stack


# ---- export ----------------------------------------------------------------


def chrome_trace(spans: Optional[list] = None,
                 recorder: Optional[SpanRecorder] = None) -> dict:
    """Chrome trace-event JSON (Perfetto-loadable): one process row per
    component (scheduler replica, apiserver), one thread row per pod —
    a pod's whole cross-process life reads as one horizontal lane per
    component with matching ``trace_id`` args."""
    if spans is None:
        spans = (recorder or RECORDER).spans()
    pids: dict = {}
    tids: dict = {}
    events: list = []
    for s in spans:
        pid = pids.setdefault(s.proc, len(pids) + 1)
        tid = tids.setdefault((s.proc, s.pod or "(none)"), len(tids) + 1)
        events.append({
            "name": s.name, "ph": "X", "cat": "sched",
            "ts": s.start_s * 1e6, "dur": max(s.dur_s, 0.0) * 1e6,
            "pid": pid, "tid": tid,
            "args": {"trace_id": s.trace_id, "span_id": s.span_id,
                     "parent_id": s.parent_id, "pod": s.pod,
                     **s.attrs},
        })
    meta: list = []
    for proc, pid in pids.items():
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": proc}})
    for (proc, pod), tid in tids.items():
        meta.append({"name": "thread_name", "ph": "M",
                     "pid": pids[proc], "tid": tid,
                     "args": {"name": pod}})
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_trace(path: str, recorder: Optional[SpanRecorder] = None) -> int:
    """Dump the ring as Chrome trace JSON; returns the span count."""
    doc = chrome_trace(recorder=recorder)
    with open(path, "w") as f:
        json.dump(doc, f)
    return sum(1 for e in doc["traceEvents"] if e.get("ph") == "X")


def explain_pod(pod_name: str,
                recorder: Optional[SpanRecorder] = None) -> dict:
    """The "why is this pod Pending/slow" answer: the pod's timeline in
    this process plus a digest — last per-node FitError reasons, commit
    conflicts lost, backoff parks, and whether a bind committed."""
    rec = recorder or RECORDER
    spans = sorted(rec.pod_spans(pod_name), key=lambda s: s.start_s)
    last_failure = None
    conflicts = 0
    parks = 0
    bound_span = None
    unrepairable = None
    for s in spans:
        if s.name == "unschedulable":
            last_failure = dict(s.attrs)
        elif s.name == "conflict_loss":
            conflicts += 1
        elif s.name == "backoff_park":
            parks += 1
        elif s.name == "unrepairable":
            # the repair controller parked this pod's gang with a typed
            # reason instead of evict-looping (scheduler/repair.py);
            # latest wins — a later heal clears it with a repair span
            unrepairable = dict(s.attrs)
        elif s.name == "repair_eviction":
            unrepairable = None
        elif s.name in ("bind_commit", "arbiter_commit") and \
                s.attrs.get("outcome", "committed") == "committed":
            bound_span = s
    out = {
        "pod": pod_name,
        "trace_id": trace_id_for_pod(pod_name),
        "proc": rec.proc,
        "spans": [s.to_dict() for s in spans],
        "conflict_losses": conflicts,
        "backoff_parks": parks,
        "state": "bound" if bound_span is not None else "pending",
    }
    if bound_span is not None and bound_span.attrs.get("node"):
        out["node"] = bound_span.attrs["node"]
    if last_failure is not None:
        out["last_failure"] = last_failure
    if unrepairable is not None:
        out["unrepairable"] = unrepairable
    if not spans:
        out["note"] = ("no spans recorded for this pod in this process "
                       "(never seen here, or aged out of the ring)")
    return out
