"""From a profiler trace of the measured window to numbers.

The traced run wraps its window in the span ``perfbench.window`` and each
call into the program in a ``perfbench.<layer>`` span (``torch.profiler.
record_function``). `reduce_events` takes the trace's events as `Ev`
tuples and gives:

- ``window_s``: the window span's length; ``busy_s``: the union of the
  device's operations (kernels, copies, fills) inside it;
- ``device_s`` / ``device_calls``: device seconds and launches by
  operation name;
- ``cast_s``: device seconds of the operations launched inside
  ``aten::_to_copy`` (dtype casts, ``.to()`` and ``.float()``), found
  through each launch's correlation id;
- ``idle``: the device's idle time in the window, by what the host's
  main thread was doing at each gap's middle (the innermost
  ``perfbench.*`` span and the innermost operator);
- ``spans``: host seconds by ``perfbench.*`` span name.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

WINDOW = "perfbench.window"
SPAN_PREFIX = "perfbench."
CAST_OP = "aten::_to_copy"


@dataclass(frozen=True)
class Ev:
    name: str
    on_device: bool
    start_ns: int
    end_ns: int
    thread: int = 0
    corr: int = 0


def events_from_profiler(prof) -> list:
    """The `Ev`s of a finished ``torch.profiler.profile``, read from its
    raw results without building the profiler's own event tree."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = str(e.device_type()).endswith("CUDA")
        if dev and _annotation(e):
            continue          # a host range mirrored on the device's line
        start = int(e.start_ns())
        out.append(Ev(e.name(), dev, start, start + int(e.duration_ns()),
                      int(e.start_thread_id()), int(e.correlation_id())))
    return out


def _annotation(e) -> bool:
    """Whether a device-side event is a user range (``record_function``,
    the optimizer's ``Optimizer.step#...``) and not an operation."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    kind = getattr(e, "activity_type", None)
    if kind is not None and "annotation" in str(kind()).lower():
        return True
    return e.name().startswith((SPAN_PREFIX, "Optimizer."))


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def _stacks_at(cpu: list, times: list) -> list:
    """For each time (ascending), the names of the host events covering
    it, outermost first. ``cpu`` is one thread's events sorted by start;
    they nest, as a thread's spans and operators do."""
    out = []
    stack: list = []
    i = 0
    for t in times:
        while i < len(cpu) and cpu[i].start_ns <= t:
            ev = cpu[i]
            while stack and stack[-1].end_ns < ev.start_ns:
                stack.pop()
            stack.append(ev)
            i += 1
        while stack and stack[-1].end_ns < t:
            stack.pop()
        out.append([ev.name for ev in stack if ev.start_ns <= t <= ev.end_ns])
    return out


def _label(names: list) -> str:
    span = next((n for n in reversed(names)
                 if n.startswith(SPAN_PREFIX) and n != WINDOW),
                "outside spans")
    op = next((n for n in reversed(names) if not n.startswith(SPAN_PREFIX)),
              None)
    return f"{span}: {op}" if op else span


def reduce_events(events: list) -> dict | None:
    """The numbers of one traced window; None when the trace holds no
    window span or no device operation inside it."""
    wins = [e for e in events if not e.on_device and e.name == WINDOW]
    if not wins:
        return None
    win = wins[0]
    ws, we = win.start_ns, win.end_ns
    dev = [e for e in events if e.on_device and e.end_ns > ws
           and e.start_ns < we]
    if not dev:
        return None
    clipped = [(max(e.start_ns, ws), min(e.end_ns, we)) for e in dev]
    busy = _union([list(c) for c in clipped])
    busy_ns = sum(e - s for s, e in busy)

    device_s: dict = defaultdict(float)
    device_calls: dict = defaultdict(int)
    for e, (s, t) in zip(dev, clipped):
        device_s[e.name] += (t - s) / 1e9
        device_calls[e.name] += 1

    host = [e for e in events if not e.on_device]
    by_thread: dict = defaultdict(list)
    for e in host:
        by_thread[e.thread].append(e)
    for lst in by_thread.values():
        lst.sort(key=lambda e: (e.start_ns, -e.end_ns))

    # idle gaps, labelled by the main thread's activity at their middle
    gaps = []
    prev = ws
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if we > prev:
        gaps.append((prev, we))
    mids = [(a + b) // 2 for a, b in gaps]
    stacks = _stacks_at(by_thread.get(win.thread, []), mids)
    idle: dict = defaultdict(float)
    for (a, b), names in zip(gaps, stacks):
        idle[_label(names)] += (b - a) / 1e9

    # casts: operations launched inside aten::_to_copy
    launches = {}
    for e in host:
        if e.corr and e.name.startswith(("cuda", "cu")):
            launches[e.corr] = e
    per_thread_q: dict = defaultdict(list)
    for i, e in enumerate(dev):
        ln = launches.get(e.corr)
        if ln is not None:
            per_thread_q[ln.thread].append((ln.start_ns, i))
    cast_ns = 0
    linked = 0
    for thread, qs in per_thread_q.items():
        qs.sort()
        stacks = _stacks_at(by_thread[thread], [t for t, _ in qs])
        for (_, i), names in zip(qs, stacks):
            linked += 1
            if CAST_OP in names:
                s, t = clipped[i]
                cast_ns += t - s

    spans: dict = defaultdict(float)
    for e in host:
        if e.name.startswith(SPAN_PREFIX) and e.name != WINDOW:
            spans[e.name] += (min(e.end_ns, we) - max(e.start_ns, ws)) / 1e9

    return {"window_s": (we - ws) / 1e9, "busy_s": busy_ns / 1e9,
            "device_total_s": sum(device_s.values()),
            "device_s": dict(device_s), "device_calls": dict(device_calls),
            "cast_s": cast_ns / 1e9 if linked else None,
            "idle": dict(idle), "spans": dict(spans)}


def breakdown(summary: dict, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device operations that took
    most time and the longest idle time by host activity."""
    ops = sorted(summary["device_s"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:160], s] for name, s in ops],
            "idle_gaps": [[name[:160], s] for name, s in gaps]}

