"""What both kinds of cell share: the clock, spans, the tracer, the device."""

from __future__ import annotations

import gc
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from . import trace

clock = time.perf_counter


def span(name: str):
    """A ``perfbench.<name>`` span around a call into the program (a
    profiler range; nothing when no profiler runs)."""
    return record_function(trace.SPAN_PREFIX + name)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# a traced run measures this long a window (or the run's, if shorter):
# the profile of a longer one takes too long to read within a run
TRACE_SECONDS = 10.0


class Tracer:
    """``start()`` profiles from the window's opening and wraps it in the
    ``perfbench.window`` span; ``stop()`` at its close ends the profile
    and reduces it into ``summary`` (`trace.reduce_events`). Does nothing
    when off."""

    def __init__(self, on: bool, device):
        self.on = on
        self.device = torch.device(device)
        self.summary = None
        self.seconds = {}
        self._prof = None
        self._span = None

    def warm(self) -> None:
        """Start and stop the profiler once, in set-up: the first start
        initialises the device tracer, which takes seconds, and must not
        fall inside the window."""
        if self.on:
            t0 = clock()
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            with profile(activities=acts):
                torch.zeros(1, device=self.device).add_(1)
            self.seconds["warm"] = clock() - t0

    def start(self) -> None:
        if not self.on or self._prof is not None:
            return
        t0 = clock()
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._span = span("window")
        self._span.__enter__()
        self.seconds["start"] = clock() - t0

    def stop(self) -> None:
        if self._prof is None:
            return
        self._span.__exit__(None, None, None)
        t0 = clock()
        self._prof.__exit__(None, None, None)
        t1 = clock()
        events = trace.events_from_profiler(self._prof)
        self._prof = None
        t2 = clock()
        self.summary = trace.reduce_events(events)
        self.seconds.update(stop=t1 - t0, read=t2 - t1,
                            reduce=clock() - t2, events=len(events))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.stop()
        elif self._prof is not None:
            self._prof.__exit__(*exc)
            self._prof = None
        return False


def free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def device_info(device, count: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}
