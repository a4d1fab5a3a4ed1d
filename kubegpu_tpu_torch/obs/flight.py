"""Anomaly flight recorder (the port's copy of ``kubegpu_tpu/obs/
flight.py``): dump the span ring to disk when something breaks, so a
failure ships with evidence instead of a re-run under print statements.

Triggers (wired at the anomaly sites):

- ``internal_error``   — a non-FitError escaped the scheduling algorithm
- ``conflict_streak``  — a pod's commits kept losing to competing
  replicas until the binder escalated to unschedulable backoff
- ``lease_lost``       — an elector was demoted (leadership/shard moved)
- ``gang_eviction``    — node loss widened an eviction to a whole gang
  (the node lifecycle controller's, which the port does not run yet)

Each dump is one JSON file carrying the trigger, a Chrome trace of the
ring at that moment, and the per-pod explanation when the anomaly names
a pod. Dumps are **deduplicated per anomaly key** with a cooldown — a
conflict streak or a flapping lease must not storm the disk — and the
recorder is inert until ``configure()`` names a directory (or the
``KGTPU_FLIGHT_DIR`` environment variable does)."""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Optional

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.obs import trace

log = logging.getLogger(__name__)

ENV_DIR = "KGTPU_FLIGHT_DIR"


class FlightRecorder:
    """Dump-on-anomaly over a :class:`trace.SpanRecorder` ring."""

    def __init__(self, recorder: Optional[trace.SpanRecorder] = None,
                 directory: Optional[str] = None,
                 cooldown_s: float = 60.0):
        self._lock = threading.Lock()
        self.recorder = recorder or trace.RECORDER
        self.directory = directory or os.environ.get(ENV_DIR)
        self.cooldown_s = cooldown_s
        self._seen: dict = {}   # (kind, key) -> last dump monotonic time
        self._seq = 0
        self.dumps = 0          # files written by this process

    def configure(self, directory: Optional[str],
                  cooldown_s: Optional[float] = None) -> None:
        with self._lock:
            self.directory = directory
            if cooldown_s is not None:
                self.cooldown_s = cooldown_s

    def trigger(self, kind: str, key: str = "", pod: Optional[str] = None,
                **detail: Any) -> Optional[str]:
        """Record an anomaly. Returns the dump path when a file was
        written, None when unconfigured or deduplicated. Never raises:
        the flight recorder must not add a failure mode to the paths it
        observes."""
        with self._lock:
            directory = self.directory
            if directory is None:
                return None
            now = time.monotonic()
            # prune expired cooldown entries: keys embed pod names, so a
            # long-lived replica under churn must not grow this forever
            self._seen = {k: t for k, t in self._seen.items()
                          if now - t < self.cooldown_s}
            if (kind, key) in self._seen:
                return None  # same anomaly inside the window: one dump
            self._seen[(kind, key)] = now
            self._seq += 1
            seq = self._seq
        # file I/O strictly outside the lock: a slow disk must not block
        # a concurrent trigger's dedup check
        path = os.path.join(
            directory, f"flight-{os.getpid()}-{seq:04d}-{kind}.json")
        doc = {
            "kind": kind,
            "key": key,
            "pod": pod,
            "detail": detail,
            "proc": self.recorder.proc,
            # wall clock: a human matches this against their logs
            "time": trace.wall_now(),
            "trace": trace.chrome_trace(recorder=self.recorder),
        }
        if pod:
            doc["explain"] = trace.explain_pod(pod, recorder=self.recorder)
        try:
            os.makedirs(directory, exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f)
            os.replace(tmp, path)
        except OSError:
            log.warning("flight recorder: dump %s failed", path,
                        exc_info=True)
            return None
        with self._lock:
            self.dumps += 1
        metrics.FLIGHT_DUMPS.inc()
        log.warning("flight recorder: %s (%s) dumped to %s", kind,
                    key or pod or "-", path)
        return path


#: Process-global flight recorder over the global span ring. Inert until
#: configured (flag/env); triggers are safe to call unconditionally.
FLIGHT = FlightRecorder()
