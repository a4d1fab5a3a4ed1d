"""Scheduling queue with unschedulable backoff.

Reference: `kube-scheduler/pkg/core/scheduling_queue.go` +
`util/backoff_utils.go`, reduced to the behaviors the engine needs:
priority-FIFO active queue, an unschedulable set with exponential per-pod
backoff, and "move everything back to active" on cluster events (a new
node may make unschedulable pods feasible).
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time

from kubegpu_tpu_torch import metrics, obs
from kubegpu_tpu_torch.analysis.explore import probe

INITIAL_BACKOFF_S = 1.0
MAX_BACKOFF_S = 60.0


class SchedulingQueue:
    def __init__(self) -> None:
        self._lock = threading.Condition()
        self._heap: list = []            # (-priority, seq, pod_name)
        self._pods: dict = {}            # name -> kube_pod
        self._seq = itertools.count()
        self._unschedulable: dict = {}   # name -> (kube_pod, retry_at)
        self._backoff: dict = {}         # name -> current backoff seconds
        self._enqueued: dict = {}        # name -> perf_counter() at admit
        # span identity for queue_wait spans; the owning Scheduler
        # overwrites this with its replica name
        self.obs_name = "scheduler"

    @staticmethod
    def _priority(pod: dict) -> int:
        return int((pod.get("spec") or {}).get("priority") or 0)

    def _publish_depth_locked(self) -> None:
        # live queue depth (active + parked) for the metrics
        # time-series, labeled per replica (obs_name) so HA processes
        # with several queues don't clobber one another: monotone
        # growth per child is the anomaly watchdog's "scheduler
        # falling behind" signal
        metrics.SCHED_QUEUE_DEPTH.labels(self.obs_name).set(
            len(self._pods) + len(self._unschedulable))

    def push(self, kube_pod: dict) -> None:
        probe("queue.push")
        with self._lock:
            name = kube_pod["metadata"]["name"]
            if name not in self._enqueued:
                # queue-wait measures admission -> pop, surviving the
                # replace-in-place a watch update performs
                self._enqueued[name] = time.perf_counter()
            if name in self._pods:
                self._pods[name] = kube_pod
                return
            self._pods[name] = kube_pod
            heapq.heappush(self._heap, (-self._priority(kube_pod),
                                        next(self._seq), name))
            self._publish_depth_locked()
            self._lock.notify()

    def push_many(self, kube_pods: list) -> None:
        """Admit a whole batch under ONE lock acquisition with ONE wake
        and ONE depth publish — the per-pod ``push`` loop a 256-pod
        quota release used to run woke the scheduling thread 256 times
        and republished the gauge 256 times for one logical event."""
        probe("queue.push_many")
        if not kube_pods:
            return
        with self._lock:
            for kube_pod in kube_pods:
                name = kube_pod["metadata"]["name"]
                if name not in self._enqueued:
                    self._enqueued[name] = time.perf_counter()
                if name in self._pods:
                    self._pods[name] = kube_pod
                    continue
                self._pods[name] = kube_pod
                heapq.heappush(self._heap, (-self._priority(kube_pod),
                                            next(self._seq), name))
            self._publish_depth_locked()
            self._lock.notify_all()

    def pop(self, timeout: float | None = None) -> dict | None:
        """Highest-priority pending pod, blocking up to ``timeout``."""
        probe("queue.pop")
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                self._admit_backed_off_locked()
                while self._heap:
                    _, _, name = heapq.heappop(self._heap)
                    pod = self._pods.pop(name, None)
                    if pod is not None:
                        self._publish_depth_locked()
                        self._observe_wait_locked(name)
                        return pod
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    wait = min(wait, remaining)
                self._lock.wait(wait)

    def pop_many(self, max_pods: int,
                 timeout: float | None = None) -> list:
        """Drain up to ``max_pods`` ready pods in heap order (priority
        desc, FIFO within a priority) under ONE lock acquisition — the
        batch cycle's intake. Blocks up to ``timeout`` only while the
        queue is EMPTY; once anything is ready the whole ready run is
        taken without waiting for more. Per-pod queue-wait accounting is
        identical to ``pop``; the depth gauge republishes once."""
        probe("queue.pop_many")
        deadline = None if timeout is None else time.monotonic() + timeout
        out: list = []
        with self._lock:
            while True:
                self._admit_backed_off_locked()
                while self._heap and len(out) < max_pods:
                    _, _, name = heapq.heappop(self._heap)
                    pod = self._pods.pop(name, None)
                    if pod is not None:
                        self._observe_wait_locked(name)
                        out.append(pod)
                if out:
                    self._publish_depth_locked()
                    return out
                wait = 0.05
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return out
                    wait = min(wait, remaining)
                self._lock.wait(wait)

    def _observe_wait_locked(self, name: str) -> None:
        admitted = self._enqueued.pop(name, None)
        if admitted is not None:
            wait_s = time.perf_counter() - admitted
            metrics.SCHED_PHASE_MS.labels(
                "queue_wait").observe(wait_s * 1e3)
            obs.record_span(
                "queue_wait",
                obs.wall_now() - wait_s, wait_s,
                pod=name, proc=self.obs_name)

    def add_unschedulable(self, kube_pod: dict) -> None:
        """Park a pod that found no node, with exponential backoff
        (`backoff_utils.go`)."""
        probe("queue.add_unschedulable")
        with self._lock:
            name = kube_pod["metadata"]["name"]
            backoff = min(self._backoff.get(name, INITIAL_BACKOFF_S / 2) * 2,
                          MAX_BACKOFF_S)
            self._backoff[name] = backoff
            self._unschedulable[name] = (kube_pod, time.monotonic() + backoff)
            self._enqueued.setdefault(name, time.perf_counter())
            self._publish_depth_locked()
        obs.event("backoff_park", pod=name, proc=self.obs_name,
                  backoff_s=round(backoff, 3))

    def park(self, kube_pod: dict, delay_s: float) -> None:
        """Park a pod for a fixed delay WITHOUT growing its
        unschedulable backoff — used for pods outside this replica's
        shard: what's pending is ownership, not schedulability, and
        ``move_all_to_active`` (fired on shard-ownership change)
        re-admits immediately."""
        with self._lock:
            name = kube_pod["metadata"]["name"]
            self._unschedulable[name] = (kube_pod,
                                         time.monotonic() + delay_s)
            self._enqueued.setdefault(name, time.perf_counter())
            self._publish_depth_locked()

    def _admit_backed_off_locked(self) -> None:
        now = time.monotonic()
        ready = [n for n, (_, at) in self._unschedulable.items() if at <= now]
        for name in ready:
            pod, _ = self._unschedulable.pop(name)
            if name not in self._pods:
                self._pods[name] = pod
                heapq.heappush(self._heap, (-self._priority(pod),
                                            next(self._seq), name))
        if ready:
            # a pod re-pushed while parked sits in BOTH maps until its
            # park expires and the duplicate is dropped here — republish
            # or the gauge stays one high until the next push/pop
            self._publish_depth_locked()

    def move_all_to_active(self) -> None:
        """Cluster changed (node added/updated): retry everything now
        (`scheduling_queue.go:229-252`)."""
        with self._lock:
            for name, (pod, _) in list(self._unschedulable.items()):
                self._unschedulable.pop(name)
                self._backoff.pop(name, None)
                if name not in self._pods:
                    self._pods[name] = pod
                    heapq.heappush(self._heap, (-self._priority(pod),
                                                next(self._seq), name))
            self._publish_depth_locked()
            self._lock.notify_all()

    def forget(self, pod_name: str) -> None:
        probe("queue.forget")
        with self._lock:
            self._pods.pop(pod_name, None)
            self._unschedulable.pop(pod_name, None)
            self._backoff.pop(pod_name, None)
            self._enqueued.pop(pod_name, None)
            self._publish_depth_locked()

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pods) + len(self._unschedulable)
