"""The serving, transport and scheduling metrics: a copy of the part of
``kubegpu_tpu/metrics.py`` that the port records.

The exponential-bucket ``Histogram``, the ``Counter``, the settable
``Gauge`` and their labelled families; the four serving metrics (time to
first token, inter-token latency, queue depth, slot utilization), the
control-plane wire's bytes and frame codec times, the scheduling engine's
counters and histograms (its default path's masked pass and batch cycle
among them), the node lifecycle controller's, those of the scheduler
binary's client, leases and observability, and the API server's (requests,
write-ahead log, front door), all under the JAX package's names. Every
metric
is listed once in ``all_metrics()``, which the Prometheus exposition (the
binaries' ``/metrics``), ``reset_all()`` and the metrics time-series
(``obs/timeseries.py``, through each metric's ``snapshot()``) iterate.
"""

from __future__ import annotations

import logging
import threading

log = logging.getLogger("kubegpu_tpu_torch")


def bucket_percentile(bounds: list, counts: list, n: int,
                      q: float) -> float:
    """Percentile from per-bucket counts, linearly interpolated within
    the landing bucket; ``counts`` carries one trailing overflow bucket
    beyond ``bounds``, whose answers stay the last finite bound."""
    if n == 0:
        return 0.0
    target = q * n
    seen = 0
    lo = 0.0
    for i, c in enumerate(counts[:-1]):
        if c and seen + c >= target:
            hi = bounds[i]
            return lo + (hi - lo) * (target - seen) / c
        seen += c
        lo = bounds[i]
    return bounds[-1]


class Histogram:
    """Exponential-bucket histogram (``count`` buckets from ``start_us``
    growing by ``factor``, plus one overflow bucket)."""

    def __init__(self, name: str, start_us: float = 1000.0,
                 factor: float = 2.0, count: int = 15):
        self.name = name
        self.buckets = [start_us * factor**i for i in range(count)]
        self.counts = [0] * (count + 1)
        self.total = 0.0
        self.n = 0
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        with self._lock:
            self.n += 1
            self.total += value
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1

    def percentile(self, q: float) -> float:
        with self._lock:
            return bucket_percentile(self.buckets, self.counts, self.n, q)

    def snapshot(self) -> dict:
        """Point-in-time capture, bucket counts included (windowed
        percentiles come from the deltas of two snapshots)."""
        with self._lock:
            return {"type": "hist", "n": self.n, "sum": self.total,
                    "buckets": list(self.buckets),
                    "counts": list(self.counts)}

    def reset(self) -> None:
        with self._lock:
            self.counts = [0] * len(self.counts)
            self.total = 0.0
            self.n = 0


class Gauge:
    """A settable level (queue depth, slot utilization)."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def set(self, value) -> None:
        with self._lock:
            self.value = value

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "gauge", "v": self.value}

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class Counter:
    """A count that only grows."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, by: int = 1) -> None:
        with self._lock:
            self.value += by

    def snapshot(self) -> dict:
        with self._lock:
            return {"type": "counter", "v": self.value}

    def reset(self) -> None:
        with self._lock:
            self.value = 0


class LabeledCounter:
    """A family of counters keyed by label values (Prometheus
    ``name{a="x",b="y"}``); a child is created on first use."""

    def __init__(self, name: str, label_names: tuple):
        self.name = name
        self.label_names = tuple(label_names)
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, *values: str) -> Counter:
        if len(values) != len(self.label_names):
            raise ValueError(f"{self.name} takes labels "
                             f"{self.label_names}, got {values}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = Counter(self.name)
            return child

    def children(self) -> list:
        """[(label values, child)] sorted by the values."""
        with self._lock:
            return sorted(self._children.items())

    def snapshot(self) -> dict:
        return {"type": "counter_family",
                "children": {",".join(values): child.value
                             for values, child in self.children()}}

    def reset(self) -> None:
        with self._lock:
            self._children = {}


class LabeledGauge:
    """A gauge family keyed by one label (one scheduling queue's depth per
    engine)."""

    def __init__(self, name: str, label: str):
        self.name = name
        self.label = label
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Gauge:
        with self._lock:
            child = self._children.get(value)
            if child is None:
                child = self._children[value] = Gauge(self.name)
            return child

    def children(self) -> list:
        with self._lock:
            return sorted(self._children.items())

    def snapshot(self) -> dict:
        return {"type": "gauge_family",
                "children": {value: child.value
                             for value, child in self.children()}}

    def reset(self) -> None:
        with self._lock:
            self._children = {}


class LabeledHistogram:
    """A histogram family keyed by one label (the scheduling phases)."""

    def __init__(self, name: str, label: str, start_us: float = 1000.0,
                 factor: float = 2.0, count: int = 15):
        self.name = name
        self.label = label
        self._ctor = (start_us, factor, count)
        self._children: dict = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Histogram:
        with self._lock:
            child = self._children.get(value)
            if child is None:
                child = self._children[value] = Histogram(self.name,
                                                          *self._ctor)
            return child

    def children(self) -> list:
        with self._lock:
            return sorted(self._children.items())

    def snapshot(self) -> dict:
        return {"type": "hist_family",
                "children": {value: child.snapshot()
                             for value, child in self.children()}}

    def reset(self) -> None:
        with self._lock:
            self._children = {}


SERVE_TTFT_MS = Histogram("serve_ttft_ms", start_us=0.25)
SERVE_ITL_MS = Histogram("serve_itl_ms", start_us=0.01)
SERVE_QUEUE_DEPTH = Gauge("serve_queue_depth")
SERVE_SLOT_UTILIZATION = Gauge("serve_slot_utilization")  # 0..1 ratio
# Launches of the decode attention kernel (workload/kernels/decode_attn.py,
# K4): a serving run's decode that took the kernel counts n_layers a token
# step. The port's own metric: the JAX package has no such kernel.
DECODE_ATTN_KERNEL_CALLS = Counter("decode_attn_kernel_calls_total")

# The control-plane wire (cluster/stream.py, cluster/httpapi.py): bytes
# this process moved per wire ("json"/"stream") and direction ("tx"/"rx"),
# frame headers included on the stream wire and HTTP headers left out on
# the JSON wire (bodies only); and the binary codec's time per frame.
TRANSPORT_BYTES = LabeledCounter("transport_bytes_total", ("wire", "dir"))
FRAME_ENCODE_MS = Histogram("frame_encode_ms", start_us=0.002)
FRAME_DECODE_MS = Histogram("frame_decode_ms", start_us=0.002)

# The scheduling engine (scheduler/core.py, cache.py, equivalence.py,
# queue.py): the reference's three scheduler histograms
# (`metrics.go:29-54`), attempts, failures and internal errors, the
# equivalence memo's effectiveness, the binder's latency and in-flight
# depth, commit conflicts, the per-phase times, the queue depth per engine
# and the committed-bind rate.
E2E_SCHEDULING_LATENCY = Histogram(
    "scheduler_e2e_scheduling_latency_microseconds")
ALGORITHM_LATENCY = Histogram(
    "scheduler_scheduling_algorithm_latency_microseconds")
BINDING_LATENCY = Histogram("scheduler_binding_latency_microseconds")
SCHEDULE_ATTEMPTS = Counter("scheduler_schedule_attempts_total")
SCHEDULE_FAILURES = Counter("scheduler_schedule_failures_total")
PREEMPTION_VICTIMS = Counter("scheduler_preemption_victims_total")
INTERNAL_ERRORS = Counter("scheduler_internal_errors_total")
# Group-allocation searches that took the Python path
# (allocator/grpalloc.py): only inputs the native core's line protocol
# cannot carry go there, so a fleet whose searches never reach the core
# shows here.
NATIVE_FALLBACKS = Counter("allocator_native_fallbacks_total")
FIT_CACHE_HITS = Counter("fit_cache_hits_total")
FIT_CACHE_MISSES = Counter("fit_cache_misses_total")
FIT_CACHE_INVALIDATIONS = Counter("fit_cache_invalidations_total")
FIT_VERDICT_TIMEOUTS = Counter("fit_verdict_timeouts_total")
BIND_LATENCY_MS = Histogram("bind_latency_ms", start_us=0.25)
BIND_INFLIGHT = Gauge("bind_inflight")
SCHED_CONFLICTS = Counter("sched_conflicts_total")
SCHED_PHASE_MS = LabeledHistogram("sched_phase_ms", "phase", start_us=0.01)
SCHED_QUEUE_DEPTH = LabeledGauge("sched_queue_depth", "queue")
SCHED_THROUGHPUT = Gauge("sched_throughput_pods_per_s")

# The engine's default path (scheduler/vectorized.py, batch.py and the
# batch cycle of core.py): the masked pass's time and the nodes it served,
# the nodes that fell out of the mask into the scalar chain (tainted,
# carrying placed volumes or nominations, or the whole fleet for a pod
# that needs object predicates), the admitted pods one drained backlog
# carried, and the filter passes that cycle paid (batch classes plus
# serial pods).
FIT_VECTOR_PASS_MS = Histogram("fit_vector_pass_ms", start_us=0.25)
FIT_VECTOR_NODES_PER_PASS = Histogram(  # analysis: disable=metric-registration -- node-count histogram; the unit IS nodes-per-pass, not a time/bytes quantity the suffix vocabulary covers
    "fit_vector_nodes_per_pass", start_us=1.0, factor=2.0, count=15)
FIT_SCALAR_FALLBACK = Counter("fit_scalar_fallback_total")
SCHED_BATCH_SIZE = Histogram(  # analysis: disable=metric-registration -- pod-count histogram; the unit IS pods-per-cycle, not a time/bytes quantity the suffix vocabulary covers
    "sched_batch_size", start_us=1.0, factor=2.0, count=12)
SCHED_BATCH_CLASSES = Histogram(  # analysis: disable=metric-registration -- class-count histogram; the unit IS classes-per-cycle, not a time/bytes quantity the suffix vocabulary covers
    "sched_batch_classes_per_cycle", start_us=1.0, factor=2.0, count=12)

# The node lifecycle controller (scheduler/lifecycle.py): the nodes Ready
# at the last pass, Ready-to-Lost transitions, and pods evicted off Lost
# nodes (whole gangs, survivors included).
NODE_READY = Gauge("scheduler_node_ready")
NODE_LOST = Counter("scheduler_node_lost_total")
EVICTIONS = Counter("scheduler_evictions_total")

# The tenant quota gate (scheduler/quota.py): pods parked over their
# tenant's fair share. The repair controller (scheduler/repair.py): its
# outcomes (repaired, failed, deferred_pdb, parked_unrepairable,
# parked_budget) and the ms from a fault's detection to its unit's repair.
QUOTA_PARKED = Counter("quota_parked_total")
REPAIRS = LabeledCounter("scheduler_repairs_total", ("outcome",))
REPAIR_LATENCY_MS = Histogram("repair_latency_ms", start_us=0.25)

# The scheduler binary's client, leases and observability
# (cluster/httpapi.py, cluster/lease.py, obs/): the size of the last
# delivered watch batch, events the server folded away before delivery,
# the stream wire's push lag (server stamp to client delivery), leadership
# and shard transitions, flight-recorder dumps and profiler ticks.
WATCH_BATCH_SIZE = Gauge("watch_batch_size")
WATCH_COALESCED = Counter("watch_coalesced_total")
WATCH_PUSH_LAG_MS = Histogram("watch_push_lag_ms", start_us=0.01)
LEASE_TRANSITIONS = Counter("lease_transitions_total")
FLIGHT_DUMPS = Counter("flight_dumps_total")
PROFILE_SAMPLES = Counter("profile_samples_total")

# The API server (cluster/apiserver.py, httpapi.py, wal.py, apf.py): the
# requests each transport role dispatched ({server}: "apiserver"), the
# write-ahead log's time per append (fsync included when on) and the size
# of its last snapshot, the queue wait of requests the front door seated,
# and the requests it shed with a 429 or a REJECT frame, per band (the
# system band is exempt, so a system child is a front-door fault).
API_REQUESTS = LabeledCounter("api_requests_total", ("server",))
WAL_FSYNC_MS = Histogram("wal_fsync_ms", start_us=0.01)
WAL_SNAPSHOT_BYTES = Gauge("wal_snapshot_bytes")
APF_QUEUE_WAIT_MS = Histogram("apf_queue_wait_ms", start_us=0.01)
APF_REJECTS = LabeledCounter("apf_rejects_total", ("band",))

# The watch-cache proxy tier (cluster/proxy.py): each replica's live
# downstream stream subscribers ({proxy}: its name), and the upstream hop's
# lag, from the API server's batch stamp to the proxy's ingest (apart from
# watch_push_lag_ms, so the downstream fan-out stays comparable between
# direct and proxied paths). Its upstream bytes count under
# transport_bytes_total{wire="proxy"}, its requests under
# api_requests_total{server="proxy"}.
PROXY_DOWNSTREAM_WATCHERS = LabeledGauge("proxy_downstream_watchers", "proxy")
PROXY_UPSTREAM_LAG_MS = Histogram("proxy_upstream_lag_ms", start_us=0.01)

def all_metrics() -> list:
    """Every metric instance declared at module level, found by scan in
    declaration order (the exposition order): registration, reset and
    exposition iterate this, so a newly declared metric cannot drift out
    of any of them."""
    kinds = (Histogram, Counter, Gauge, LabeledHistogram, LabeledCounter,
             LabeledGauge)
    return [obj for obj in globals().values() if isinstance(obj, kinds)]


def reset_all() -> None:
    """Fresh metric state (tests and bench runs)."""
    for metric in all_metrics():
        metric.reset()


def _histogram_lines(h: Histogram, labels: str = "") -> list:
    """One histogram's exposition lines; ``labels`` is a pre-rendered
    ``key="value",`` prefix for a family's child."""
    with h._lock:
        lines = []
        cumulative = 0
        for bound, count in zip(h.buckets, h.counts):
            cumulative += count
            lines.append(f'{h.name}_bucket{{{labels}le="{bound:g}"}} '
                         f"{cumulative}")
        lines.append(f'{h.name}_bucket{{{labels}le="+Inf"}} {h.n}')
        suffix = f"{{{labels[:-1]}}}" if labels else ""
        lines.append(f"{h.name}_sum{suffix} {h.total:.6g}")
        lines.append(f"{h.name}_count{suffix} {h.n}")
    return lines


def prometheus_text() -> str:
    """Every metric above in Prometheus exposition format."""
    lines = []
    for m in all_metrics():
        if isinstance(m, Histogram):
            lines.append(f"# TYPE {m.name} histogram")
            lines.extend(_histogram_lines(m))
        elif isinstance(m, LabeledHistogram):
            lines.append(f"# TYPE {m.name} histogram")
            for value, child in m.children():
                lines.extend(_histogram_lines(child,
                                              f'{m.label}="{value}",'))
        elif isinstance(m, LabeledGauge):
            lines.append(f"# TYPE {m.name} gauge")
            for value, child in m.children():
                lines.append(f'{m.name}{{{m.label}="{value}"}} '
                             f"{child.value}")
        elif isinstance(m, Counter):
            lines.append(f"# TYPE {m.name} counter")
            lines.append(f"{m.name} {m.value}")
        elif isinstance(m, LabeledCounter):
            lines.append(f"# TYPE {m.name} counter")
            for values, child in m.children():
                rendered = ",".join(
                    f'{k}="{v}"' for k, v in zip(m.label_names, values))
                lines.append(f"{m.name}{{{rendered}}} {child.value}")
        else:
            lines.append(f"# TYPE {m.name} gauge")
            lines.append(f"{m.name} {m.value}")
    return "\n".join(lines) + "\n"
