"""Metrics time-series: a bounded ring of periodic snapshots of every
registered metric, with windowed queries and an anomaly watchdog (the
port's copy of ``kubegpu_tpu/obs/timeseries.py``).

``/metrics`` answers "what is the cumulative state *now*"; this module
answers "what changed over the last N seconds" — the question every
"why did p95 move" investigation actually asks. A snapshot thread
(``--metrics-interval-s``) records the full registry
(``metrics.all_metrics()``) into a bounded ring:

- **counters** (plain and labeled) snapshot their cumulative values;
  windowed queries report deltas and rates;
- **histograms** (plain and labeled) snapshot their raw bucket counts,
  so a windowed query can compute *windowed* percentiles from bucket
  deltas — p95 of the last minute, not of process lifetime;
- **gauges** report first/last/min/max over the window.

The :class:`Watchdog` runs over the same ring after each snapshot and
triggers the existing :class:`~kubegpu_tpu_torch.obs.flight.FlightRecorder`
(with the current profiler attribution attached, when a sampler is
running) on the anomaly shapes that precede a visible outage:

- ``p95_regression``   — a watched histogram's windowed p95 regressed
  vs its own trailing window
- ``queue_growth``     — a queue-depth gauge grew monotonically across
  N consecutive snapshots (the scheduler is falling behind)
- ``apf_reject_spike`` — the front door started shedding load far above
  its trailing rate
- ``conflict_streak``  — optimistic-commit conflicts sustained across
  consecutive intervals (replicas fighting, or a stuck claim)

The ring and queries are process-local, served on ``/metrics/history`` by
``cmd/common.serve_health``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Optional

from kubegpu_tpu_torch import metrics
from kubegpu_tpu_torch.obs import flight as flight_mod
from kubegpu_tpu_torch.obs import profile as profile_mod
from kubegpu_tpu_torch.obs import trace

DEFAULT_INTERVAL_S = 5.0
DEFAULT_CAPACITY = 720  # one hour at the default interval


# ---- snapshots -------------------------------------------------------------


def snapshot_metrics() -> dict:
    """One point-in-time capture of every registered metric, keyed by
    metric name (each metric type's own ``snapshot()``). Registry-
    driven: a newly declared metric joins the time-series
    automatically."""
    return {m.name: m.snapshot() for m in metrics.all_metrics()}


def _delta_percentile(bounds: list, counts0: list, counts1: list,
                      q: float) -> float:
    """Percentile of the observations that landed between two snapshots
    of one histogram — ``metrics.bucket_percentile`` over the bucket
    deltas, the same interpolation ``Histogram.percentile`` uses."""
    diff = [max(0, b - a) for a, b in zip(counts0, counts1)]
    return metrics.bucket_percentile(bounds, diff, sum(diff), q)


def _window_hist(bounds: list, c0: list, c1: list, n0: int, n1: int,
                 s0: float, s1: float) -> dict:
    return {"count": n1 - n0, "sum": round(s1 - s0, 6),
            "p50": round(_delta_percentile(bounds, c0, c1, 0.50), 3),
            "p95": round(_delta_percentile(bounds, c0, c1, 0.95), 3),
            "p99": round(_delta_percentile(bounds, c0, c1, 0.99), 3)}


class MetricsTimeSeries:
    """Bounded ring of periodic metric snapshots + windowed queries.
    ``snap_once()`` is public so tests (and the watchdog's own tests)
    can drive snapshots deterministically without the thread."""

    def __init__(self, interval_s: float = DEFAULT_INTERVAL_S,
                 capacity: int = DEFAULT_CAPACITY,
                 watchdog: "Optional[Watchdog]" = None) -> None:
        self.interval_s = max(0.05, float(interval_s))
        self.watchdog = watchdog
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(4, capacity))
        self._stop = threading.Event()
        # racer: single-writer -- start()/stop() are owner-thread calls
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MetricsTimeSeries":
        if self._thread is not None:
            return self
        # racer: single-writer -- start()/stop() are owner-thread calls
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="metrics-ts")
        self._thread.start()
        return self

    def stop(self) -> None:
        t = self._thread
        if t is None:
            return
        self._stop.set()
        t.join(timeout=5.0)
        self._thread = None

    def running(self) -> bool:
        return self._thread is not None

    def _run(self) -> None:
        profile_mod.register_thread("timeseries")
        while not self._stop.is_set():
            self.snap_once()
            self._stop.wait(self.interval_s)

    # -- data ----------------------------------------------------------------

    def snap_once(self) -> dict:
        """Take one snapshot now (and run the watchdog, if configured).
        Returns the snapshot."""
        snap = {"t": trace.wall_now(), "mono": time.monotonic(),
                "metrics": snapshot_metrics()}
        with self._lock:
            self._ring.append(snap)
        if self.watchdog is not None:
            try:
                self.watchdog.evaluate(self)
            except Exception:  # pragma: no cover - watchdog must not
                pass           # take down the snapshot loop
        return snap

    def snapshots(self, window_s: Optional[float] = None) -> list:
        with self._lock:
            snaps = list(self._ring)
        if window_s is None or not snaps:
            return snaps
        cutoff = snaps[-1]["mono"] - window_s
        return [s for s in snaps if s["mono"] >= cutoff]

    def window(self, window_s: float = 300.0) -> dict:
        """Windowed summary over the last ``window_s`` seconds of
        snapshots: counter deltas + rates, gauge envelopes, and windowed
        histogram percentiles (computed from bucket-count deltas)."""
        snaps = self.snapshots(window_s)
        if len(snaps) < 2:
            return {"snapshots": len(snaps),
                    "note": "need >= 2 snapshots for a window"}
        first, last = snaps[0], snaps[-1]
        dt = max(1e-9, last["mono"] - first["mono"])
        counters: dict = {}
        gauges: dict = {}
        hists: dict = {}
        m0, m1 = first["metrics"], last["metrics"]
        for name, e1 in m1.items():
            e0 = m0.get(name)
            kind = e1.get("type")
            if kind == "counter":
                base = e0["v"] if e0 and e0.get("type") == "counter" else 0
                delta = e1["v"] - base
                counters[name] = {"delta": delta,
                                  "rate_per_s": round(delta / dt, 4)}
            elif kind == "counter_family":
                prev = (e0 or {}).get("children", {}) \
                    if (e0 or {}).get("type") == "counter_family" else {}
                counters[name] = {
                    "children": {k: v - prev.get(k, 0)
                                 for k, v in e1["children"].items()},
                    "delta": sum(v - prev.get(k, 0)
                                 for k, v in e1["children"].items())}
            elif kind == "gauge":
                series = [s["metrics"][name]["v"] for s in snaps
                          if name in s["metrics"]]
                gauges[name] = {"first": series[0], "last": series[-1],
                                "min": min(series), "max": max(series)}
            elif kind == "gauge_family":
                fam_g: dict = {}
                for label in e1["children"]:
                    series = [s["metrics"][name]["children"][label]
                              for s in snaps
                              if label in (s["metrics"].get(name) or {})
                              .get("children", {})]
                    fam_g[label] = {"first": series[0],
                                    "last": series[-1],
                                    "min": min(series),
                                    "max": max(series)}
                gauges[name] = {"children": fam_g}
            elif kind == "hist":
                if e0 and e0.get("type") == "hist":
                    hists[name] = _window_hist(
                        e1["buckets"], e0["counts"], e1["counts"],
                        e0["n"], e1["n"], e0["sum"], e1["sum"])
                else:
                    hists[name] = _window_hist(
                        e1["buckets"], [0] * len(e1["counts"]),
                        e1["counts"], 0, e1["n"], 0.0, e1["sum"])
            elif kind == "hist_family":
                prev_children = (e0 or {}).get("children", {}) \
                    if (e0 or {}).get("type") == "hist_family" else {}
                fam: dict = {}
                for label, child in e1["children"].items():
                    p = prev_children.get(label)
                    if p is None:
                        p = {"counts": [0] * len(child["counts"]),
                             "n": 0, "sum": 0.0}
                    fam[label] = _window_hist(
                        child["buckets"], p["counts"], child["counts"],
                        p["n"], child["n"], p["sum"], child["sum"])
                hists[name] = {"children": fam}
        return {"snapshots": len(snaps), "window_s": round(dt, 3),
                "first_t": first["t"], "last_t": last["t"],
                "counters": counters, "gauges": gauges,
                "histograms": hists}


# ---- anomaly watchdog ------------------------------------------------------


def _counter_value(snap: dict, name: str) -> int:
    e = snap["metrics"].get(name)
    if e is None:
        return 0
    if e.get("type") == "counter":
        return int(e["v"])
    if e.get("type") == "counter_family":
        return int(sum(e["children"].values()))
    return 0


def _gauge_views(snap: dict, name: str) -> dict:
    """{series key: value} for one gauge metric in one snapshot — a
    plain gauge is one series, a labeled family one per child (so a
    multi-replica process's queues are watched independently instead
    of last-writer-wins interleaved)."""
    e = snap["metrics"].get(name)
    if e is None:
        return {}
    if e.get("type") == "gauge":
        return {name: float(e["v"])}
    if e.get("type") == "gauge_family":
        return {f"{name}{{{label}}}": float(v)
                for label, v in e["children"].items()}
    return {}


class Watchdog:
    """Anomaly rules over the snapshot ring. ``check()`` is pure over a
    snapshot list (deterministic, directly testable); ``evaluate()``
    evaluates the ring and fires the flight recorder — attaching the
    live profiler attribution so the dump carries *where CPU and lock
    wait were going* at the moment things went wrong. Repeat triggers
    are absorbed by the flight recorder's per-key cooldown."""

    #: histograms whose windowed p95 is regression-watched (labeled
    #: families are watched per child)
    WATCHED_HISTOGRAMS = ("sched_phase_ms", "bind_latency_ms",
                          "apf_queue_wait_ms")
    #: gauges watched for monotone growth
    WATCHED_QUEUE_GAUGES = ("sched_queue_depth", "bind_inflight")

    def __init__(self, flight: Optional[flight_mod.FlightRecorder] = None,
                 recent: int = 6, p95_factor: float = 2.0,
                 min_count: int = 30, reject_spike_min: int = 10,
                 spike_factor: float = 4.0, growth_len: int = 5,
                 queue_floor: float = 16.0, conflict_floor: int = 10,
                 profile_source: Optional[Callable[[], Optional[dict]]]
                 = None) -> None:
        self.flight = flight if flight is not None else flight_mod.FLIGHT
        self.recent = max(2, recent)
        self.p95_factor = p95_factor
        self.min_count = min_count
        self.reject_spike_min = reject_spike_min
        self.spike_factor = spike_factor
        self.growth_len = max(2, growth_len)
        self.queue_floor = queue_floor
        self.conflict_floor = conflict_floor
        self._profile_source = profile_source \
            if profile_source is not None \
            else profile_mod.current_attribution

    # -- rules (pure over a snapshot list) -----------------------------------

    def check(self, snaps: list) -> list:
        anomalies: list = []
        anomalies.extend(self._check_p95(snaps))
        anomalies.extend(self._check_queue_growth(snaps))
        anomalies.extend(self._check_reject_spike(snaps))
        anomalies.extend(self._check_conflict_streak(snaps))
        return anomalies

    def _hist_views(self, snap: dict) -> dict:
        """{watched histogram key: hist entry} — labeled families
        flattened to ``name{label}`` keys."""
        out: dict = {}
        for name in self.WATCHED_HISTOGRAMS:
            e = snap["metrics"].get(name)
            if e is None:
                continue
            if e.get("type") == "hist":
                out[name] = e
            elif e.get("type") == "hist_family":
                for label, child in e["children"].items():
                    out[f"{name}{{{label}}}"] = child
        return out

    def _check_p95(self, snaps: list) -> list:
        # recent window = last `recent` snapshots; trailing window = the
        # `recent` before them. Both need min_count observations.
        need = 2 * self.recent + 1
        if len(snaps) < need:
            return []
        s_old = snaps[-need]
        s_mid = snaps[-self.recent - 1]
        s_new = snaps[-1]
        old_v, mid_v, new_v = (self._hist_views(s) for s in
                               (s_old, s_mid, s_new))
        found: list = []
        for key, new_e in new_v.items():
            mid_e, old_e = mid_v.get(key), old_v.get(key)
            if mid_e is None or old_e is None:
                continue
            n_recent = new_e["n"] - mid_e["n"]
            n_trailing = mid_e["n"] - old_e["n"]
            if n_recent < self.min_count or n_trailing < self.min_count:
                continue
            p95_recent = _delta_percentile(
                new_e["buckets"], mid_e["counts"], new_e["counts"], 0.95)
            p95_trailing = _delta_percentile(
                mid_e["buckets"], old_e["counts"], mid_e["counts"], 0.95)
            if p95_trailing > 0 and \
                    p95_recent >= self.p95_factor * p95_trailing:
                found.append({
                    "rule": "p95_regression", "metric": key,
                    "p95_recent": round(p95_recent, 3),
                    "p95_trailing": round(p95_trailing, 3),
                    "factor": round(p95_recent / p95_trailing, 2),
                    "samples_recent": n_recent})
        return found

    def _check_queue_growth(self, snaps: list) -> list:
        if len(snaps) < self.growth_len:
            return []
        tail = snaps[-self.growth_len:]
        found: list = []
        for name in self.WATCHED_QUEUE_GAUGES:
            views = [_gauge_views(s, name) for s in tail]
            # a series key must exist in every tail snapshot to judge
            for key in sorted(views[-1]):
                if any(key not in v for v in views):
                    continue
                vals = [v[key] for v in views]
                if vals[-1] < self.queue_floor:
                    continue
                if all(b > a for a, b in zip(vals, vals[1:])):
                    found.append({"rule": "queue_growth", "metric": key,
                                  "series": vals})
        return found

    def _check_reject_spike(self, snaps: list) -> list:
        if len(snaps) < 3:
            return []
        deltas = [
            _counter_value(b, "apf_rejects_total")
            - _counter_value(a, "apf_rejects_total")
            for a, b in zip(snaps, snaps[1:])]
        last = deltas[-1]
        if last < self.reject_spike_min:
            return []
        trailing = deltas[:-1]
        trailing_mean = sum(trailing) / len(trailing)
        if last >= self.spike_factor * max(trailing_mean, 1.0):
            return [{"rule": "apf_reject_spike",
                     "metric": "apf_rejects_total",
                     "delta": last,
                     "trailing_mean": round(trailing_mean, 2)}]
        return []

    def _check_conflict_streak(self, snaps: list) -> list:
        if len(snaps) < self.growth_len:
            return []
        tail = snaps[-self.growth_len:]
        deltas = [
            _counter_value(b, "sched_conflicts_total")
            - _counter_value(a, "sched_conflicts_total")
            for a, b in zip(tail, tail[1:])]
        if all(d > 0 for d in deltas) and \
                sum(deltas) >= self.conflict_floor:
            return [{"rule": "conflict_streak",
                     "metric": "sched_conflicts_total",
                     "deltas": deltas}]
        return []

    # -- firing --------------------------------------------------------------

    def evaluate(self, series: MetricsTimeSeries) -> list:
        """Evaluate the ring; every anomaly triggers one flight dump
        (named ``evaluate``, not ``observe``: the hot-path purity
        rule's call graph is name-based, and ``Histogram.observe`` IS
        on the hot path — a shared name would drag the watchdog into
        the fit closure's blocker inventory)
        (per-key cooldown in the recorder) with the current profile
        attribution attached. Returns the anomalies found."""
        anomalies = self.check(series.snapshots())
        for a in anomalies:
            detail = dict(a)
            profile = self._profile_source()
            if profile is not None:
                detail["profile"] = profile
            self.flight.trigger(f"watchdog_{a['rule']}",
                                key=a.get("metric", ""), **detail)
        return anomalies


# ---- process-global series + route payloads --------------------------------

_active_lock = threading.Lock()
ACTIVE: Optional[MetricsTimeSeries] = None


def start_timeseries(interval_s: float = DEFAULT_INTERVAL_S,
                     capacity: int = DEFAULT_CAPACITY,
                     watchdog: Optional[Watchdog] = None) \
        -> MetricsTimeSeries:
    """Start (or return) the process-global snapshot loop."""
    global ACTIVE
    with _active_lock:
        if ACTIVE is None:
            ACTIVE = MetricsTimeSeries(interval_s, capacity,
                                       watchdog=watchdog).start()
        return ACTIVE


def stop_timeseries() -> None:
    global ACTIVE
    with _active_lock:
        series, ACTIVE = ACTIVE, None
    if series is not None:
        series.stop()


def metrics_history(window_s: float = 300.0, limit: int = 0) -> dict:
    """The ``/metrics/history`` payload (``serve_health`` serves it): the
    windowed summary plus, with
    ``limit > 0``, the most recent raw snapshots."""
    series = ACTIVE
    if series is None:
        return {"active": False,
                "note": "metrics time-series not running (start with "
                        "--metrics-interval-s)"}
    out: dict = {"active": True, "interval_s": series.interval_s,
                 "snapshots": len(series.snapshots()),
                 "window": series.window(window_s)}
    if limit > 0:
        out["series"] = series.snapshots()[-limit:]
    return out
