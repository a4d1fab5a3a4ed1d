"""The serving metrics: a minimal copy of ``kubegpu_tpu/metrics.py``.

Only what the serving path reads: the exponential-bucket ``Histogram``,
the settable ``Gauge``, the four serving metrics (time to first token,
inter-token latency, queue depth, slot utilization) and their Prometheus
exposition, which the node agent serves on ``/metrics``.
"""

from __future__ import annotations

import threading


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

    def reset(self) -> None:
        with self._lock:
            self.value = 0


SERVE_TTFT_MS = Histogram("serve_ttft_ms", start_us=0.25)
SERVE_ITL_MS = Histogram("serve_itl_ms", start_us=0.01)
SERVE_QUEUE_DEPTH = Gauge("serve_queue_depth")
SERVE_SLOT_UTILIZATION = Gauge("serve_slot_utilization")  # 0..1 ratio

_ALL = (SERVE_TTFT_MS, SERVE_ITL_MS, SERVE_QUEUE_DEPTH,
        SERVE_SLOT_UTILIZATION)


def reset_all() -> None:
    for m in _ALL:
        m.reset()


def prometheus_text() -> str:
    """Every metric above in Prometheus exposition format."""
    lines = []
    for m in _ALL:
        if isinstance(m, Histogram):
            lines.append(f"# TYPE {m.name} histogram")
            with m._lock:
                cumulative = 0
                for bound, count in zip(m.buckets, m.counts):
                    cumulative += count
                    lines.append(f'{m.name}_bucket{{le="{bound:g}"}} '
                                 f"{cumulative}")
                lines.append(f'{m.name}_bucket{{le="+Inf"}} {m.n}')
                lines.append(f"{m.name}_sum {m.total:.6g}")
                lines.append(f"{m.name}_count {m.n}")
        else:
            lines.append(f"# TYPE {m.name} gauge")
            lines.append(f"{m.name} {m.value}")
    return "\n".join(lines) + "\n"
