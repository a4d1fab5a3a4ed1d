"""Observability (the port's copy of ``kubegpu_tpu/obs/``): distributed
scheduling traces, the anomaly flight recorder, the continuous sampling
profiler and the metrics time-series.

See ``obs/trace.py`` (spans, propagation, export), ``obs/flight.py``
(dump on anomaly), ``obs/profile.py`` (sampling profiler: CPU and
lock-wait attribution by thread role and scheduling phase),
``obs/timeseries.py`` (a bounded ring of metric snapshots, windowed
queries, the anomaly watchdog) and ``obs/validate.py`` (the trace-file
check)."""

from kubegpu_tpu_torch.obs.trace import (RECORDER, TRACE_HEADER,  # noqa: F401
                                         Span, SpanRecorder, batch_context,
                                         chrome_trace, current, event,
                                         explain_pod, header_value,
                                         parent_for, record_span,
                                         remote_context, span, start_span,
                                         trace_id_for_pod, wall_now,
                                         write_trace)
from kubegpu_tpu_torch.obs.flight import FLIGHT, FlightRecorder  # noqa: F401
from kubegpu_tpu_torch.obs.profile import (Sampler,  # noqa: F401
                                           current_attribution,
                                           profile_status, register_thread,
                                           start_profiler, stop_profiler)
from kubegpu_tpu_torch.obs.timeseries import (  # noqa: F401
    MetricsTimeSeries, Watchdog, metrics_history, snapshot_metrics,
    start_timeseries, stop_timeseries)
