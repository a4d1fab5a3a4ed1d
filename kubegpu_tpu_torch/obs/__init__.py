"""Observability: distributed scheduling traces (the port's copy of
``kubegpu_tpu/obs/``'s tracing half).

See ``obs/trace.py`` (spans, propagation, export). The scheduling engine
records its phases here (``span``, ``event``, ``start_span``)."""

from kubegpu_tpu_torch.obs.trace import (RECORDER, TRACE_HEADER,  # noqa: F401
                                         Span, SpanRecorder, batch_context,
                                         chrome_trace, current, event,
                                         explain_pod, header_value,
                                         parent_for, record_span,
                                         remote_context, span, start_span,
                                         trace_id_for_pod, wall_now,
                                         write_trace)
