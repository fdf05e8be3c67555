"""Deterministic observability: Clock-timed spans, fixed-bucket latency
histograms, a structured event stream and the export surfaces
(``prometheus_text``, ``telemetry_report``): the ported ``repro.obs``."""

from repro_torch.obs.export import prometheus_text, telemetry_report
from repro_torch.obs.hist import HistogramSet, LatencyHistogram
from repro_torch.obs.trace import (NULL_SPAN, Event, Span, TraceRecorder,
                                   check_span_accounting, coverage_fraction,
                                   span_accounting)

__all__ = [
    "Event", "HistogramSet", "LatencyHistogram", "NULL_SPAN", "Span",
    "TraceRecorder", "check_span_accounting", "coverage_fraction",
    "prometheus_text", "span_accounting", "telemetry_report",
]
