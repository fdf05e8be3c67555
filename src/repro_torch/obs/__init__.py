"""Deterministic observability: Clock-timed spans, fixed-bucket latency
histograms and a structured event stream (the ported part of
``repro.obs``; the export surfaces come later)."""

from repro_torch.obs.hist import HistogramSet, LatencyHistogram
from repro_torch.obs.trace import (NULL_SPAN, Event, Span, TraceRecorder,
                                   check_span_accounting, coverage_fraction,
                                   span_accounting)

__all__ = [
    "Event", "HistogramSet", "LatencyHistogram", "NULL_SPAN", "Span",
    "TraceRecorder", "check_span_accounting", "coverage_fraction",
    "span_accounting",
]
