"""Observability for the port: the monotonic clock, the phase tracer, the
metrics registry and the round-time breakdown — copies of ``repro.obs``'s
modules, so that the port records the reference's span and metric names."""

from repro_torch.obs.clock import monotonic
from repro_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Series,
    merge_histograms,
)
from repro_torch.obs.report import breakdown_report, phase_breakdown
from repro_torch.obs.trace import NOOP_SPAN, NULL_TRACER, Span, Tracer

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NOOP_SPAN",
    "NULL_TRACER",
    "Series",
    "Span",
    "Tracer",
    "breakdown_report",
    "merge_histograms",
    "monotonic",
    "phase_breakdown",
]
