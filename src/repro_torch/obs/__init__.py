"""Observability for the port: the monotonic clock and the phase tracer,
copies of ``repro.obs.clock`` and ``repro.obs.trace`` so that the port's
engine records the reference's span names."""

from repro_torch.obs.clock import monotonic
from repro_torch.obs.trace import NOOP_SPAN, NULL_TRACER, Span, Tracer

__all__ = ["NOOP_SPAN", "NULL_TRACER", "Span", "Tracer", "monotonic"]
