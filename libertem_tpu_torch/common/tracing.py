"""Tracing hooks (counterpart of ``libertem_tpu/common/tracing.py``).

Spans are exported only when ``LIBERTEM_TPU_TRACING_URL`` (or the
``otlp_url`` argument) names an OTLP endpoint and the OpenTelemetry
SDK imports; otherwise :func:`get_tracer` gives OpenTelemetry's API
tracer where the API imports (a no-op without a provider), else a
tracer of this module whose spans do nothing.
"""
from __future__ import annotations

import contextlib
import logging
import os

log = logging.getLogger(__name__)

_TRACER = None
_TRACING_ACTIVE = False


class _NoopSpan:
    def set_attribute(self, *a, **kw):
        pass

    def add_event(self, *a, **kw):
        pass

    def record_exception(self, *a, **kw):
        pass


class _NoopTracer:
    @contextlib.contextmanager
    def start_as_current_span(self, name, **kwargs):
        yield _NoopSpan()


def get_tracer(name: str = "libertem_tpu_torch"):
    global _TRACER
    if _TRACER is not None:
        return _TRACER
    try:
        from opentelemetry import trace
        _TRACER = trace.get_tracer(name)
    except ImportError:
        _TRACER = _NoopTracer()
    return _TRACER


def maybe_setup_tracing(service_name: str,
                        otlp_url: str | None = None) -> bool:
    """Export spans over OTLP when an endpoint is configured and the
    OpenTelemetry SDK is installed; True when tracing is active.
    Idempotent: every Context construction calls it."""
    url = otlp_url or os.environ.get("LIBERTEM_TPU_TRACING_URL")
    if not url:
        return False
    global _TRACING_ACTIVE, _TRACER
    if _TRACING_ACTIVE:
        return True
    try:
        from opentelemetry import trace
        from opentelemetry.exporter.otlp.proto.grpc.trace_exporter import (
            OTLPSpanExporter,
        )
        from opentelemetry.sdk.resources import Resource
        from opentelemetry.sdk.trace import TracerProvider
        from opentelemetry.sdk.trace.export import BatchSpanProcessor
    except ImportError:
        log.warning("tracing requested but opentelemetry is not installed")
        return False
    provider = TracerProvider(resource=Resource.create({
        "service.name": service_name,
    }))
    provider.add_span_processor(
        BatchSpanProcessor(OTLPSpanExporter(endpoint=url)))
    trace.set_tracer_provider(provider)
    _TRACER = trace.get_tracer("libertem_tpu_torch")
    _TRACING_ACTIVE = True
    return True
