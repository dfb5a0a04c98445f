"""Spans of the port's runs (counterpart of
``libertem_tpu/common/tracing.py``).

:func:`span` marks a named stretch of the program.  It feeds three
sinks:

* the torch profiler: while one records
  (``torch.autograd.profiler._is_profiler_enabled``), a span is a
  record function of its name (``_RecordFunctionFast``, a ``cpu_op``
  event in the trace, where torch has it; else ``record_function``, a
  ``user_annotation``), on the profiler's clock, which Kineto aligns
  with the card's kernels and copies.  The fast form costs ~2 us a
  span against ~12 us, and keeps the interpreter lock, so a span's end
  never waits for the lock behind the readers' threads;
* OpenTelemetry: once :func:`maybe_setup_tracing` has turned export on
  (``LIBERTEM_TPU_TRACING_URL``, or the ``otlp_url`` argument, names an
  OTLP endpoint and the SDK imports), the run-level spans of
  ``RUN_SPANS`` go to :func:`get_tracer`'s tracer, with attributes
  (frames, bytes, super-steps, workers, the UDF classes); the spans of
  a block never do;
* a run's totals: a span given a ``totals`` dict adds ``[count,
  seconds]`` (``time.perf_counter``) under its name there.  The
  consumer thread's spans of a run do (:class:`RunTrace`), and the run
  hands them on as ``feed_stats["spans"]``.

With no profiler recording and no export, a span reads one flag and the
clock twice; with no totals either, it is one shared no-op.

The spans of a run (``udf/base.py`` but where named):

consumer thread (the thread that iterates the run)
  ``libertem.run`` the whole pass, from the call to the cleanup;
  ``libertem.prepare`` plans, masks, the CoMUDF probe;
  ``libertem.shard_plan`` the multi-device loop's shards, each worker's
  blocks and the super-steps; ``libertem.open`` the loop's state, the
  feeds and their pinned slots, the hooks' instances, the readers' pool
  and thread's start; ``libertem.hooks`` ``preprocess`` and
  ``postprocess``; ``libertem.super_step`` one super-step of the
  multi-device loop, from its feed wait to its slots' release, with the
  loop's own work between its parts; ``libertem.feed_wait`` waiting for
  the next blocks; ``libertem.step`` one worker's block, ``take()``
  through the fused or generic step; ``libertem.fused_moments`` the
  fused step's call of ``ops/moments.py``'s ``fused_moments`` (the
  kernel, in whatever form runs it); ``libertem.state_update`` the fused
  step's updates of the UDFs' state; ``libertem.host_step`` the host
  engine; ``libertem.release`` the blocks' slots handed back to the
  readers; ``libertem.fold`` the workers' (or a partition's) partials
  folded into one state; ``libertem.wrap`` the results to the host and
  ``get_results``; ``libertem.close`` joining the readers and releasing
  the feeds.
reader threads
  ``libertem.read`` a block into its pinned slot; ``libertem.slot_wait``
  waiting for a free slot; ``libertem.h2d`` the copy's launch.
any thread
  ``libertem.kernel_build`` an ``nvcc`` or ``g++`` build
  (``ops/build.py``), never a cached library.

To see the spans: run under ``torch.profiler.profile(...)`` (the
readers' spans need ``experimental_config=torch._C._profiler.
_ExperimentalConfig(profile_all_threads=True)``, which records every
thread), or install the ``tracing`` extra and set
``LIBERTEM_TPU_TRACING_URL`` for the run-level spans over OTLP.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time

import torch
import torch.autograd.profiler as _profiler

log = logging.getLogger(__name__)

_TRACER = None
_TRACING_ACTIVE = False

# the spans that go to OpenTelemetry (once export is on)
RUN_SPANS = frozenset({
    "libertem.run", "libertem.prepare", "libertem.fold", "libertem.wrap",
    "libertem.kernel_build",
})


# a record function of the profiler: the C++ one where torch has it
_record = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
           or _profiler.record_function)


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


class Span:
    """One span (:func:`span`); ``seconds`` is its length once it has
    ended."""

    __slots__ = ("name", "seconds", "_totals", "_profile", "_attrs",
                 "_rf", "_otel", "_otel_span", "_t0")

    def __init__(self, name: str, totals, profile: bool, attrs):
        self.name = name
        self._totals = totals
        self._profile = profile
        self._attrs = attrs
        self._rf = self._otel = self._otel_span = None

    def __enter__(self) -> "Span":
        if self._profile:
            self._rf = _record(self.name)
            self._rf.__enter__()
        if self._attrs is not None:
            self._otel = get_tracer().start_as_current_span(
                self.name, attributes=self._attrs)
            self._otel_span = self._otel.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = seconds = time.perf_counter() - self._t0
        totals = self._totals
        if totals is not None:
            entry = totals.get(self.name)
            if entry is None:
                totals[self.name] = [1, seconds]
            else:
                entry[0] += 1
                entry[1] += seconds
        if self._otel is not None:
            self._otel.__exit__(*exc)
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False

    def set_attributes(self, **attrs) -> None:
        """More attributes of the exported span (none without one)."""
        if self._otel_span is not None:
            for key, value in attrs.items():
                self._otel_span.set_attribute(key, value)


class _NoSpan:
    """The span that records nothing (:data:`NOOP`)."""

    __slots__ = ()
    name = None
    seconds = 0.0

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set_attributes(self, **attrs) -> None:
        pass


NOOP = _NoSpan()


def span(name: str, totals: dict | None = None, timed: bool = False,
         **attrs):
    """A context manager marking ``name``: a record function while
    the torch profiler records, an OpenTelemetry span (with ``attrs``)
    where export is on and ``name`` is in :data:`RUN_SPANS`, and
    ``[count, seconds]`` added under ``name`` in ``totals`` where
    given.  ``timed``: the caller reads the span's ``seconds``.  With
    none of these, the shared :data:`NOOP`."""
    profile = _profiler._is_profiler_enabled
    export = _TRACING_ACTIVE and name in RUN_SPANS
    if not (profile or export or timed or totals is not None):
        return NOOP
    return Span(name, totals, profile, attrs if export else None)


class RunTrace:
    """One run's spans: the consumer thread's totals (``spans``, ``{name:
    [count, seconds]}``), handed on as ``feed_stats["spans"]``, and the
    run's own span (``run``), for attributes known later."""

    def __init__(self):
        self.spans: dict = {}
        self.run = NOOP

    def span(self, name: str, timed: bool = False, **attrs):
        """:func:`span` adding into this run's totals."""
        return span(name, self.spans, timed, **attrs)
