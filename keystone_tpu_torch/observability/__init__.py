"""Telemetry of the port.

Counterpart of ``keystone_tpu/observability``: ``metrics.py`` (counters,
gauges, histograms, Prometheus text), ``names.py`` (the metric-name
catalogue), ``timeline.py`` (the flight recorder and its Chrome trace),
``trace.py`` (``PipelineTrace``), ``postmortem.py``, ``numerics.py`` (the
data-health plane), ``sampler.py`` (``TelemetrySampler`` and the
scrape handler), ``compilelog.py`` (the capture observatory and its
fence, and its per-site table), ``reqtrace.py`` (request traces and the
exemplar reservoir), ``slo.py`` (the SLO tracker), ``utilization.py``
(MFU and the roofline from counted work) and ``benchdiff.py`` (the
bench-regression gate). The JAX package's jit helpers ``observed_jit``
and ``watch_jit`` have no counterpart: the port compiles no programs,
and ``observed_capture`` is the capture observatory's site.
"""
from .compilelog import (
    CompileObservatory,
    compile_context,
    compile_observatory,
    expect_no_compiles,
    reset_compile_observatory,
)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, StepTimer
from .numerics import (
    DriftBaseline,
    NumericsError,
    health_word,
    numerics_enabled,
    numerics_suppressed,
    record_numerics_event,
    score_drift,
)
from .postmortem import attach_postmortem, dump_postmortem
from .reqtrace import (
    ExemplarReservoir,
    ReqTrace,
    exemplar_reservoir,
    reset_exemplars,
    tracing_active,
    tracing_suppressed,
)
from .sampler import TelemetrySampler, serve_metrics
from .slo import SloPolicy, SloTracker, SloViolation, record_slo_event
from .timeline import (
    FlightRecorder,
    flight_recorder,
    record_span,
    write_trace_artifact,
)
from .trace import (
    NodeRecord,
    PipelineTrace,
    current_trace,
    xprof_trace,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "StepTimer",
    "NodeRecord",
    "PipelineTrace",
    "current_trace",
    "xprof_trace",
    "FlightRecorder",
    "flight_recorder",
    "record_span",
    "write_trace_artifact",
    "TelemetrySampler",
    "serve_metrics",
    "attach_postmortem",
    "dump_postmortem",
    "CompileObservatory",
    "compile_context",
    "compile_observatory",
    "expect_no_compiles",
    "reset_compile_observatory",
    "ExemplarReservoir",
    "ReqTrace",
    "exemplar_reservoir",
    "reset_exemplars",
    "tracing_active",
    "tracing_suppressed",
    "SloPolicy",
    "SloTracker",
    "SloViolation",
    "record_slo_event",
    "DriftBaseline",
    "NumericsError",
    "health_word",
    "numerics_enabled",
    "numerics_suppressed",
    "record_numerics_event",
    "score_drift",
]
