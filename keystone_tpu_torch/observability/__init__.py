"""Telemetry of the port.

Counterpart of ``keystone_tpu/observability``: ``metrics.py`` (counters,
gauges, histograms, Prometheus text), ``names.py`` (the metric-name
catalogue), ``timeline.py`` (the flight recorder and its Chrome trace),
``trace.py`` (``PipelineTrace``), ``postmortem.py``, ``numerics.py`` (the
data-health plane), ``sampler.py`` (``TelemetrySampler`` and the
scrape handler), ``compilelog.py`` (the capture observatory and its
fence), ``reqtrace.py`` (request traces and the exemplar reservoir)
and ``slo.py`` (the SLO tracker). ``utilization.py`` and
``benchdiff.py`` come later (ROADMAP A9b).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
