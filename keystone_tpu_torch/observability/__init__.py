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
bench-regression gate).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
