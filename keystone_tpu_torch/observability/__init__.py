"""Telemetry of the port.

Counterpart of ``keystone_tpu/observability``: ``metrics.py`` (counters,
gauges, histograms, Prometheus text), ``names.py`` (the metric-name
catalogue), ``timeline.py`` (the flight recorder and its Chrome trace),
``trace.py`` (``PipelineTrace``), ``postmortem.py``, ``numerics.py`` (the
data-health plane) and ``sampler.py`` (``TelemetrySampler`` and the
scrape handler). ``compilelog.py``, ``utilization.py`` and
``benchdiff.py`` come later (ROADMAP A9b).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
