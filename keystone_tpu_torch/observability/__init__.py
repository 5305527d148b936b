"""Telemetry of the port: the metrics registry and its scrape surface.

Counterpart of part of ``keystone_tpu/observability``: ``metrics.py``
(counters, gauges, histograms, Prometheus text) and the HTTP handler of
``sampler.py``. Spans, the sampler thread, post-mortems and the
numerics plane come later (ROADMAP A9).
"""
from .metrics import Counter, Gauge, Histogram, MetricsRegistry

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]
