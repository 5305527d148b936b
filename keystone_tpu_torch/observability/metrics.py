"""Process-wide metrics: counters, gauges and histograms.

Counterpart of ``keystone_tpu/observability/metrics.py``. An update is
a dict lookup plus a locked float add, cheap enough for per-batch hot
paths. Metrics are fed from several threads (the serving worker, HTTP
handler threads, callers), so every read-modify-write takes a plain
``threading.Lock``.
"""
from __future__ import annotations

import contextlib
import re
import threading
import time
import warnings
from typing import Dict, Iterator, List, Optional

from ..utils.guarded import guarded_by


@guarded_by("_lock", "value")
class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class Gauge:
    """Last-written value (a plain overwrite: last writer wins)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


@guarded_by("_lock", "count", "total", "min", "max", "_tail")
class Histogram:
    """Streaming count / total / min / max plus a bounded tail of the
    most recent ``TAIL`` observations for percentiles, so a long-lived
    process never grows it."""

    __slots__ = ("name", "count", "total", "min", "max", "_tail", "_lock")

    TAIL = 256

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self._tail: List[float] = []
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            self.total += value
            if value < self.min:
                self.min = value
            if value > self.max:
                self.max = value
            self._tail.append(value)
            if len(self._tail) > self.TAIL:
                del self._tail[: len(self._tail) - self.TAIL]

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the retained tail (the most
        recent ``TAIL`` observations), 0 <= q <= 100."""
        with self._lock:
            tail = list(self._tail)
        if not tail:
            return 0.0
        ordered = sorted(tail)
        idx = min(len(ordered) - 1,
                  max(0, int(round(q / 100.0 * (len(ordered) - 1)))))
        return ordered[idx]

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            if not self.count:
                return {"count": 0, "total": 0.0, "mean": 0.0,
                        "min": 0.0, "max": 0.0}
            count, total = self.count, self.total
            lo, hi = self.min, self.max
        return {"count": count, "total": total, "mean": total / count,
                "min": lo, "max": hi,
                "p50": self.percentile(50), "p99": self.percentile(99)}


#: guards the singleton create (a worker thread's first metric may race
#: the main thread's)
_REGISTRY_LOCK = threading.Lock()


@guarded_by("_lock", "_counters", "_gauges", "_histograms")
class MetricsRegistry:
    """Process-wide named metrics (``MetricsRegistry.get_or_create()``).
    The lazy per-name creates are double-checked under a lock."""

    _instance: Optional["MetricsRegistry"] = None

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    @classmethod
    def get_or_create(cls) -> "MetricsRegistry":
        inst = cls._instance
        if inst is None:
            with _REGISTRY_LOCK:
                inst = cls._instance
                if inst is None:
                    inst = cls._instance = MetricsRegistry()
        return inst

    @classmethod
    def reset(cls) -> None:
        """Drop the global registry (tests)."""
        with _REGISTRY_LOCK:
            cls._instance = None

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, Counter, name)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, Gauge, name)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, Histogram, name)

    def _get(self, table, cls, name):
        m = table.get(name)
        if m is None:
            with self._lock:
                m = table.get(name)
                if m is None:
                    m = table[name] = cls(name)
        return m

    def snapshot(self) -> Dict[str, Dict]:
        # copy the maps under the lock before iterating: a concurrent
        # first-use create would otherwise resize a dict mid-iteration
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.value for k, c in sorted(counters.items())},
            "gauges": {k: g.value for k, g in sorted(gauges.items())},
            "histograms": {
                k: h.snapshot() for k, h in sorted(histograms.items())
            },
        }

    def to_prometheus(self) -> str:
        """The registry as Prometheus text exposition (format 0.0.4):
        counters and gauges one sample each, histograms as summaries
        (``_count`` / ``_sum`` plus p50 / p99 quantile samples from the
        retained tail). Names are namespaced ``keystone_`` with every
        character outside the Prometheus set (dots included) mapped to
        ``_``; counters gain ``_total``."""
        snap = self.snapshot()
        lines: List[str] = []
        for name, value in snap["counters"].items():
            n = _prometheus_name(name) + "_total"
            lines.append(f"# TYPE {n} counter")
            lines.append(f"{n} {_prometheus_value(value)}")
        for name, value in snap["gauges"].items():
            n = _prometheus_name(name)
            lines.append(f"# TYPE {n} gauge")
            lines.append(f"{n} {_prometheus_value(value)}")
        for name, h in snap["histograms"].items():
            n = _prometheus_name(name)
            lines.append(f"# TYPE {n} summary")
            for q, key in (("0.5", "p50"), ("0.99", "p99")):
                lines.append(f'{n}{{quantile="{q}"}} '
                             f"{_prometheus_value(h.get(key, 0.0))}")
            lines.append(f"{n}_sum {_prometheus_value(h['total'])}")
            lines.append(f"{n}_count {int(h['count'])}")
        return "\n".join(lines) + "\n"


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prometheus_name(name: str) -> str:
    return "keystone_" + _PROM_BAD.sub("_", name)


def _prometheus_value(value: float) -> str:
    v = float(value)
    if v != v or v in (float("inf"), float("-inf")):
        # the exposition has NaN / +Inf / -Inf literals; a non-finite
        # gauge must not break the scrape
        return "NaN" if v != v else ("+Inf" if v > 0 else "-Inf")
    return str(int(v)) if v == int(v) and abs(v) < 1e15 else repr(v)


class StepTimer:
    """DEPRECATED wall-clock step timing, kept API-compatible with the JAX
    package's (constructing one warns, as there). Use
    ``MetricsRegistry.get_or_create().timer(name)`` instead: the samples
    land in the process histograms (p50/p99, Prometheus exposition)
    instead of a private dict. ``timed(name, fn, ...)`` waits for the
    CUDA device before it reads the clock, as the JAX package blocks on
    the result; ``step(name)`` times the block as it is."""

    def __init__(self) -> None:
        warnings.warn(
            "StepTimer is deprecated; use MetricsRegistry.get_or_create()"
            ".timer(name) (observability/metrics.py): the same block-style "
            "timing, recorded into the process histograms",
            DeprecationWarning, stacklevel=2)
        self.times: Dict[str, list] = {}

    @contextlib.contextmanager
    def step(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def timed(self, name: str, fn, *args, **kwargs):
        import torch

        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def summary(self) -> str:
        lines = []
        for name, ts in self.times.items():
            lines.append(
                f"{name}: n={len(ts)} mean={sum(ts)/len(ts)*1e3:.2f}ms "
                f"min={min(ts)*1e3:.2f}ms max={max(ts)*1e3:.2f}ms")
        return "\n".join(lines)
