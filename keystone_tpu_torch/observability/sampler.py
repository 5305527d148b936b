"""Background telemetry sampler and the HTTP scrape surface.

Counterpart of ``keystone_tpu/observability/sampler.py``:

* :class:`TelemetrySampler`, a daemon thread that every ``interval_s``
  snapshots every registry counter and gauge plus a set of probes into
  bounded time series (``capacity`` points each). Probe values are also
  published back into the registry as gauges, so the scrape surface
  serves them too. The probes carry the JAX ones' meaning on the port:
  ``process.rss_bytes`` (``/proc/self/statm``), ``numerics.health_age_s``
  (seconds since the numerics plane last read a health word) and
  ``streaming.stage_queue_depth`` (chunks staged and waiting in the live
  streams' queues, in the place of the JAX package's H2D pool queue).
  The port adds ``prefix.memo_bytes`` and ``prefix.memo_entries``: the
  device bytes and the count of the computed values the prefix memo
  (``PipelineEnv.state``) holds, which grow by every ``fitted.apply``
  call's cached features until ``clear_state()``; read from the
  sampler's thread, with nothing on the executor's path.
  ``start`` and ``stop`` are idempotent and a stopped sampler can start
  again; a probe that raises is skipped for that tick.
* ``GET /metrics`` and ``GET /healthz``: the handler and server below,
  which the serving plane's HTTP surface (``serving/http.py``) extends.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Deque, Dict, List, Optional, Tuple

from ..utils.guarded import guarded_by
from .metrics import MetricsRegistry


def _rss_bytes() -> float:
    """Current resident set size (``/proc/self/statm``); elsewhere the
    peak from ``getrusage``, better than a dead probe."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        import resource
        import sys

        raw = float(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        return raw if sys.platform == "darwin" else raw * 1024.0


def _numerics_health_age_s() -> float:
    from .numerics import last_health_age_s

    return last_health_age_s()


def _stage_queue_depth() -> float:
    from ..parallel.streaming import staged_queue_depth

    return float(staged_queue_depth())


def _memo_values() -> list:
    """The computed values in the prefix memo (none before the process's
    first pipeline)."""
    from ..workflow.env import PipelineEnv

    env = PipelineEnv._instance
    if env is None:
        return []
    return [e.get() for e in list(env.state.values()) if e.computed]


def _prefix_memo_bytes() -> float:
    from ..parallel.dataset import device_nbytes

    return float(sum(device_nbytes(v) for v in _memo_values()))


def _prefix_memo_entries() -> float:
    return float(len(_memo_values()))


#: probes installed on every sampler (name -> zero-argument float fn)
DEFAULT_PROBES: Dict[str, Callable[[], float]] = {
    "process.rss_bytes": _rss_bytes,
    "numerics.health_age_s": _numerics_health_age_s,
    "streaming.stage_queue_depth": _stage_queue_depth,
    "prefix.memo_bytes": _prefix_memo_bytes,
    "prefix.memo_entries": _prefix_memo_entries,
}


@guarded_by("_lock", "_series", "_probes")
class TelemetrySampler:
    """Interval sampler of registry scalars and probes into bounded time
    series::

        sampler = TelemetrySampler(interval_s=0.1).start()
        ...
        sampler.stop()
        rss = sampler.series("process.rss_bytes")   # [(t, value), ...]
    """

    def __init__(self, interval_s: float = 0.5, capacity: int = 512,
                 registry: Optional[MetricsRegistry] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._registry = registry
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}
        self._probes: Dict[str, Callable[[], float]] = dict(DEFAULT_PROBES)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add_probe(self, name: str, fn: Callable[[], float]) -> None:
        """Register another sampled value (a zero-argument callable)."""
        with self._lock:
            self._probes[name] = fn

    def sample_once(self) -> Dict[str, float]:
        """One tick (also usable without the thread); the values taken."""
        reg = self._registry or MetricsRegistry.get_or_create()
        with self._lock:
            probes = list(self._probes.items())
        values: Dict[str, float] = {}
        for name, fn in probes:
            try:
                v = float(fn())
            except Exception:
                continue  # a broken probe must not kill the sampler
            values[name] = v
            reg.gauge(name).set(v)
        snap = reg.snapshot()
        for name, v in snap["gauges"].items():
            values.setdefault(name, float(v))
        for name, v in snap["counters"].items():
            values[name] = float(v)
        now = time.time()
        with self._lock:
            for name, v in values.items():
                series = self._series.get(name)
                if series is None:
                    series = self._series[name] = deque(maxlen=self.capacity)
                series.append((now, v))
        return values

    def _loop(self, stop: threading.Event) -> None:
        # wait first, outside any lock: stop() wakes it at once
        while not stop.wait(self.interval_s):
            self.sample_once()

    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> "TelemetrySampler":
        """Start the sampling thread (a no-op when running)."""
        with self._lock:
            if self._thread is not None:
                return self
            stop = self._stop = threading.Event()
            t = threading.Thread(target=self._loop, args=(stop,),
                                 name="keystone-torch-telemetry-sampler",
                                 daemon=True)
            self._thread = t
            t.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop and join the sampling thread (a no-op when stopped)."""
        with self._lock:
            t = self._thread
            self._thread = None
            self._stop.set()
        if t is not None:
            t.join(timeout=timeout)

    def series(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            return list(self._series.get(name, ()))

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self) -> Dict[str, List[Tuple[float, float]]]:
        """Every series' retained points, copied under the lock."""
        with self._lock:
            return {k: list(v) for k, v in sorted(self._series.items())}


class _MetricsHandler(BaseHTTPRequestHandler):
    registry: Optional[MetricsRegistry] = None
    #: zero-argument readiness probe (None = always ready). With a probe
    #: ``/healthz`` is a readiness gate: 503 "warming" until the probe
    #: returns True. A probe that raises reports not-ready (fail closed).
    ready_probe: Optional[Callable[[], bool]] = None

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        path = self.path.split("?")[0]
        if path == "/healthz":
            probe = type(self).ready_probe
            ready = True
            if probe is not None:
                try:
                    ready = bool(probe())
                except Exception:  # noqa: BLE001 - fail closed, see above
                    ready = False
            status, body = (200, b"ok\n") if ready else (503, b"warming\n")
            ctype = "text/plain; charset=utf-8"
        elif path == "/metrics":
            reg = self.registry or MetricsRegistry.get_or_create()
            status, body = 200, reg.to_prometheus().encode()
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # scrapes must not spam stderr
        pass


class _MetricsServer(ThreadingHTTPServer):
    daemon_threads = True
    _keystone_thread: Optional[threading.Thread] = None

    def shutdown(self) -> None:
        """Stop the serve loop, join its thread and close the listening
        socket (the stdlib ``shutdown`` leaves the port bound)."""
        super().shutdown()
        t = self._keystone_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
        self.server_close()


def serve_metrics(port: int = 0, host: str = "127.0.0.1",
                  registry: Optional[MetricsRegistry] = None,
                  ready_probe: Optional[Callable[[], bool]] = None
                  ) -> ThreadingHTTPServer:
    """Serve ``GET /metrics`` (Prometheus text exposition of the process
    registry) and ``GET /healthz`` on ``host:port`` from a daemon thread.
    ``port=0`` binds an ephemeral port (read it back from
    ``server.server_port``). Returns the server; ``.shutdown()`` stops
    it, joins the serve thread and releases the port. ``ready_probe``
    (zero arguments -> bool) makes ``/healthz`` a readiness gate: 503
    until it returns True; without one the endpoint is a liveness
    ping."""
    handler = type("_BoundMetricsHandler", (_MetricsHandler,),
                   {"registry": registry,
                    "ready_probe": (staticmethod(ready_probe)
                                    if ready_probe is not None else None)})
    server = _MetricsServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever,
                         name="keystone-metrics-http", daemon=True)
    server._keystone_thread = t
    t.start()
    return server
