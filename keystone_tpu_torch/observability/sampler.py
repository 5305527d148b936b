"""The HTTP scrape surface: ``GET /metrics`` and ``GET /healthz``.

Counterpart of the handler and server of
``keystone_tpu/observability/sampler.py``. The serving plane's HTTP
surface (``serving/http.py``) extends this handler. The background
``TelemetrySampler`` and its probes are not ported yet (ROADMAP A9).
"""
from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from .metrics import MetricsRegistry


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
