"""The HTTP surface of the serving plane and the ``serve`` command.

Counterpart of ``keystone_tpu/serving/http.py``. Endpoints (stdlib
``ThreadingHTTPServer``; one server carries the data plane and the
scrape surface):

* ``POST /predict/<model>`` — body ``{"instances": [...]}`` (or a bare
  JSON array), optionally with ``"deadline_ms"``. Instances are rows of
  the admitted item shape; the handler thread submits them as ONE
  request and waits, so concurrent requests coalesce into padded
  buckets. Response: ``{"model", "rows", "predictions"}``. Errors map
  to statuses: 404 unknown model, 503 warming, 504 deadline shed, 429
  queue full (with a ``Retry-After`` header), 400 bad shape or JSON,
  500 batch failure. A traced request's id comes back in the
  ``X-Keystone-Trace`` header.
* ``GET /healthz`` — readiness: 503 ``warming`` until every admitted
  and expected model has warmed (``ServingPlane.ready``).
* ``GET /metrics`` — Prometheus text of the port's registry.
* ``GET /models`` — JSON plane state.
* ``GET /slo`` — the SLO tracker's state (``observability/slo.py``).
* ``GET /debug/slow?n=8&model=M`` — the slowest retained request traces
  (``observability/reqtrace.py``).

Every GET runs the flight recorder's deferred thunks first, so what it
serves includes the batches served so far.

Command::

    python -m keystone_tpu_torch serve NAME=PATH@SHAPE[:DTYPE] ... \\
        [--port P] [--host H] [--hbm-budget BYTES] [--max-batch N] \\
        [--queue-depth N] [--weight-dtype bf16|int8|f32] [--device D] \\
        [--drift-every N] [--slo-latency-ms MS] [--slo-availability A]

``PATH`` is a pipeline saved by ``utils.checkpoint.save_pipeline``,
``SHAPE`` the per-item shape (comma-separated, e.g. ``32,32,3``),
``DTYPE`` float32 by default. The server binds BEFORE admitting (so
``/healthz`` reports warming during the warmups), prints ``serving on
HOST:PORT``, one ``admitted`` line per model, then ``serving ready (N
models)``. ``--weight-dtype`` defaults to bf16, the quantized predict;
``f32`` opts out. ``--device`` defaults to ``cuda``. ``--drift-every``
scores a model's inputs against its fit's drift baseline every N batches
(default 32); ``--slo-latency-ms`` and ``--slo-availability`` set the SLO
policy's latency threshold and availability target (``GET /slo``).
"""
from __future__ import annotations

import json
import math
import signal
import sys
import threading
from typing import Any, Dict, List, Optional, Tuple

from urllib.parse import parse_qs, urlsplit

import numpy as np

from ..observability.metrics import MetricsRegistry
from ..observability.reqtrace import exemplar_reservoir
from ..observability.sampler import _MetricsHandler, _MetricsServer
from ..observability.slo import SloPolicy
from ..observability.timeline import flight_recorder
from ..ops.device import DEFAULT_DEVICE
from ..utils.guarded import hotpath
from .batcher import DeadlineExpiredError, QueueFullError
from .models import ItemSpec
from .plane import ModelNotAdmitted, ModelWarming, ServingPlane
from .residency import AdmissionError


class _JsonReplyHandler(_MetricsHandler):
    """The JSON-reply half of the handler: one ``_reply`` for every
    response, same headers and framing."""

    def _reply(self, status: int, body: bytes,
               ctype: str = "application/json",
               headers: Optional[Dict[str, str]] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for key, value in (headers or {}).items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(body)


def predict_response(plane: Any, name: str, raw: bytes
                     ) -> Tuple[int, bytes, Optional[Dict[str, str]]]:
    """One predict call against ``plane``, mapped to the HTTP verdict
    ``(status, body, extra headers)``: 404 unknown / 503 warming / 504
    shed / 429 with Retry-After / 400 bad shape or JSON / 500 batch
    failure."""
    try:
        blob = json.loads(raw or b"null")
        instances = blob.get("instances") if isinstance(blob, dict) else blob
        deadline_ms = blob.get("deadline_ms") if isinstance(blob, dict) \
            else None
        if deadline_ms is not None:
            deadline_ms = float(deadline_ms)
            if deadline_ms <= 0:
                raise ValueError("deadline_ms must be > 0")
        if not isinstance(instances, list) or not instances:
            raise ValueError(
                'body must be {"instances": [...]} or a JSON array')
        out, trace_id = plane.predict_traced(name, np.asarray(instances),
                                             deadline_ms=deadline_ms)
        body = json.dumps({"model": name, "rows": len(instances),
                           "predictions": _jsonable(out)}).encode()
        # the trace id rides a header: the JSON body keeps its shape
        return 200, body, ({"X-Keystone-Trace": trace_id} if trace_id
                           else None)
    except ModelNotAdmitted as exc:
        return 404, _err(exc), None
    except ModelWarming as exc:
        return 503, _err(exc), None
    except DeadlineExpiredError as exc:
        # shed before dispatch: "too late", not "server broke"
        return 504, _err(exc), None
    except QueueFullError as exc:
        # integer seconds (RFC 9110), at least 1
        return 429, _err(exc), {
            "Retry-After": str(max(1, math.ceil(exc.retry_after_s)))}
    except (ValueError, TypeError) as exc:  # JSONDecodeError included
        return 400, _err(exc), None
    except Exception as exc:  # noqa: BLE001 - a failed batch is a 500
        return 500, _err(exc), None


class ServingHandler(_JsonReplyHandler):
    """The scrape handler plus the predict data plane (``plane`` is bound
    per server by :func:`serve`)."""

    plane: Optional[ServingPlane] = None

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        # the scrape is a flush point for the workers' deferred telemetry
        flight_recorder().flush()
        parts = urlsplit(self.path)
        if parts.path == "/models":
            self._reply(200, json.dumps(self.plane.state()).encode())
            return
        if parts.path == "/slo":
            self._reply(200, json.dumps(self.plane.slo.state()).encode())
            return
        if parts.path == "/debug/slow":
            try:
                query = parse_qs(parts.query)
                n = int(query.get("n", ["8"])[0])
                model = query.get("model", [None])[0]
            except (ValueError, TypeError) as exc:
                self._reply(400, _err(exc))
                return
            self._reply(200, json.dumps({
                "slowest": exemplar_reservoir().slowest_trees(
                    n, model=model)}).encode())
            return
        super().do_GET()

    @hotpath
    def do_POST(self):  # noqa: N802 (stdlib handler API)
        path = self.path.split("?")[0]
        if not path.startswith("/predict/"):
            self._reply(404, b'{"error": "unknown endpoint"}\n')
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
        except (ValueError, TypeError) as exc:
            self._reply(400, _err(exc))
            return
        status, body, headers = predict_response(
            self.plane, path[len("/predict/"):], raw)
        self._reply(status, body, headers=headers)


def _err(exc: BaseException) -> bytes:
    return json.dumps({"error": f"{type(exc).__name__}: {exc}"}).encode()


def _jsonable(out: Any) -> Any:
    if isinstance(out, (list, tuple)):
        return [_jsonable(o) for o in out]
    if isinstance(out, dict):
        return {k: _jsonable(v) for k, v in out.items()}
    if hasattr(out, "tolist"):
        return out.tolist()
    return out


def bind_server(handler_cls: type, attrs: Dict[str, Any], port: int = 0,
                host: str = "127.0.0.1",
                thread_name: str = "keystone-http") -> _MetricsServer:
    """Bind a per-server subclass of ``handler_cls`` (class attributes
    from ``attrs``) on ``host:port`` and serve it from a daemon thread.
    ``.shutdown()`` joins the thread and releases the port."""
    handler = type("_Bound" + handler_cls.__name__, (handler_cls,),
                   dict(attrs))
    server = _MetricsServer((host, port), handler)
    t = threading.Thread(target=server.serve_forever, name=thread_name,
                         daemon=True)
    server._keystone_thread = t
    t.start()
    return server


def serve(plane: ServingPlane, port: int = 0, host: str = "127.0.0.1",
          registry: Optional[MetricsRegistry] = None) -> _MetricsServer:
    """Serve ``plane``'s endpoints on ``host:port`` (``port=0``: an
    ephemeral port, read back from ``server.server_port``) from a daemon
    thread; ``/healthz`` is gated on ``plane.ready``; ``/metrics`` reads
    ``registry`` (default the process registry)."""
    return bind_server(
        ServingHandler,
        {"registry": registry, "plane": plane,
         "ready_probe": staticmethod(plane.ready)},
        port=port, host=host, thread_name="keystone-serving-http")


# -- command ------------------------------------------------------------------

_USAGE = ("usage: python -m keystone_tpu_torch serve "
          "NAME=PATH@SHAPE[:DTYPE] ... [--port P] [--host H] "
          "[--hbm-budget BYTES] [--max-batch N] [--queue-depth N] "
          "[--weight-dtype bf16|int8|f32] [--device cuda|cpu] "
          "[--drift-every N] [--slo-latency-ms MS] [--slo-availability A]")


def _parse_bytes(text: str) -> float:
    """Byte counts with optional binary suffixes: ``1073741824``,
    ``512MiB``, ``16GiB``, ``4g``."""
    units = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}
    s = text.strip().lower()
    for suffix in ("ib", "b"):
        if s.endswith(suffix) and len(s) > len(suffix) \
                and s[-len(suffix) - 1] in units:
            s = s[: -len(suffix)]
            break
    mult = 1
    if s and s[-1] in units:
        mult = units[s[-1]]
        s = s[:-1]
    return float(s) * mult


def _parse_model_spec(spec: str):
    """``NAME=PATH@SHAPE[:DTYPE]`` -> (name, path, ItemSpec)."""
    if "=" not in spec or "@" not in spec:
        raise ValueError(
            f"model spec {spec!r} must look like NAME=PATH@SHAPE[:DTYPE] "
            "(e.g. cifar=model.pkl@32,32,3:float32)")
    name, rest = spec.split("=", 1)
    path, shape_spec = rest.rsplit("@", 1)
    dtype = "float32"
    if ":" in shape_spec:
        shape_spec, dtype = shape_spec.split(":", 1)
    shape = tuple(int(d) for d in shape_spec.split(",") if d)
    return name, path, ItemSpec(shape, np.dtype(dtype))


def _pop_flag(argv: List[str], flag: str,
              default: Optional[str] = None) -> Optional[str]:
    if flag not in argv:
        return default
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise ValueError(f"{flag} requires a value")
    value = argv[i + 1]
    del argv[i:i + 2]
    return value


def _interrupt(signum, frame):
    raise KeyboardInterrupt


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m keystone_tpu_torch serve``; see the module docstring.
    Returns 2 on a usage error, 3 when an admission is refused."""
    from ..utils.checkpoint import load_pipeline

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        port = int(_pop_flag(argv, "--port", "9100"))
        host = _pop_flag(argv, "--host", "127.0.0.1")
        budget_text = _pop_flag(argv, "--hbm-budget")
        budget = None if budget_text is None else _parse_bytes(budget_text)
        max_batch = int(_pop_flag(argv, "--max-batch", "64"))
        queue_depth = int(_pop_flag(argv, "--queue-depth", "256"))
        wd = _pop_flag(argv, "--weight-dtype", "bf16")
        weight_dtype = None if wd in ("f32", "none") else wd
        device = _pop_flag(argv, "--device", DEFAULT_DEVICE)
        drift_every = int(_pop_flag(argv, "--drift-every", "32"))
        slo_latency = _pop_flag(argv, "--slo-latency-ms")
        slo_avail = _pop_flag(argv, "--slo-availability")
        slo_policy = None
        if slo_latency is not None or slo_avail is not None:
            kwargs = {}
            if slo_latency is not None:
                kwargs["latency_threshold_ms"] = float(slo_latency)
            if slo_avail is not None:
                kwargs["availability_target"] = float(slo_avail)
            slo_policy = SloPolicy(**kwargs)
        specs = [_parse_model_spec(s) for s in argv if not s.startswith("-")]
        unknown = [s for s in argv if s.startswith("-")]
        if unknown:
            raise ValueError(f"unknown option(s) {unknown}")
    except ValueError as exc:
        print(f"serve: {exc}", file=sys.stderr)
        return 2
    if not specs:
        print(_USAGE, file=sys.stderr)
        return 2

    if threading.current_thread() is threading.main_thread():
        # SIGTERM shuts down like ^C: the port is released, the worker
        # stopped and queued requests failed
        signal.signal(signal.SIGTERM, _interrupt)
    plane = ServingPlane(hbm_budget=budget, max_batch=max_batch,
                         queue_depth=queue_depth,
                         default_weight_dtype=weight_dtype,
                         drift_every=drift_every, slo_policy=slo_policy,
                         device=device)
    # readiness waits for every listed model BEFORE the port opens
    plane.expect_models(len(specs))
    plane.start()
    server = serve(plane, port=port, host=host)
    print(f"serving on {host}:{server.server_port}", flush=True)
    try:
        for name, path, sample in specs:
            entry = plane.admit(name, load_pipeline(path, device=device),
                                sample)
            mib = 1 << 20
            print(f"admitted {name!r}: "
                  f"{entry.charge.total_nbytes() / mib:.2f} MiB "
                  f"({entry.charge.source}), buckets {list(entry.buckets)},"
                  f" warmup {entry.warmup_s:.2f}s, weight_dtype "
                  f"{entry.weight_dtype or 'f32'}, device {plane.device}",
                  flush=True)
        print(f"serving ready ({len(specs)} models) on "
              f"{host}:{server.server_port}", flush=True)
        threading.Event().wait()  # serve until interrupted
    except AdmissionError as exc:
        print(f"serve: admission refused: {exc}", file=sys.stderr)
        return 3
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        plane.close()
    return 0
