"""One fleet replica: a serving plane that starts empty and takes its
models over HTTP from the fleet controller.

Counterpart of ``keystone_tpu/serving/replica.py``. ``python -m
keystone_tpu_torch.serving.replica --port 0 [--device cuda|cpu]
[--hbm-budget BYTES] [--max-batch N] [--queue-depth N] [--workers N]``
binds a plane with no models and prints ``replica on HOST:PORT`` (the
line the fleet's launcher parses). Everything it hosts arrives through
the admin surface:

* ``POST /admin/admit`` — ``{"name", "blob_b64", "sample",
  "weight_dtype"}``: the controller ships the canonical pickled bytes,
  the replica admits (on CUDA: charges, warms and captures every
  bucket) and answers ``{"sha256", "charge_nbytes", "warmup_s",
  "captures", "capture_s", "graph_pool_nbytes", "charge_graph_nbytes",
  "charge_pool_nbytes"}``.
  The sha is the migration's bit-identity verdict: the controller
  compares it with its own before it evicts anything.
* ``POST /admin/evict`` — ``{"name"}``: the drain half of a migration.
* ``GET /admin/models`` — ``{name: sha256}`` for every live model.
* ``GET /admin/launches`` — the kernel launches of this process:
  ``{"kernels": kernels.LAUNCHES, "replayed": graphs.REPLAYED_LAUNCHES}``
  (the eager launches of admissions in the first, which a capture does
  not add to; every replay's launches in the second);
  ``POST /admin/reset_launches`` sets both to zero. The launch counts live in the replica's process, and these
  two let a caller prove which kernels a served window ran.

The predict surface is :class:`~.http.ServingHandler`'s, unchanged, so
the router fronts a replica as it would a serve process. Admin calls
carry pickled bytes: a replica trusts its controller as far as a
checkpoint file trusts its writer, so bind it to loopback or another
private interface.
"""
from __future__ import annotations

import base64
import hashlib
import json
import pickle
import signal
import sys
import threading
from typing import Any, Dict, List, Optional

import torch

from ..observability.metrics import MetricsRegistry
from ..ops.device import DEFAULT_DEVICE
from .http import ServingHandler, _err, _parse_bytes, bind_server
from .plane import ModelNotAdmitted, ServingPlane
from .residency import AdmissionError


def encode_sample_spec(sample: Any) -> str:
    """The admitted sample's wire form (base64 pickle of its
    ``ItemSpec`` pytree): its shapes and dtypes decide the buckets'
    captures, so it is shipped exactly, not derived again."""
    return base64.b64encode(pickle.dumps(sample)).decode()


def decode_sample_spec(spec: str) -> Any:
    return pickle.loads(base64.b64decode(spec))


class ReplicaAdminHandler(ServingHandler):
    """The replica's HTTP surface: the full predict/observability
    surface by inheritance, plus the controller-facing admin plane."""

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        path = self.path.split("?")[0]
        if path == "/admin/models":
            shas = {name: hashlib.sha256(entry.blob).hexdigest()
                    for name, entry in sorted(self.plane._live.items())}
            self._reply(200, json.dumps(shas).encode())
            return
        if path == "/admin/launches":
            from ..ops import kernels
            from .graphs import REPLAYED_LAUNCHES

            self._reply(200, json.dumps({
                "kernels": dict(kernels.LAUNCHES),
                "replayed": dict(REPLAYED_LAUNCHES)}).encode())
            return
        super().do_GET()

    def do_POST(self):  # noqa: N802 (stdlib handler API)
        path = self.path.split("?")[0]
        if not path.startswith("/admin/"):
            super().do_POST()
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, TypeError) as exc:
            self._reply(400, _err(exc))
            return
        if path == "/admin/admit":
            self._admit(payload)
        elif path == "/admin/reset_launches":
            from ..ops import kernels
            from .graphs import reset_replayed_launches

            kernels.reset_launches()
            reset_replayed_launches()
            self._reply(200, b'{"reset": true}')
        elif path == "/admin/evict":
            self._evict(payload)
        else:
            self._reply(404, b'{"error": "unknown admin endpoint"}\n')

    def _admit(self, payload: Dict[str, Any]) -> None:
        try:
            name = payload["name"]
            blob = base64.b64decode(payload["blob_b64"])
            sample = decode_sample_spec(payload["sample"])
            weight_dtype = payload.get("weight_dtype")
        except (KeyError, TypeError, ValueError) as exc:
            self._reply(400, _err(exc))
            return
        try:
            entry = self.plane.admit(name, pickle.loads(blob), sample,
                                     weight_dtype=weight_dtype)
        except AdmissionError as exc:
            # the replica's refusal: an admission over budget is the
            # controller's planning error to hear about, loudly
            self._reply(507, _err(exc))
            return
        except Exception as exc:  # noqa: BLE001 (verdict, not a crash)
            self._reply(500, _err(exc))
            return
        self._reply(200, json.dumps({
            "name": name,
            "sha256": hashlib.sha256(entry.blob).hexdigest(),
            "charge_nbytes": entry.charge.total_nbytes(),
            "charge_graph_nbytes": entry.charge.graph_nbytes,
            "charge_pool_nbytes": entry.charge.pool_nbytes,
            "warmup_s": entry.warmup_s,
            "captures": entry.captures,
            "capture_s": entry.capture_s,
            "graph_pool_nbytes": entry.graph_pool_nbytes,
        }).encode())

    def _evict(self, payload: Dict[str, Any]) -> None:
        name = payload.get("name")
        if not isinstance(name, str) or not name:
            self._reply(400, b'{"error": "evict needs a model name"}\n')
            return
        try:
            self.plane.evict(name)
        except (ModelNotAdmitted, KeyError) as exc:
            self._reply(404, _err(exc))
            return
        self._reply(200, json.dumps({"evicted": name}).encode())


def serve_replica(plane: ServingPlane, port: int = 0,
                  host: str = "127.0.0.1",
                  registry: Optional[MetricsRegistry] = None):
    """Bind a replica (predict + admin surfaces) on ``host:port``."""
    return bind_server(
        ReplicaAdminHandler,
        {"registry": registry, "plane": plane,
         "ready_probe": staticmethod(plane.ready)},
        port=port, host=host, thread_name="keystone-replica-http")


def _interrupt(signum, frame):
    raise KeyboardInterrupt


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


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m keystone_tpu_torch.serving.replica``; see the module
    docstring. Starts empty; models arrive through ``/admin/admit``.
    Returns 2 on a usage error."""
    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        port = int(_pop_flag(argv, "--port", "0"))
        host = _pop_flag(argv, "--host", "127.0.0.1")
        budget_text = _pop_flag(argv, "--hbm-budget")
        budget = None if budget_text is None else _parse_bytes(budget_text)
        max_batch = int(_pop_flag(argv, "--max-batch", "64"))
        queue_depth = int(_pop_flag(argv, "--queue-depth", "256"))
        workers_text = _pop_flag(argv, "--workers")
        workers = None if workers_text is None else int(workers_text)
        device = _pop_flag(argv, "--device", DEFAULT_DEVICE)
    except ValueError as exc:
        print(f"replica: {exc}", file=sys.stderr)
        return 2
    if argv:
        print(f"replica: unknown arguments {argv}", file=sys.stderr)
        return 2
    if threading.current_thread() is threading.main_thread():
        # SIGTERM stops like ^C: the port released, the workers stopped
        signal.signal(signal.SIGTERM, _interrupt)
    plane = ServingPlane(hbm_budget=budget, max_batch=max_batch,
                         queue_depth=queue_depth, workers=workers,
                         device=device)
    if plane.device.type == "cuda":
        # the context is made now, before the ready line: its memory and
        # time are the replica's, not its first admission's
        torch.cuda.synchronize(plane.device)
    plane.start()
    server = serve_replica(plane, port=port, host=host)
    print(f"replica on {host}:{server.server_port}", flush=True)
    try:
        threading.Event().wait()  # serve until stopped
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        plane.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
