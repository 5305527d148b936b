"""The fleet front door: consistent-hash routing with honest spill.

Counterpart of ``keystone_tpu/serving/router.py``. One stdlib HTTP
router fronts N serving replicas and speaks the surface one replica
does (``POST /predict/<model>``, ``GET /healthz``, ``GET /models``,
``GET /metrics``), so a client cannot tell one replica from a fleet,
except that the fleet goes on answering when a replica dies:

* **Routing** is rendezvous (highest-random-weight) hashing of the
  model name over the replicas hosting it: deterministic, free of
  coordination, and stable under membership change (a dead replica
  re-routes only its own models).
* **Spill**: when the primary's queue is deep, or the primary refuses
  (429 / 503 / connection refused), the request goes to the least
  loaded replica that hosts the model, counted per model
  (``router.spill_total.<model>``): a rising spill share says "scale
  out" before the p99 moves.
* **Honest refusal**: when no live replica hosts the model the router
  answers 503 with ``Retry-After``, a classified verdict.

Two replica transports share one client surface
(:class:`LocalReplicaClient` calls an in-process plane;
:class:`HttpReplicaClient` speaks HTTP to a replica process), and two
router surfaces share one routing core (:meth:`FleetRouter.
submit_request` has the plane's signature, so the load generator
replays through the router unchanged; :class:`RouterHandler` forwards
raw HTTP bytes and keeps each replica's status and headers).

``_table`` (model -> replica clients) is rebuilt whole and rebound
under the router lock, and read without it on the request path.
"""
from __future__ import annotations

import hashlib
import http.client
import json
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..observability.metrics import MetricsRegistry
from ..utils.guarded import TracedLock, guarded_by, hotpath, published_by
from .batcher import QueueFullError, Request
from .http import _JsonReplyHandler, _err, bind_server, predict_response
from .plane import ModelNotAdmitted, ModelWarming, ServingPlane


def _rendezvous_score(model: str, replica_id: str) -> int:
    """Highest-random-weight score: stable across processes and runs
    (sha256, not the salted builtin hash), so every router instance
    agrees on the primary without coordinating."""
    digest = hashlib.sha256(
        f"{model}|{replica_id}".encode()).digest()
    return int.from_bytes(digest[:8], "big")


class LocalReplicaClient:
    """An in-process replica: direct plane calls, no serialization
    (the transport where measuring a fleet must not measure JSON
    framing, and the in-process double of the HTTP client)."""

    def __init__(self, replica_id: str, plane: ServingPlane):
        self.replica_id = replica_id
        self.plane = plane

    @hotpath
    def submit_request(self, name: str, x: Any,
                       timeout_s: Optional[float] = None,
                       deadline_ms: Optional[float] = None) -> Request:
        return self.plane.submit_request(name, x, timeout_s=timeout_s,
                                         deadline_ms=deadline_ms)

    @hotpath
    def predict_raw(self, name: str, raw: bytes
                    ) -> Tuple[int, bytes, Optional[Dict[str, str]]]:
        return predict_response(self.plane, name, raw)

    def queue_depth(self) -> int:
        return self.plane.batcher.depth()

    def models(self) -> Tuple[str, ...]:
        # the published lock-free snapshot IS the ready-model list
        return tuple(sorted(self.plane._live))

    def model_shas(self) -> Dict[str, str]:
        return {name: hashlib.sha256(entry.blob).hexdigest()
                for name, entry in sorted(self.plane._live.items())}

    def admit_blob(self, name: str, blob: bytes, sample: Any,
                   weight_dtype: Optional[str]) -> str:
        """Admit from canonical bytes; returns the sha256 of the
        replica's OWN canonical blob — the migration bit-identity
        verdict is the caller comparing it against the source's."""
        import pickle

        entry = self.plane.admit(name, pickle.loads(blob), sample,
                                 weight_dtype=weight_dtype)
        return hashlib.sha256(entry.blob).hexdigest()

    def evict(self, name: str) -> None:
        self.plane.evict(name)

    def probe(self) -> str:
        """``"ready"`` / ``"warming"`` / ``"dead"`` — the controller's
        health verdict."""
        if getattr(self.plane, "_closed", False):
            return "dead"
        return "ready" if self.plane.ready() else "warming"


class HttpReplicaClient:
    """A replica process over real HTTP — same surface as the local
    client, every call a fresh bounded-timeout connection
    (``http.client`` connections are not thread-safe; the router's
    handler threads must not share one). Connection failures surface
    as ``ConnectionError`` so the router's spill/refusal path and the
    loadgen classifier both see one exception family."""

    def __init__(self, replica_id: str, host: str, port: int,
                 timeout_s: float = 10.0, stats_ttl_s: float = 0.25):
        self.replica_id = replica_id
        self.host = host
        self.port = int(port)
        self.timeout_s = float(timeout_s)
        #: /models is read at most once per TTL for routing stats: a
        #: read per request would double every request's HTTP cost
        self.stats_ttl_s = float(stats_ttl_s)
        self._stats: Tuple[float, Dict[str, Any]] = (-1e18, {})

    def _request(self, method: str, path: str,
                 body: Optional[bytes] = None
                 ) -> Tuple[int, bytes, Dict[str, str]]:
        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout_s)
        try:
            try:
                conn.request(method, path, body=body,
                             headers={"Content-Type":
                                      "application/json"})
                resp = conn.getresponse()
                payload = resp.read()
                headers = {k: v for k, v in resp.getheaders()}
                return resp.status, payload, headers
            except (OSError, http.client.HTTPException) as exc:
                raise ConnectionError(
                    f"replica {self.replica_id} at "
                    f"{self.host}:{self.port}: {exc}") from exc
        finally:
            conn.close()

    @hotpath
    def predict_raw(self, name: str, raw: bytes
                    ) -> Tuple[int, bytes, Optional[Dict[str, str]]]:
        status, body, headers = self._request(
            "POST", f"/predict/{name}", body=raw)
        keep = {k: v for k, v in headers.items()
                if k.lower() in ("retry-after", "x-keystone-trace")}
        return status, body, keep or None

    def _state(self, fresh: bool = False) -> Dict[str, Any]:
        now = time.monotonic()
        stamp, cached = self._stats
        if not fresh and now - stamp < self.stats_ttl_s:
            return cached
        status, body, _ = self._request("GET", "/models")
        state = json.loads(body) if status == 200 else {}
        self._stats = (now, state)
        return state

    def queue_depth(self) -> int:
        return int(self._state().get("queue_depth", 0))

    def models(self) -> Tuple[str, ...]:
        # table rebuilds are rare and correctness-critical: a cached
        # snapshot taken moments before an admission completed would
        # leave the new copy invisible until the next rebuild — bypass
        # the TTL (queue_depth, polled per-request, keeps it)
        return tuple(sorted(
            m["name"] for m in self._state(fresh=True).get("models", ())
            if m.get("ready")))

    def model_shas(self) -> Dict[str, str]:
        status, body, _ = self._request("GET", "/admin/models")
        if status != 200:
            raise ConnectionError(
                f"replica {self.replica_id}: /admin/models -> {status}")
        return dict(json.loads(body))

    def admit_blob(self, name: str, blob: bytes, sample: Any,
                   weight_dtype: Optional[str]) -> str:
        import base64

        from .replica import encode_sample_spec

        payload = json.dumps({
            "name": name,
            "blob_b64": base64.b64encode(blob).decode(),
            "sample": encode_sample_spec(sample),
            "weight_dtype": weight_dtype,
        }).encode()
        status, body, _ = self._request("POST", "/admin/admit",
                                        body=payload)
        if status != 200:
            raise RuntimeError(
                f"replica {self.replica_id}: admit {name!r} -> "
                f"{status}: {body[:200].decode(errors='replace')}")
        return json.loads(body)["sha256"]

    def evict(self, name: str) -> None:
        payload = json.dumps({"name": name}).encode()
        status, body, _ = self._request("POST", "/admin/evict",
                                        body=payload)
        if status != 200:
            raise RuntimeError(
                f"replica {self.replica_id}: evict {name!r} -> "
                f"{status}: {body[:200].decode(errors='replace')}")

    def probe(self) -> str:
        try:
            status, _, _ = self._request("GET", "/healthz")
        except ConnectionError:
            return "dead"
        return "ready" if status == 200 else "warming"


@published_by("_lock", "_table")
@guarded_by("_lock", "_clients")
class FleetRouter:
    """The routing core both surfaces share; see the module docstring.

    ``spill_queue_depth`` is the proactive-spill threshold: a primary
    with at least this many queued requests loses the request to the
    least-loaded eligible sibling BEFORE refusing (tune it against the
    ``serving.queue_wait_s`` histogram — depth is the cause,
    queue-wait the symptom the SLO sees)."""

    def __init__(self, clients: Sequence[Any] = (),
                 spill_queue_depth: int = 48):
        self.spill_queue_depth = int(spill_queue_depth)
        self._lock = TracedLock("serving.router")
        self._clients: Dict[str, Any] = {}
        #: published model -> (client, ...) snapshot; rebuilt fresh and
        #: rebound whole under the lock, read lock-free per request
        self._table: Dict[str, Tuple[Any, ...]] = {}
        for client in clients:
            self._clients[client.replica_id] = client
        self.refresh()

    # -- membership ---------------------------------------------------------
    def replica_ids(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(self._clients))

    def client(self, replica_id: str) -> Any:
        with self._lock:
            return self._clients[replica_id]

    def add_replica(self, client: Any) -> None:
        with self._lock:
            self._clients[client.replica_id] = client
        self.refresh()

    def remove_replica(self, replica_id: str) -> None:
        """Drop a replica (death or drain-complete) and republish the
        table — its models re-route on the next request."""
        with self._lock:
            self._clients.pop(replica_id, None)
        self.refresh()

    def refresh(self) -> None:
        """Rebuild the model->replicas table from what each replica
        actually hosts RIGHT NOW (a replica that cannot answer is left
        out — dead replicas serve nothing). One atomic rebind."""
        with self._lock:
            clients = dict(self._clients)
        table: Dict[str, List[Any]] = {}
        live = 0
        for rid in sorted(clients):
            client = clients[rid]
            try:
                names = client.models()
            except (ConnectionError, OSError):
                continue
            live += 1
            for name in names:
                table.setdefault(name, []).append(client)
        frozen = {n: tuple(cs) for n, cs in table.items()}
        with self._lock:
            self._table = frozen
        reg = MetricsRegistry.get_or_create()
        reg.gauge("router.replicas_live").set(live)
        reg.gauge("fleet.models_placed").set(
            sum(len(cs) for cs in frozen.values()))

    # -- routing core -------------------------------------------------------
    @hotpath
    def _route(self, name: str) -> Tuple[List[Any], Any]:
        """Candidate replicas for ``name`` in try-order, plus the
        rendezvous primary (for spill accounting). Lock-free read of
        the published table."""
        clients = self._table.get(name)
        if not clients:
            known = sorted(self._table)
            raise ModelNotAdmitted(
                f"model {name!r} is on no live replica "
                f"(fleet hosts: {known or 'none'})")
        primary = max(clients,
                      key=lambda c: _rendezvous_score(name,
                                                      c.replica_id))
        if len(clients) == 1:
            return [primary], primary

        def depth_of(client: Any) -> int:
            # a replica that cannot answer its stats probe sorts LAST
            # (effectively infinite depth) — the submit attempt will
            # classify it properly; the probe must never crash routing
            try:
                return client.queue_depth()
            except (ConnectionError, OSError):
                return 1 << 30

        rest = sorted((c for c in clients if c is not primary),
                      key=lambda c: (depth_of(c), c.replica_id))
        order = [primary] + rest
        depth = depth_of(primary)
        if depth >= self.spill_queue_depth \
                and depth_of(rest[0]) < depth:
            # proactive spill: the primary is congested and a sibling
            # is measurably shallower — don't wait for the 429
            order = [rest[0], primary] + rest[1:]
        return order, primary

    @hotpath
    def submit_request(self, name: str, x: Any,
                       timeout_s: Optional[float] = None,
                       deadline_ms: Optional[float] = None) -> Request:
        """The plane-shaped surface (duck-typed by the loadgen): route,
        submit to the first willing replica, spill on refusal. Raises
        the LAST replica's classified refusal when nobody accepts —
        the fleet never converts a classified verdict into mush."""
        reg = MetricsRegistry.get_or_create()
        reg.counter("router.requests_total").inc()
        order, primary = self._route(name)
        last: Optional[BaseException] = None
        for client in order:
            try:
                req = client.submit_request(name, x,
                                            timeout_s=timeout_s,
                                            deadline_ms=deadline_ms)
            except (QueueFullError, ModelWarming, ModelNotAdmitted,
                    ConnectionError) as exc:
                # ModelNotAdmitted from a TABLED replica means the
                # table is stale (mid-migration evict): spill, don't
                # trust the snapshot over the replica's own verdict
                last = exc
                continue
            if client is not primary:
                reg.counter("router.spill_total").inc()
                reg.counter(f"router.spill_total.{name}").inc()
            return req
        reg.counter("router.unavailable_total").inc()
        if isinstance(last, (QueueFullError, ModelWarming,
                             ModelNotAdmitted)):
            raise last
        raise QueueFullError(
            f"no eligible replica for {name!r} "
            f"({len(order)} tried, all unreachable)",
            retry_after_s=1.0)

    @hotpath
    def predict_raw(self, name: str, raw: bytes
                    ) -> Tuple[int, bytes, Optional[Dict[str, str]]]:
        """The HTTP-forwarding surface: same routing/spill decisions,
        verdict carried as raw status/body/headers (the replica's own
        classification passes through verbatim; only an all-replicas-
        refused outcome is the router's to classify — 503 with
        Retry-After)."""
        reg = MetricsRegistry.get_or_create()
        reg.counter("router.requests_total").inc()
        try:
            order, primary = self._route(name)
        except ModelNotAdmitted as exc:
            reg.counter("router.unavailable_total").inc()
            return 404, _err(exc), None
        last: Optional[Tuple[int, bytes, Optional[Dict[str, str]]]] = None
        for client in order:
            try:
                status, body, headers = client.predict_raw(name, raw)
            except ConnectionError as exc:
                last = (503, _err(exc), None)
                continue
            if status in (404, 429, 503):
                # 404 from a TABLED replica = stale table (the model
                # just migrated off it): spill like any refusal
                last = (status, body, headers)
                continue
            if client is not primary:
                reg.counter("router.spill_total").inc()
                reg.counter(f"router.spill_total.{name}").inc()
            return status, body, headers
        reg.counter("router.unavailable_total").inc()
        status, body, headers = last if last is not None else (
            503, _err(QueueFullError(
                f"no eligible replica for {name!r}")), None)
        headers = dict(headers or {})
        if status in (429, 503):
            # every fleet refusal answers WHEN: a 429/503 without
            # Retry-After is an unclassified shrug
            headers.setdefault("Retry-After", "1")
        return status, body, headers

    def ready(self) -> bool:
        """The router's readiness: it can route SOMETHING (at least one
        model on at least one live replica)."""
        if not self._table:
            raise RuntimeError("router has no routable models")
        return True

    def state(self) -> Dict[str, Any]:
        """JSON-able fleet routing state (the router's ``/models``)."""
        table = self._table
        return {
            "replicas": list(self.replica_ids()),
            "models": {
                name: [c.replica_id for c in clients]
                for name, clients in sorted(table.items())},
            "spill_queue_depth": self.spill_queue_depth,
        }


class RouterHandler(_JsonReplyHandler):
    """The router's HTTP surface: ``POST /predict/<model>`` forwards
    through :meth:`FleetRouter.predict_raw`; ``GET /models`` serves the
    fleet routing table; ``/healthz``/``/metrics`` ride the shared
    metrics handler (readiness = the router can route something)."""

    router: Optional[FleetRouter] = None

    def do_GET(self):  # noqa: N802 (stdlib handler API)
        if self.path.split("?")[0] == "/models":
            self._reply(200,
                        json.dumps(self.router.state()).encode())
            return
        super().do_GET()

    @hotpath
    def do_POST(self):  # noqa: N802 (stdlib handler API)
        path = self.path.split("?")[0]
        if not path.startswith("/predict/"):
            self._reply(404, b'{"error": "unknown endpoint"}\n')
            return
        name = path[len("/predict/"):]
        try:
            length = int(self.headers.get("Content-Length", "0"))
            raw = self.rfile.read(length)
        except (ValueError, TypeError) as exc:
            self._reply(400, _err(exc))
            return
        status, body, headers = self.router.predict_raw(name, raw)
        self._reply(status, body, "application/json", headers=headers)


def serve_router(router: FleetRouter, port: int = 0,
                 host: str = "127.0.0.1",
                 registry: Optional[MetricsRegistry] = None):
    """Bind the fleet front door on ``host:port`` (``port=0`` =
    ephemeral) — same server machinery, thread, and shutdown semantics
    as a single replica's :func:`~.http.serve`."""
    return bind_server(
        RouterHandler,
        {"registry": registry, "router": router,
         "ready_probe": staticmethod(router.ready)},
        port=port, host=host, thread_name="keystone-router-http")
