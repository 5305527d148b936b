"""Deterministic trace-replay load generation for the serving plane.

Counterpart of ``keystone_tpu/serving/loadgen.py``. Real request
streams are bursty, diurnal, skewed (a few hot models take most
requests: Zipf), of mixed sizes, and churny (models admitted, evicted
and readmitted under live load). This module generates such a stream
deterministically: a :class:`LoadSpec` with its seed is the whole
experiment, and the same seed gives the same arrivals, models and
sizes, in the same ``np.random.RandomState`` draw order as the JAX
package, so one seed gives one trace in both packages.

* :func:`generate_trace` — ``spec -> LoadTrace``, a pure function: the
  timed request events (arrival offset, model, rows) and churn events
  (evict / readmit at an offset).
* :func:`replay` — drives a trace against anything with the plane's
  ``submit_request`` (a :class:`~.plane.ServingPlane`, a
  :class:`~.router.FleetRouter`, an :class:`HttpServingClient`) from a
  pool of closed-loop senders (event ``i`` goes to sender ``i mod
  senders``, so each sender's order is reproducible), applies churn
  from its own thread, and classifies every outcome (``ok``,
  ``rejected`` (429), ``shed`` (deadline), ``poisoned``,
  ``not_admitted``, ``warming``, ``error``, ``unclassified``) into a
  :class:`ReplayReport`. Every chaos scenario asserts ``unclassified ==
  0``: under injected faults each request ends in a known verdict.

The report's availability is that of accepted requests: of those that
passed the slot gate, the share that resolved OK. Rejections and
routing verdicts during churn (not admitted / warming) are counted
apart, and each scenario bounds them itself.
"""
from __future__ import annotations

import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

#: arrival process names generate_trace understands
ARRIVALS = ("poisson", "bursty", "diurnal")

#: every outcome class replay can record — scenarios assert
#: ``unclassified == 0`` (a fault run must end clean or CLASSIFIED)
OUTCOMES = ("ok", "rejected", "shed", "poisoned", "not_admitted",
            "warming", "error", "unclassified")


@dataclass(frozen=True)
class RequestEvent:
    """One generated request: fires ``t_s`` seconds into the replay."""

    t_s: float
    model: str
    n: int
    seq: int


@dataclass(frozen=True)
class ChurnEvent:
    """One residency change under live load: ``action`` is ``"evict"``
    or ``"readmit"`` (readmission IS admission under load — it runs the
    full warmup path)."""

    t_s: float
    action: str
    model: str


@dataclass(frozen=True)
class LoadSpec:
    """One traffic experiment, fully determined by its fields + seed.

    ``rate_rps`` is the MEAN arrival rate; ``arrival`` shapes how it is
    spent: ``poisson`` (memoryless), ``bursty`` (on/off modulated:
    dwell times are exponential with means ``burst_on_s``/
    ``burst_off_s``; the on-state rate is scaled so the MEAN stays
    ``rate_rps``), or ``diurnal`` (sinusoidal rate over
    ``diurnal_period_s``, thinned from the peak rate). Model popularity
    is Zipf over ``models`` rank order (``zipf_s`` the exponent); sizes
    draw from ``sizes`` with probability inversely proportional to the
    size (most requests are small, like real traffic)."""

    seed: int = 0
    duration_s: float = 2.0
    rate_rps: float = 200.0
    arrival: str = "poisson"
    models: Tuple[str, ...] = ("m0",)
    zipf_s: float = 1.1
    sizes: Tuple[int, ...] = (1, 2, 4)
    burst_mult: float = 4.0
    burst_on_s: float = 0.25
    burst_off_s: float = 0.25
    diurnal_amp: float = 0.8
    diurnal_period_s: float = 1.0
    churn: Tuple[ChurnEvent, ...] = ()
    deadline_ms: Optional[float] = None

    def __post_init__(self):
        if self.arrival not in ARRIVALS:
            raise ValueError(f"unknown arrival process {self.arrival!r} "
                             f"(know {ARRIVALS})")
        if self.duration_s <= 0 or self.rate_rps <= 0:
            raise ValueError("duration_s and rate_rps must be > 0")
        if not self.models or not self.sizes:
            raise ValueError("models and sizes must be non-empty")
        if not 0.0 <= self.diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1)")


@dataclass(frozen=True)
class LoadTrace:
    """A generated experiment: request events sorted by arrival offset
    plus the spec's churn events (also time-sorted)."""

    spec: LoadSpec
    arrivals: Tuple[RequestEvent, ...]
    churn: Tuple[ChurnEvent, ...]


def _zipf_pmf(k: int, s: float) -> np.ndarray:
    w = np.arange(1, k + 1, dtype=np.float64) ** (-float(s))
    return w / w.sum()


def _size_pmf(sizes: Tuple[int, ...]) -> np.ndarray:
    w = 1.0 / np.asarray(sizes, dtype=np.float64)
    return w / w.sum()


def _poisson_times(rng: np.random.RandomState, rate: float,
                   t0: float, t1: float) -> List[float]:
    out: List[float] = []
    t = t0
    while True:
        t += float(rng.exponential(1.0 / rate))
        if t >= t1:
            return out
        out.append(t)


def _arrival_times(spec: LoadSpec,
                   rng: np.random.RandomState) -> List[float]:
    if spec.arrival == "poisson":
        return _poisson_times(rng, spec.rate_rps, 0.0, spec.duration_s)
    if spec.arrival == "bursty":
        # alternating on/off dwells; the on-rate is solved so the
        # long-run mean is rate_rps: mean = on_rate * on_frac
        on_frac = spec.burst_on_s / (spec.burst_on_s + spec.burst_off_s)
        on_rate = spec.rate_rps * min(spec.burst_mult, 1.0 / on_frac)
        times: List[float] = []
        t, on = 0.0, True
        while t < spec.duration_s:
            dwell = float(rng.exponential(
                spec.burst_on_s if on else spec.burst_off_s))
            end = min(t + dwell, spec.duration_s)
            if on:
                times.extend(_poisson_times(rng, on_rate, t, end))
            t, on = end, not on
        return times
    # diurnal: thin a peak-rate stream down to the sinusoidal profile
    peak = spec.rate_rps * (1.0 + spec.diurnal_amp)
    times = []
    for t in _poisson_times(rng, peak, 0.0, spec.duration_s):
        rate_t = spec.rate_rps * (1.0 + spec.diurnal_amp * math.sin(
            2.0 * math.pi * t / spec.diurnal_period_s))
        if float(rng.rand()) < rate_t / peak:
            times.append(t)
    return times


def generate_trace(spec: LoadSpec) -> LoadTrace:
    """``spec -> LoadTrace``, deterministically: one seeded RNG decides
    arrivals, then per-event model and size — so two calls with the
    same spec produce IDENTICAL event sequences (the pinned contract),
    and a scenario failure names (spec, seed) as its full repro."""
    rng = np.random.RandomState(spec.seed)
    times = _arrival_times(spec, rng)
    model_p = _zipf_pmf(len(spec.models), spec.zipf_s)
    size_p = _size_pmf(spec.sizes)
    model_idx = rng.choice(len(spec.models), size=len(times), p=model_p)
    size_idx = rng.choice(len(spec.sizes), size=len(times), p=size_p)
    arrivals = tuple(
        RequestEvent(t_s=float(t), model=spec.models[int(m)],
                     n=int(spec.sizes[int(s)]), seq=i)
        for i, (t, m, s) in enumerate(zip(times, model_idx, size_idx)))
    return LoadTrace(spec=spec, arrivals=arrivals,
                     churn=tuple(sorted(spec.churn,
                                        key=lambda c: c.t_s)))


@dataclass
class ReplayReport:
    """What happened when a trace was replayed: outcome counts, OK
    latencies, churn results, and a bounded sample of error texts."""

    outcomes: Dict[str, int] = field(
        default_factory=lambda: {k: 0 for k in OUTCOMES})
    latencies_ms: List[float] = field(default_factory=list)
    retry_after_seen: int = 0     # rejections that carried a hint
    postmortems: List[str] = field(default_factory=list)
    churn_applied: int = 0
    churn_failed: int = 0
    errors: List[str] = field(default_factory=list)  # bounded sample
    wall_s: float = 0.0

    @property
    def total(self) -> int:
        return sum(self.outcomes.values())

    @property
    def accepted(self) -> int:
        """Requests that entered the queue (past the slot gate)."""
        return self.total - self.outcomes["rejected"] \
            - self.outcomes["not_admitted"] - self.outcomes["warming"]

    def availability(self) -> float:
        """OK fraction of ACCEPTED requests (see module docstring)."""
        acc = self.accepted
        return self.outcomes["ok"] / acc if acc else 1.0

    def p99_ms(self) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), 99))

    def p50_ms(self) -> float:
        if not self.latencies_ms:
            return 0.0
        return float(np.percentile(np.asarray(self.latencies_ms), 50))

    def summary(self) -> Dict[str, Any]:
        return {
            "outcomes": dict(self.outcomes),
            "p50_ms": round(self.p50_ms(), 3),
            "p99_ms": round(self.p99_ms(), 3),
            "availability": round(self.availability(), 4),
            "accepted": self.accepted,
            "retry_after_seen": self.retry_after_seen,
            "churn_applied": self.churn_applied,
            "churn_failed": self.churn_failed,
            "wall_s": round(self.wall_s, 3),
        }


def _classify(exc: BaseException) -> str:
    # local imports: the trace half imports nothing of the plane
    from concurrent.futures import TimeoutError as _FutTimeout

    from ..resilience.retry import TransientError
    from .batcher import DeadlineExpiredError, QueueFullError
    from .plane import ModelNotAdmitted, ModelWarming, PoisonedBatchError

    if isinstance(exc, QueueFullError):
        return "rejected"
    if isinstance(exc, DeadlineExpiredError):
        return "shed"
    if isinstance(exc, PoisonedBatchError):
        return "poisoned"
    if isinstance(exc, ModelNotAdmitted):
        return "not_admitted"
    if isinstance(exc, ModelWarming):
        return "warming"
    if isinstance(exc, (TransientError, ConnectionError, RuntimeError,
                        TimeoutError, _FutTimeout)):
        return "error"
    return "unclassified"


class HttpServingClient:
    """The plane's ``submit_request`` over HTTP (one replica or the
    fleet router: the same wire surface), so :func:`replay` drives real
    sockets unchanged. The POST happens inside ``submit_request``, and
    a refusal comes back as the serving exception its status encodes
    (429 -> ``QueueFullError`` with the ``Retry-After`` hint, 503 ->
    ``ModelWarming`` or an unavailable router, 404 ->
    ``ModelNotAdmitted``, 504 -> ``DeadlineExpiredError``, 500 ->
    ``PoisonedBatchError`` when the body names it), so the classifier
    puts each outcome where it would for an in-process plane. A
    connection failure is a ``ConnectionError`` (classified ``error``):
    a replica killed mid-request is a counted outcome, never an
    unclassified one."""

    def __init__(self, host: str, port: int,
                 request_timeout_s: float = 30.0):
        self.host = host
        self.port = int(port)
        self.request_timeout_s = float(request_timeout_s)

    def _raise_for(self, status: int, body: bytes,
                   headers: Dict[str, str]) -> None:
        from .batcher import DeadlineExpiredError, QueueFullError
        from .plane import (ModelNotAdmitted, ModelWarming,
                            PoisonedBatchError)

        try:
            text = json.loads(body or b"{}").get("error", "")
        except ValueError:
            text = body[:200].decode(errors="replace")
        retry_after = float(headers.get("Retry-After", 1.0) or 1.0)
        if status == 429:
            raise QueueFullError(text or "queue full",
                                 retry_after_s=retry_after)
        if status == 503:
            if "ModelWarming" in text:
                raise ModelWarming(text)
            raise QueueFullError(text or "unavailable",
                                 retry_after_s=retry_after)
        if status == 404:
            raise ModelNotAdmitted(text or "not admitted")
        if status == 504:
            raise DeadlineExpiredError(text or "deadline expired")
        if status == 500 and "PoisonedBatchError" in text:
            raise PoisonedBatchError(text)
        # 400 and the rest are honest errors, never unclassified —
        # RuntimeError (not ValueError) keeps the classifier verdict
        raise RuntimeError(f"HTTP {status}: {text or body[:200]!r}")

    def submit_request(self, model: str, x: Any,
                       timeout_s: Optional[float] = None,
                       deadline_ms: Optional[float] = None) -> Any:
        import http.client
        from concurrent.futures import Future

        from .batcher import Request

        payload: Dict[str, Any] = {
            "instances": np.asarray(x).tolist()}
        if deadline_ms is not None:
            payload["deadline_ms"] = deadline_ms
        conn = http.client.HTTPConnection(
            self.host, self.port, timeout=self.request_timeout_s)
        try:
            try:
                conn.request("POST", f"/predict/{model}",
                             body=json.dumps(payload).encode(),
                             headers={"Content-Type":
                                      "application/json"})
                resp = conn.getresponse()
                body = resp.read()
                headers = {k: v for k, v in resp.getheaders()}
                status = resp.status
            except (OSError, http.client.HTTPException) as exc:
                raise ConnectionError(
                    f"{self.host}:{self.port}: {exc}") from exc
        finally:
            conn.close()
        if status != 200:
            self._raise_for(status, body, headers)
        out = json.loads(body)
        future: Future = Future()
        future.set_result(np.asarray(out["predictions"]))
        return Request(model=model, x=x, n=int(out.get("rows", 1)),
                       enqueued_s=time.perf_counter(), future=future)


def replay(trace: LoadTrace, plane: Any,
           input_for: Callable[[str, int], Any],
           senders: int = 4, time_scale: float = 1.0,
           submit_timeout_s: float = 0.25,
           result_timeout_s: float = 30.0) -> ReplayReport:
    """Replay ``trace`` against ``plane``; see the module docstring.

    ``input_for(model, n)`` builds the request payload (the scenario
    owns model shapes). ``time_scale`` stretches (>1) or compresses
    (<1) the arrival clock — the event SEQUENCE is untouched."""
    report = ReplayReport()
    stats_lock = threading.Lock()
    err_cap = 16
    t_start = time.perf_counter()

    def record(outcome: str, latency_ms: Optional[float] = None,
               exc: Optional[BaseException] = None) -> None:
        with stats_lock:
            report.outcomes[outcome] += 1
            if latency_ms is not None:
                report.latencies_ms.append(latency_ms)
            if exc is not None:
                retry_after = getattr(exc, "retry_after_s", None)
                if outcome == "rejected" and retry_after is not None:
                    report.retry_after_seen += 1
                pm = getattr(exc, "postmortem_path", None)
                if pm:
                    report.postmortems.append(pm)
                if len(report.errors) < err_cap:
                    report.errors.append(
                        f"{type(exc).__name__}: {exc}")

    def sender(idx: int) -> None:
        for ev in trace.arrivals[idx::senders]:
            due = t_start + ev.t_s * time_scale
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            t0 = time.perf_counter()
            try:
                req = plane.submit_request(
                    ev.model, input_for(ev.model, ev.n),
                    timeout_s=submit_timeout_s,
                    deadline_ms=trace.spec.deadline_ms)
                req.future.result(timeout=result_timeout_s)
                record("ok", (time.perf_counter() - t0) * 1e3)
            except BaseException as exc:
                record(_classify(exc), exc=exc)

    def churner() -> None:
        for ev in trace.churn:
            due = t_start + ev.t_s * time_scale
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            try:
                if ev.action == "evict":
                    plane.evict(ev.model)
                elif ev.action == "readmit":
                    plane.readmit(ev.model)
                else:
                    raise ValueError(
                        f"unknown churn action {ev.action!r}")
                with stats_lock:
                    report.churn_applied += 1
            except BaseException as exc:
                with stats_lock:
                    report.churn_failed += 1
                    if len(report.errors) < err_cap:
                        report.errors.append(
                            f"churn {ev.action} {ev.model}: "
                            f"{type(exc).__name__}: {exc}")

    threads = [threading.Thread(target=sender, args=(i,),
                                name=f"loadgen-sender-{i}", daemon=True)
               for i in range(max(int(senders), 1))]
    if trace.churn:
        threads.append(threading.Thread(target=churner,
                                        name="loadgen-churn",
                                        daemon=True))
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    report.wall_s = time.perf_counter() - t_start
    return report
