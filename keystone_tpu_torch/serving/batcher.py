"""Request micro-batching behind a slot-gated bounded queue.

Counterpart of ``keystone_tpu/serving/batcher.py``. Serving gets its
throughput from batching: one device pass over 32 coalesced requests
costs barely more than one over a single item.

* :class:`BucketPolicy` — the ladder of padded batch sizes. Every
  executed batch is padded to a bucket (powers of two up to
  ``max_batch``), so the served shapes are a small fixed set that
  admission warms.
* :class:`MicroBatcher` — the bounded queue. A request takes a slot of
  a ``threading.Semaphore`` before it is queued, so pending work is
  bounded at ``queue_depth`` requests and an overloaded plane refuses
  fast (:class:`QueueFullError`, a 429 with ``Retry-After``) instead of
  queueing without bound. The worker side (:meth:`MicroBatcher.take`)
  pops the oldest request and coalesces the later requests for the
  same model behind it up to the bucket ceiling, keeping FIFO order for
  everything it leaves.

Each request carries a :class:`~..observability.reqtrace.ReqTrace`
(None while tracing is off): the submit stamps its enqueue and
:meth:`MicroBatcher.take` its pop. ``serve.enqueue`` is the fault site of
every submit, before the slot gate.

Thread model: HTTP handler threads (or callers) ``submit``; the plane's
workers ``take`` and call ``done``. ``_pending`` is guarded by
``_lock``; ``_closed`` is written under it and read without it.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Deque, List, Optional, Tuple

from ..observability.metrics import MetricsRegistry
from ..observability.reqtrace import ReqTrace, tracing_active
from ..resilience.faults import inject
from ..utils.guarded import guarded_by, hotpath, published_by


class QueueFullError(RuntimeError):
    """The bounded request queue stayed full for the whole submit
    timeout. ``retry_after_s`` estimates, from the observed drain rate,
    when a slot will free (served as the 429's ``Retry-After``)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class DeadlineExpiredError(RuntimeError):
    """The request's deadline passed before the worker dispatched it: it
    was shed from the queue without device work (HTTP 504)."""


@dataclass(frozen=True)
class BucketPolicy:
    """The pad-to-bucket ladder: powers of two from 1 up to
    ``max_batch``, which is always included so the ceiling is exact.
    Powers of two cap the pad waste below 2x with a number of buckets
    logarithmic in ``max_batch``. One device, so no shard rounding."""

    max_batch: int = 64

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")

    def rows(self) -> Tuple[int, ...]:
        """Ascending bucket row counts."""
        sizes = set()
        b = 1
        while b < self.max_batch:
            sizes.add(b)
            b *= 2
        sizes.add(self.max_batch)
        return tuple(sorted(sizes))

    def bucket_for(self, n: int) -> int:
        """Smallest bucket holding ``n`` rows; ValueError above the
        ceiling."""
        for b in self.rows():
            if n <= b:
                return b
        raise ValueError(
            f"batch of {n} rows exceeds the largest bucket "
            f"({self.max_batch}) — split it before staging")

    def max_rows(self) -> int:
        return self.max_batch


@dataclass
class Request:
    """One submitted request: ``x`` is a host pytree whose leaves have
    leading dim ``n``; the future resolves to the model output for
    exactly those rows. ``trace`` is its request-path record (None when
    tracing is off)."""

    model: str
    x: Any
    n: int
    enqueued_s: float = field(default_factory=time.perf_counter)
    future: Future = field(default_factory=Future)
    trace: Optional[ReqTrace] = None
    #: absolute perf_counter deadline (None = none); a request past it
    #: is shed before dispatch
    deadline_s: Optional[float] = None

    def expired(self, now: Optional[float] = None) -> bool:
        """True when this request's deadline has passed."""
        if self.deadline_s is None:
            return False
        return (time.perf_counter() if now is None else now) \
            > self.deadline_s


@published_by("_lock", "_closed")
@guarded_by("_lock", "_pending")
class MicroBatcher:
    """Slot-gated bounded request queue; see the module docstring."""

    def __init__(self, queue_depth: int = 128,
                 submit_timeout_s: float = 2.0):
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self.queue_depth = int(queue_depth)
        self.submit_timeout_s = float(submit_timeout_s)
        self._slots = threading.Semaphore(queue_depth)
        self._lock = threading.Lock()
        self._pending: Deque[Request] = deque()
        self._closed = False
        self._ready = threading.Event()
        # drain-rate moving average (requests/s, fed by done()): the
        # basis of the Retry-After hint; 0.0 until the first drain
        self._drain_rps = 0.0
        self._last_done_s = time.perf_counter()

    def retry_after_s(self) -> float:
        """Seconds until a slot plausibly frees: pending depth over the
        drain rate, clamped to [0.05, 10]; the submit timeout before any
        drain was seen."""
        rate = self._drain_rps
        if rate <= 0.0:
            return max(self.submit_timeout_s, 0.05)
        with self._lock:
            depth = len(self._pending)
        return min(max(max(depth, 1) / rate, 0.05), 10.0)

    # -- producer side (handler threads) -----------------------------------
    @hotpath
    def submit(self, model: str, x: Any, n: int,
               timeout_s: Optional[float] = None,
               deadline_ms: Optional[float] = None) -> Future:
        """Queue one request behind the slot gate; returns its future.
        Raises :class:`QueueFullError` when no slot frees within the
        timeout. ``deadline_ms`` bounds, from now, how long the request
        may wait before dispatch."""
        return self.submit_request(model, x, n, timeout_s=timeout_s,
                                   deadline_ms=deadline_ms).future

    @hotpath
    def submit_request(self, model: str, x: Any, n: int,
                       timeout_s: Optional[float] = None,
                       deadline_ms: Optional[float] = None) -> Request:
        """:meth:`submit`, returning the whole :class:`Request` (the HTTP
        surface echoes ``request.trace.trace_id``)."""
        inject("serve.enqueue", context=model)
        # a closed batcher refuses before the slot gate: shutdown neither
        # costs the submit timeout nor reads as a 429
        if self._closed:
            raise RuntimeError("batcher is closed")
        timeout = self.submit_timeout_s if timeout_s is None else timeout_s
        if not self._slots.acquire(timeout=timeout):
            reg = MetricsRegistry.get_or_create()
            reg.counter("serving.rejected_total").inc()
            reg.counter(f"serving.rejected_total.{model}").inc()
            raise QueueFullError(
                f"serving queue full ({self.queue_depth} slots) — "
                f"request for {model!r} rejected after {timeout:.1f}s",
                retry_after_s=self.retry_after_s())
        trace = ReqTrace.new(model, int(n)) if tracing_active() else None
        if trace is None:
            req = Request(model=model, x=x, n=int(n))
        else:
            # one clock read stamps both: the trace's enqueue IS the
            # request's
            req = Request(model=model, x=x, n=int(n),
                          enqueued_s=trace.enqueued_s, trace=trace)
        if deadline_ms is not None:
            req.deadline_s = req.enqueued_s + float(deadline_ms) / 1e3
        with self._lock:
            if self._closed:
                self._slots.release()
                raise RuntimeError("batcher is closed")
            self._pending.append(req)
            depth = len(self._pending)
        self._ready.set()
        MetricsRegistry.get_or_create().gauge(
            "serving.queue_depth").set(depth)
        return req

    # -- consumer side (the plane worker) ----------------------------------
    @hotpath
    def take(self, max_rows: int, timeout_s: float = 0.05) -> List[Request]:
        """Pop the oldest pending request plus every later request for
        the same model that fits within ``max_rows`` rows in all; other
        models' requests (and overflow) keep their FIFO places. Returns
        [] on timeout. The event wait runs outside the lock."""
        if not self._ready.wait(timeout_s):
            return []
        out: List[Request] = []
        with self._lock:
            if not self._pending:
                self._ready.clear()
                return []
            first = self._pending.popleft()
            out.append(first)
            rows = first.n
            rest: Deque[Request] = deque()
            while self._pending:
                req = self._pending.popleft()
                if req.model == first.model and rows + req.n <= max_rows:
                    out.append(req)
                    rows += req.n
                else:
                    rest.append(req)
            self._pending = rest
            if not self._pending:
                self._ready.clear()
            depth = len(self._pending)
        taken_s = time.perf_counter()
        for req in out:
            if req.trace is not None:
                # queue_wait ends here; the worker owns later stamps
                req.trace.taken_s = taken_s
        MetricsRegistry.get_or_create().gauge(
            "serving.queue_depth").set(depth)
        return out

    @hotpath
    def done(self, count: int) -> None:
        """Free ``count`` slots once their requests' futures resolved,
        and feed the drain-rate average (one writer: the worker)."""
        if count > 0:
            now = time.perf_counter()
            dt = max(now - self._last_done_s, 1e-6)
            self._last_done_s = now
            sample = count / dt
            prior = self._drain_rps
            self._drain_rps = sample if prior <= 0.0 \
                else 0.8 * prior + 0.2 * sample
            self._slots.release(count)

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)

    def close(self) -> List[Request]:
        """Refuse new submits and drain the queue; returns the drained
        requests so the owner can fail their futures."""
        with self._lock:
            self._closed = True
            drained = list(self._pending)
            self._pending = deque()
            self._ready.clear()
        if drained:
            self._slots.release(len(drained))
        return drained
