"""Declared lock discipline for shared mutable state.

Counterpart of ``keystone_tpu/utils/guarded.py``. The port is
concurrent: a prefetch producer thread per live stream, the serving
worker, HTTP handler threads and the resilience event funnel all mutate
shared state. This module names that discipline:

* :func:`guarded_by` declares which fields a lock attribute protects
  (``cls.__guarded_fields__`` at runtime, for introspection and tests).
* :class:`TracedLock` / :class:`TracedSemaphore` are the named
  primitives the concurrent parts use. A TracedLock's uncontended path
  is one non-blocking ``acquire``; a contended acquire feeds the
  ``lock.wait_s.<name>`` histogram and ``lock.contended_total`` counter,
  records one ``lock:<name>`` span on the losing thread (the flight
  recorder's lock lane) and, when a trace is active, the trace's
  per-lock wait table. The JAX package's schedule-harness yield points
  are not ported (the port has no schedule harness).

The metrics layer and the flight recorder keep plain locks: a contended
TracedLock reports into them, so tracing their own locks would re-enter
them. ``KEYSTONE_TORCH_TRACED_LOCKS=0`` turns the contention telemetry
off (the lock itself is unchanged).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, Optional


def guarded_by(lock_attr: str, *fields: str):
    """Class decorator declaring ``fields`` guarded by
    ``self.<lock_attr>``; the merged declaration (bases first) is
    ``cls.__guarded_fields__``."""
    if not fields:
        raise ValueError("guarded_by needs at least one field name")

    def wrap(cls):
        merged: Dict[str, str] = {}
        for klass in reversed(cls.__mro__):
            merged.update(getattr(klass, "__guarded_fields__", {}))
        merged.update({f: lock_attr for f in fields})
        cls.__guarded_fields__ = merged
        return cls

    return wrap


_TRACE_CONTENTION = os.environ.get("KEYSTONE_TORCH_TRACED_LOCKS", "1") != "0"


def _note_contention(name: str, wait_s: float) -> None:
    """A contended acquire: metrics, one span on the losing thread, and
    the active trace's wait table. Imported lazily: utils stays
    importable without the observability layer."""
    from ..observability.metrics import MetricsRegistry
    from ..observability.timeline import record_span
    from ..observability.trace import current_trace

    reg = MetricsRegistry.get_or_create()
    reg.counter("lock.contended_total").inc()
    reg.histogram(f"lock.wait_s.{name}").observe(wait_s)
    record_span(f"lock:{name}", "lock", time.perf_counter() - wait_s, wait_s)
    trace = current_trace()
    if trace is not None:
        trace.record_lock_wait(name, wait_s)


class TracedLock:
    """A named ``threading.Lock`` with contention telemetry; see the
    module docstring."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._lock.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._lock.acquire(True, timeout)
        if ok and _TRACE_CONTENTION:
            _note_contention(self.name, time.perf_counter() - t0)
        return ok

    def release(self) -> None:
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TracedSemaphore:
    """A named ``threading.Semaphore``. No contention metrics: a wait
    here is backpressure by design (the prefetcher's slot gate), which
    the consumer's stall histogram already measures."""

    __slots__ = ("name", "_sem")

    def __init__(self, name: str, value: int = 1):
        self.name = name
        self._sem = threading.Semaphore(value)

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        return self._sem.acquire(blocking, timeout)

    def release(self, n: int = 1) -> None:
        self._sem.release(n)
