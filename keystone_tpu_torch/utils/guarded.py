"""Declared lock discipline for shared mutable state.

Counterpart of ``keystone_tpu/utils/guarded.py``. The port is
concurrent: a prefetch producer thread per live stream, the serving
worker, HTTP handler threads and the resilience event funnel all mutate
shared state. This module declares that discipline, so the static
passes (``analysis/concurrency.py``, ``analysis/hotpath.py``) check it:

* :func:`guarded_by` declares which fields a lock attribute protects
  (``cls.__guarded_fields__`` at runtime); :data:`GUARDED_FIELDS` is the
  same declaration as a table, for classes that should not grow a
  decorator. :func:`guarded_fields` merges both.
* :func:`published_by` declares fields read LOCK-FREE on the serving
  path and written only by single-reference flips under the lock
  (``cls.__published_fields__``); :func:`hotpath` marks a request-path
  entry point. Both only stamp an attribute: they cost nothing at run
  time.
* :class:`TracedLock` / :class:`TracedSemaphore` are the named
  primitives the concurrent parts use. A TracedLock's uncontended path
  is one global read (the scheduler hook) and one non-blocking
  ``acquire``; a contended acquire feeds the ``lock.wait_s.<name>``
  histogram and ``lock.contended_total`` counter, records one
  ``lock:<name>`` span on the losing thread (the flight recorder's lock
  lane) and, when a trace is active, the trace's per-lock wait table.
  Both primitives call the hook set by :func:`set_sched_hook` at every
  operation: the yield points a seeded scheduler uses to force chosen
  interleavings (the schedule harness in
  ``tests/test_torch_concurrency_sched.py``).

The metrics layer and the flight recorder keep plain locks: a contended
TracedLock reports into them, so tracing their own locks would re-enter
them. ``KEYSTONE_TORCH_TRACED_LOCKS=0`` turns the contention telemetry
off (the lock itself is unchanged).
"""
from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Optional

#: lock discipline for classes that should not grow a decorator (merged
#: with ``@guarded_by`` declarations by the analyzer; keys are bare class
#: names, unique in this tree): the named fields may only be
#: read-modify-written or compound-mutated under ``with self.<lock>``
GUARDED_FIELDS: Dict[str, Dict[str, str]] = {
    # utils/lru.py: the captured-graph memo, shared by serving workers
    # and admissions
    "LruMemo": {"_entries": "_lock"},
}


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


def guarded_fields(cls) -> Dict[str, str]:
    """The merged field->lock declaration for ``cls`` (decorator first,
    then the :data:`GUARDED_FIELDS` table)."""
    out = dict(getattr(cls, "__guarded_fields__", {}))
    out.update(GUARDED_FIELDS.get(cls.__name__, {}))
    return out


def published_by(lock_attr: str, *fields: str):
    """Class decorator declaring ``fields`` PUBLISHED under
    ``self.<lock_attr>``: read lock-free on the serving path, and
    changed only by a single-reference flip (a whole rebind, one
    subscript store, or a single-key pop or del) while the lock is held.
    The publication passes (``analysis/hotpath.py``) read the
    declaration off the AST; at runtime the merged map is
    ``cls.__published_fields__``. Methods whose names end in ``_locked``
    count as holding the declared lock."""
    if not fields:
        raise ValueError("published_by needs at least one field name")

    def wrap(cls):
        merged: Dict[str, str] = {}
        for klass in reversed(cls.__mro__):
            merged.update(getattr(klass, "__published_fields__", {}))
        merged.update({f: lock_attr for f in fields})
        cls.__published_fields__ = merged
        return cls

    return wrap


def published_fields(cls) -> Dict[str, str]:
    """The merged field->lock publication declaration for ``cls``."""
    return dict(getattr(cls, "__published_fields__", {}))


def hotpath(fn):
    """Marker declaring a function a REQUEST-PATH ENTRY POINT: whatever
    is statically reachable from it is scanned by the hot-path passes
    (``analysis/hotpath.py``) for blocking calls, host-device syncs,
    I/O, lazy imports, unbounded growth and locks held across device
    work. It only stamps an attribute."""
    fn.__hotpath_entry__ = True
    return fn


#: when set (the schedule harness), every TracedLock / TracedSemaphore
#: operation calls it with a ``"<op>:<name>"`` tag. None in production:
#: the check is one global read per operation.
_SCHED_HOOK: Optional[Callable[[str], None]] = None


def set_sched_hook(hook: Optional[Callable[[str], None]]) -> None:
    """Install (or clear, with None) the schedule harness's yield hook."""
    global _SCHED_HOOK
    _SCHED_HOOK = hook


def sched_hook() -> Optional[Callable[[str], None]]:
    return _SCHED_HOOK


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
    """A named ``threading.Lock`` with contention telemetry and the
    schedule harness's yield points; see the module docstring."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        hook = _SCHED_HOOK
        if hook is not None:
            hook(f"lock.acquire:{self.name}")
            # a blocked waiter spins through the scheduler, so it parks
            # at a yield point instead of blocking the whole schedule
            deadline = (None if timeout is None or timeout < 0
                        else time.perf_counter() + timeout)
            while True:
                if self._lock.acquire(False):
                    return True
                if not blocking:
                    return False
                if deadline is not None and \
                        time.perf_counter() >= deadline:
                    return False
                hook(f"lock.wait:{self.name}")
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
        hook = _SCHED_HOOK
        if hook is not None:
            hook(f"lock.release:{self.name}")

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class TracedSemaphore:
    """A named ``threading.Semaphore`` with :class:`TracedLock`'s yield
    points. No contention metrics: a wait here is backpressure by design
    (the prefetcher's slot gate), which the consumer's stall histogram
    already measures."""

    __slots__ = ("name", "_sem")

    def __init__(self, name: str, value: int = 1):
        self.name = name
        self._sem = threading.Semaphore(value)

    def acquire(self, blocking: bool = True,
                timeout: Optional[float] = None) -> bool:
        hook = _SCHED_HOOK
        if hook is None:
            return self._sem.acquire(blocking, timeout)
        hook(f"sem.acquire:{self.name}")
        deadline = (None if timeout is None
                    else time.perf_counter() + timeout)
        while True:
            if self._sem.acquire(False):
                return True
            if not blocking:
                return False
            if deadline is not None and time.perf_counter() >= deadline:
                return False
            hook(f"sem.wait:{self.name}")

    def release(self, n: int = 1) -> None:
        self._sem.release(n)
        hook = _SCHED_HOOK
        if hook is not None:
            hook(f"sem.release:{self.name}")
