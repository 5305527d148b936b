"""The capture observatory: every CUDA graph capture as telemetry.

Counterpart of ``keystone_tpu/observability/compilelog.py``. The JAX
package watches XLA compiles: a ``jax.monitoring`` listener hears every
compile event, the jit sites it owns classify their triggers, and a
*warmup fence* turns any compile after warmup into a counted bug. The
port compiles nothing at run time; what it builds while it runs are
CUDA graph captures (a serving plane's bucket applies, the numerics
monitor's health word). So the port's observatory records captures:

* :func:`observed_capture` wraps one capture. It serializes the
  process's captures (a capture on one thread while another thread
  captures is undefined), times it and records it with its site name,
  its trigger (``admission``, ``bucket_miss``, ``monitor``), the
  attribution label of the innermost :func:`compile_context` and the
  fence label when a fence is armed.
* :class:`CompileObservatory` keeps the record tail and the aggregates
  and holds the fence (:meth:`~CompileObservatory.arm_fence` /
  :meth:`~CompileObservatory.disarm_fence`, a stack): a capture recorded
  while a fence is armed is *unexpected*. Each record feeds the
  ``compile.count`` and ``compile.unexpected_total`` counters and the
  ``compile.wall_s`` histogram, one ``compile:<site>`` span on the
  flight recorder and, when a trace is active, its ``compiles`` stream.
* :func:`capture_lock` holds the capture lock without recording (an
  admission's sizing probe, the release of graph pools);
* :func:`expect_no_compiles` arms a fence around a block;
  :func:`is_device_oom` recognizes a CUDA out-of-memory failure.

Where fences stand: the serving plane arms ``serving:steady-state``
once no admission is warming (a bucket captured after that is a
steady-state capture, counted unexpected), and ``fit_streaming`` arms
``fit_streaming:<tag>`` after its warm chunks. The executor's traced
node thunks run inside ``compile_context("node:<label>#<id>")``.

:func:`executable_table` is the per-site table in torch terms: each
capture site's captures, the replays of its graphs (``calls``, noted by
the replay sites through :func:`note_replay`) and its graph pool's
bytes. Every post-mortem embeds it, so a device-OOM dump says which
captured graphs held memory. Left out, being XLA's: the
``jax.monitoring`` listener, ``watch_jit`` / ``observed_jit``, the
jit-site signature classification and XLA's cost and memory analysis.
Observation
has no off switch here: a capture is rare and its record is cheap
beside it.

Thread model: captures happen on whatever thread admits a model or
serves a batch; the observatory's state is guarded by a plain lock (it
feeds the metrics registry and the flight recorder, the same boundary
as ``observability/metrics.py``).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from ..utils.guarded import guarded_by
from .metrics import MetricsRegistry
from .timeline import record_span
from .trace import current_trace

#: what starts a capture: a model's admission, a request for a bucket
#: that was never captured, the numerics monitor's health word
TRIGGERS = ("admission", "bucket_miss", "monitor")

_TLS = threading.local()

#: one capture at a time in the process (``torch.cuda.graph`` documents
#: the same restriction for its own captures)
_CAPTURE_LOCK = threading.Lock()


def _labels() -> List[str]:
    stack = getattr(_TLS, "labels", None)
    if stack is None:
        stack = _TLS.labels = []
    return stack


@contextlib.contextmanager
def compile_context(label: str) -> Iterator[None]:
    """Attribute any capture on this thread inside the block to
    ``label`` (the executor wraps traced node thunks in it)."""
    stack = _labels()
    stack.append(label)
    try:
        yield
    finally:
        stack.pop()


def _context_label() -> Optional[str]:
    stack = _labels()
    return stack[-1] if stack else None


@guarded_by("_lock", "records", "_wall_s", "_count", "_unexpected",
            "_fence_labels", "_by_name", "_sites")
class CompileObservatory:
    """Process-global capture log: a bounded record tail, exact
    aggregates, and the fence."""

    RECORD_TAIL = 512

    def __init__(self) -> None:
        self.records: List[Dict[str, Any]] = []
        self._wall_s = 0.0
        self._count = 0
        self._unexpected = 0
        self._fence_labels: List[str] = []
        self._by_name: Dict[str, int] = {}
        #: per capture site: captures, replays (calls), pool bytes
        self._sites: Dict[str, Dict[str, float]] = {}
        self._lock = threading.Lock()

    # -- the fence -------------------------------------------------------
    def arm_fence(self, label: str = "warmup") -> None:
        """End of a warmup: until :meth:`disarm_fence`, every recorded
        capture is unexpected. Arms nest as a stack; the innermost live
        label names an unexpected record."""
        with self._lock:
            self._fence_labels.append(label)

    def disarm_fence(self) -> None:
        with self._lock:
            if self._fence_labels:
                self._fence_labels.pop()

    @property
    def fenced(self) -> bool:
        with self._lock:
            return bool(self._fence_labels)

    # -- recording -------------------------------------------------------
    def record(self, *, name: str, wall_s: float, trigger: str,
               context: Optional[str] = None,
               t_start: Optional[float] = None,
               stats: Optional[Dict[str, float]] = None) -> None:
        """Fold one capture in: aggregates and the record tail under the
        lock, the metrics, span and trace fan-out outside it. (The JAX
        record's signature and its delta describe an XLA signature
        change; a capture has none.)"""
        wall_s = float(wall_s)
        entry: Dict[str, Any] = {"name": name, "wall_s": wall_s,
                                 "trigger": trigger}
        if context:
            entry["context"] = context
        if stats:
            entry["stats"] = stats
        with self._lock:
            unexpected = bool(self._fence_labels)
            if unexpected:
                entry["unexpected"] = True
                entry["fence"] = self._fence_labels[-1]
                self._unexpected += 1
            self._count += 1
            self._wall_s += wall_s
            self._by_name[name] = self._by_name.get(name, 0) + 1
            site = self._site(name)
            site["captures"] += 1
            if stats and "pool_nbytes" in stats:
                site["pool_nbytes"] = float(stats["pool_nbytes"])
            self.records.append(entry)
            if len(self.records) > self.RECORD_TAIL:
                del self.records[: len(self.records) - self.RECORD_TAIL]
        reg = MetricsRegistry.get_or_create()
        reg.counter("compile.count").inc()
        reg.histogram("compile.wall_s").observe(wall_s)
        if unexpected:
            reg.counter("compile.unexpected_total").inc()
        t0 = (time.perf_counter() - wall_s) if t_start is None else t_start
        record_span(f"compile:{name}", "compile", t0, wall_s, args={
            k: v for k, v in entry.items() if k not in ("name", "wall_s")})
        tr = current_trace()
        if tr is not None:
            tr.record_compile(dict(entry))

    def _site(self, name: str) -> Dict[str, float]:
        site = self._sites.get(name)
        if site is None:
            site = self._sites[name] = {
                "calls": 0, "captures": 0, "pool_nbytes": 0.0}
        return site

    def note_replay(self, name: str) -> None:
        """One replay of a graph captured at site ``name``."""
        with self._lock:
            self._site(name)["calls"] += 1

    def sites(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: dict(v) for k, v in self._sites.items()}

    # -- views -----------------------------------------------------------
    def wall_s_total(self) -> float:
        with self._lock:
            return self._wall_s

    def count_total(self) -> int:
        with self._lock:
            return self._count

    def unexpected_total(self) -> int:
        with self._lock:
            return self._unexpected

    def tail(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self.records]

    def unexpected_records(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self.records if e.get("unexpected")]

    def by_name(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._by_name)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "count": self._count,
                "wall_s": self._wall_s,
                "unexpected": self._unexpected,
                "by_name": dict(self._by_name),
                "tail": [dict(e) for e in self.records[-32:]],
            }


_OBSERVATORY: Optional[CompileObservatory] = None
_OBSERVATORY_LOCK = threading.Lock()


def compile_observatory() -> CompileObservatory:
    global _OBSERVATORY
    obs = _OBSERVATORY
    if obs is None:
        with _OBSERVATORY_LOCK:
            obs = _OBSERVATORY
            if obs is None:
                obs = _OBSERVATORY = CompileObservatory()
    return obs


def reset_compile_observatory() -> None:
    """Drop the global observatory (tests): records, aggregates and any
    fence a failed test left armed."""
    global _OBSERVATORY
    with _OBSERVATORY_LOCK:
        _OBSERVATORY = None


@contextlib.contextmanager
def observed_capture(name: str, trigger: str,
                     stats: Optional[Dict[str, float]] = None
                     ) -> Iterator[Dict[str, float]]:
    """Run one CUDA graph capture under the process's capture lock and
    record it when it completes (a capture that raises is not recorded:
    nothing was built). The yielded dict is the record's ``stats``,
    which the block may fill (pool bytes, launches recorded); after the
    block it also holds the capture's ``wall_s``."""
    if trigger not in TRIGGERS:
        raise ValueError(f"unknown capture trigger {trigger!r} "
                         f"(know {TRIGGERS})")
    stats = {} if stats is None else stats
    with _CAPTURE_LOCK:
        t0 = time.perf_counter()
        yield stats
        wall_s = time.perf_counter() - t0
    compile_observatory().record(name=name, wall_s=wall_s, trigger=trigger,
                                 context=_context_label(), t_start=t0,
                                 stats=dict(stats) or None)
    stats["wall_s"] = wall_s


def note_replay(name: str) -> None:
    """Count one replay of the graph captured at site ``name`` (the
    ``calls`` column of :func:`executable_table`)."""
    compile_observatory().note_replay(name)


def executable_table() -> List[Dict[str, Any]]:
    """Per capture site, in the JAX package's ``executable_table``
    shape: ``name``, ``calls`` (replays), ``captures`` and
    ``pool_nbytes`` (the site's last captured graph pool, as the capture
    measured it), for every site that captured or replayed."""
    return [{"name": name, **site}
            for name, site in sorted(compile_observatory().sites().items())
            if site["calls"] or site["captures"]]


@contextlib.contextmanager
def capture_lock() -> Iterator[None]:
    """Hold the process's capture lock without recording a capture: an
    admission's sizing probe (a measurement, not a served graph, which
    must never trip a fence), and the release of graph pools (emptying
    the allocator's cache must not overlap a capture)."""
    with _CAPTURE_LOCK:
        yield


@contextlib.contextmanager
def expect_no_compiles(label: str = "steady-state") -> Iterator[None]:
    """Arm the fence for the enclosed block (captures inside are
    unexpected); disarms even when the block raises."""
    obs = compile_observatory()
    obs.arm_fence(label)
    try:
        yield
    finally:
        obs.disarm_fence()


def is_device_oom(exc: BaseException) -> bool:
    """True for a device allocation failure: ``torch.cuda.
    OutOfMemoryError``, a ``MemoryError``, or a CUDA error whose text
    says out of memory."""
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return True
    text = str(exc)
    return ("CUDA out of memory" in text
            or "out of memory" in text
            or "cudaErrorMemoryAllocation" in text)
