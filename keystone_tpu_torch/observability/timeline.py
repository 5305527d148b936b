"""Flight recorder: a bounded, always-on ring buffer of execution spans.

Counterpart of ``keystone_tpu/observability/timeline.py``. The
:class:`~.trace.PipelineTrace` says how long each node took; this module
says when everything ran and on which thread. It is fed by:

* the program's live spans (:func:`flight_span`), each named after its
  layer (``observability/names.py::SPAN_LAYERS``): the pipeline API's
  ``execute:fit`` / ``execute:get`` and its node spans
  ``<label>#<id>`` (while a trace or a profiler is active), the
  optimizer's ``optimize:<class>``, the block solver's
  ``factor:<site>`` and ``block:<site>``, ``fit_streaming``'s
  ``accumulate:<tag>`` (host time of the accumulate's launches; the
  device work runs on past them) and ``merge:<tag>``, and the streamed
  ingest's ``stall:<tag>`` (time the consumer's chunk loop waited for
  a chunk);
* the streaming prefetcher's ``stage:<tag>`` spans, one per chunk on
  the producer thread (host fill and the copy onto the side stream);
* the resilience and numerics event funnels, as instant events;
* contended :class:`~keystone_tpu_torch.utils.guarded.TracedLock`
  acquires (one span per lost race, on the losing thread);
* the serving plane's ``request:<model>`` / ``batch:<model>`` spans and
  the capture observatory's ``compile:<site>`` spans.

The serving worker does not build its spans on the request path: it
queues one thunk a batch (:meth:`FlightRecorder.defer`), and every view
of the ring (and the idle worker, and the HTTP scrape surface) runs the
queued thunks first (:meth:`FlightRecorder.flush`). A request span's
``flow_out`` and its batch span's ``flow_in`` export as Chrome flow
events, so the trace viewer draws each request into the batch it rode.

The ring holds ``KEYSTONE_TORCH_FLIGHT_SPANS`` spans (default 8192):
recording is a lock and two list writes, and old spans fall off the
back. A post-mortem, or an interpreter exit under a live stream, dumps
what the ring holds. :meth:`FlightRecorder.to_chrome_trace` exports it
as Chrome trace-event JSON (``chrome://tracing`` or
https://ui.perfetto.dev): one lane per thread, with overlapping spans of
one thread (nested executor nodes) moved to ``<thread> (nested k)``
lanes, so no lane holds two overlapping spans.

A live span is also a ``torch.profiler.record_function`` range of the
same name while a profiler records the calling thread, so a profiler
capture lays the program's layers against the device's kernels on the
profiler's clock. With no profiler running it costs one flag check
beside its ring write. (The profiler's flag is on only on the thread
that started it: the producer thread's ``stage:`` spans, recorded after
the fact, reach the ring alone.)

The ring's guard is a plain ``threading.Lock``: a contended TracedLock
reports into this recorder. ``KEYSTONE_TORCH_FLIGHT_RECORDER=0`` turns
recording off (a live span still opens its profiler range).
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterator, List, NamedTuple, \
    Optional

import torch

from ..utils.guarded import guarded_by


class Span(NamedTuple):
    """One recorded interval (or instant, ``ph == "i"``); times are
    ``time.perf_counter`` seconds."""

    name: str
    cat: str
    start_s: float
    dur_s: float
    tid: int
    thread: str
    args: Optional[Dict[str, Any]]
    ph: str


def _env_capacity() -> int:
    raw = os.environ.get("KEYSTONE_TORCH_FLIGHT_SPANS")
    if not raw:
        return 8192
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(f"KEYSTONE_TORCH_FLIGHT_SPANS must be an integer, "
                         f"got {raw!r}") from None
    if cap < 1:
        raise ValueError("KEYSTONE_TORCH_FLIGHT_SPANS must be >= 1")
    return cap


@guarded_by("_lock", "_ring", "_idx", "_total")
class FlightRecorder:
    """Bounded ring of :class:`Span` entries; see the module docstring."""

    def __init__(self, capacity: Optional[int] = None,
                 enabled: Optional[bool] = None):
        self.capacity = _env_capacity() if capacity is None else int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = (os.environ.get("KEYSTONE_TORCH_FLIGHT_RECORDER",
                                       "1") != "0"
                        if enabled is None else bool(enabled))
        self._ring: List[Optional[Span]] = [None] * self.capacity
        self._idx = 0
        self._total = 0
        self._lock = threading.Lock()  # plain: TracedLock reports in here
        #: queued materializers (deque appends and pops are atomic)
        self._deferred: Deque[Callable[[], None]] = deque(
            maxlen=self.capacity)
        #: perf_counter epoch of the exported timestamps
        self.t0_s = time.perf_counter()

    def record(self, name: str, cat: str, start_s: float, dur_s: float,
               args: Optional[Dict[str, Any]] = None,
               ph: str = "X", tid: Optional[int] = None,
               thread: Optional[str] = None) -> None:
        """Append one span. ``tid`` / ``thread`` replace the recording
        thread's identity (a deferred thunk passes the identity it
        captured, so its spans land on their thread's lane)."""
        if not self.enabled:
            return
        if tid is None or thread is None:
            t = threading.current_thread()
            tid = (t.ident or 0) if tid is None else tid
            thread = t.name if thread is None else thread
        span = Span(name, cat, float(start_s), float(dur_s), tid, thread,
                    args, ph)
        with self._lock:
            self._ring[self._idx] = span
            self._idx = (self._idx + 1) % self.capacity
            self._total += 1

    def defer(self, materialize: Callable[[], None]) -> None:
        """Queue a zero-argument thunk that records when the ring is
        next viewed. It must capture immutable data and its thread's
        identity."""
        if self.enabled:
            self._deferred.append(materialize)

    def flush(self) -> None:
        """Run the queued thunks, oldest first (outside the ring
        lock: they call :meth:`record`)."""
        while True:
            try:
                fn = self._deferred.popleft()
            except IndexError:
                return
            fn()

    def record_instant(self, name: str, cat: str,
                       ts_s: Optional[float] = None,
                       args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker (resilience and numerics events) at
        ``ts_s`` (``time.perf_counter()`` seconds; default now)."""
        self.record(name, cat,
                    time.perf_counter() if ts_s is None else ts_s,
                    0.0, args, ph="i")

    @contextlib.contextmanager
    def span(self, name: str, cat: str, **args: Any) -> Iterator[None]:
        """Record the enclosed block as one span, also when it raises;
        while a profiler records this thread, the block is also a
        ``record_function`` range named ``name``."""
        t0 = time.perf_counter()
        try:
            if torch.autograd._profiler_enabled():
                with torch.profiler.record_function(name):
                    yield
            else:
                yield
        finally:
            self.record(name, cat, t0, time.perf_counter() - t0,
                        args or None)

    def spans(self) -> List[Span]:
        """Retained spans, oldest first (queued thunks run first)."""
        self.flush()
        with self._lock:
            ring, idx, total = list(self._ring), self._idx, self._total
        if total < self.capacity:
            return [s for s in ring[:idx] if s is not None]
        return [s for s in ring[idx:] + ring[:idx] if s is not None]

    @property
    def total_recorded(self) -> int:
        with self._lock:
            return self._total

    def dropped(self) -> int:
        """Spans that fell off the back of the ring."""
        with self._lock:
            return max(0, self._total - self.capacity)

    def clear(self) -> None:
        self._deferred.clear()
        with self._lock:
            self._ring = [None] * self.capacity
            self._idx = 0
            self._total = 0

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The ring as a Chrome trace-event object. One lane per thread
        in first-seen order; a thread's spans are laid greedily onto
        sub-lanes (longer first at equal start, so a nested child
        overflows and not its parent), so no exported lane holds two
        overlapping ``"X"`` events. Instants ride lane 0 of their
        thread. A span with ``flow_out`` in its args starts a flow
        (``ph: "s"``) at its own place; one with ``flow_in`` ends one
        flow (``ph: "f"``) per id there."""
        events: List[Dict[str, Any]] = []
        lane_ids: Dict[tuple, int] = {}
        lane_names: Dict[int, str] = {}

        def lane(tid: int, thread: str, sub: int) -> int:
            if (tid, sub) not in lane_ids:
                lane_ids[(tid, sub)] = len(lane_ids) + 1
                lane_names[lane_ids[(tid, sub)]] = (
                    thread if sub == 0 else f"{thread} (nested {sub})")
            return lane_ids[(tid, sub)]

        def us(t: float) -> float:
            return round((t - self.t0_s) * 1e6, 3)

        by_thread: Dict[int, List[Span]] = {}
        for s in self.spans():
            by_thread.setdefault(s.tid, []).append(s)
        for tid, spans in by_thread.items():
            lane_end: List[float] = []
            for s in sorted((s for s in spans if s.ph == "X"),
                            key=lambda s: (s.start_s, -s.dur_s)):
                sub = 0
                while sub < len(lane_end) and s.start_s < lane_end[sub]:
                    sub += 1
                if sub == len(lane_end):
                    lane_end.append(0.0)
                lane_end[sub] = s.start_s + s.dur_s
                lid = lane(tid, s.thread, sub)
                events.append({"name": s.name, "cat": s.cat, "ph": "X",
                               "ts": us(s.start_s),
                               "dur": round(s.dur_s * 1e6, 3), "pid": 1,
                               "tid": lid, "args": s.args or {}})
                args = s.args or {}
                if "flow_out" in args:
                    events.append({"name": "req", "cat": s.cat, "ph": "s",
                                   "id": int(args["flow_out"]),
                                   "ts": us(s.start_s), "pid": 1,
                                   "tid": lid})
                for fid in args.get("flow_in", ()):
                    events.append({"name": "req", "cat": s.cat, "ph": "f",
                                   "bp": "e", "id": int(fid),
                                   "ts": us(s.start_s), "pid": 1,
                                   "tid": lid})
            for s in spans:
                if s.ph == "i":
                    events.append({"name": s.name, "cat": s.cat, "ph": "i",
                                   "s": "t", "ts": us(s.start_s), "pid": 1,
                                   "tid": lane(tid, s.thread, 0),
                                   "args": s.args or {}})
        meta = [{"name": "process_name", "ph": "M", "pid": 1,
                 "args": {"name": "keystone_tpu_torch"}}]
        for lid, lname in sorted(lane_names.items()):
            meta.append({"name": "thread_name", "ph": "M", "pid": 1,
                         "tid": lid, "args": {"name": lname}})
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_spans": self.dropped(),
                              "recorded_spans": self.total_recorded}}

    def to_chrome_json(self) -> str:
        return json.dumps(self.to_chrome_trace(), default=str)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_chrome_json())


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def flight_recorder() -> FlightRecorder:
    """The process-global recorder (built on first use)."""
    global _RECORDER
    rec = _RECORDER
    if rec is None:
        with _RECORDER_LOCK:
            rec = _RECORDER
            if rec is None:
                rec = _RECORDER = FlightRecorder()
    return rec


def reset_flight_recorder() -> None:
    """Drop the global recorder; the next record builds a fresh one and
    re-reads the environment (tests)."""
    global _RECORDER
    with _RECORDER_LOCK:
        _RECORDER = None


def record_span(name: str, cat: str, start_s: float, dur_s: float,
                args: Optional[Dict[str, Any]] = None) -> None:
    flight_recorder().record(name, cat, start_s, dur_s, args)


def record_instant(name: str, cat: str,
                   args: Optional[Dict[str, Any]] = None) -> None:
    flight_recorder().record_instant(name, cat, args=args)


def flight_span(name: str, cat: str, **args: Any
                ) -> contextlib.AbstractContextManager:
    """The program's one live span: :meth:`FlightRecorder.span` on the
    process-global recorder. ``name``'s head (the text before its first
    ``:``) names the layer, as ``observability/names.py::SPAN_LAYERS``
    lists; a name holding ``#`` is a pipeline node."""
    return flight_recorder().span(name, cat, **args)


def write_trace_artifact(path: str, trace=None) -> str:
    """A path ending ``.perfetto.json`` gets the flight recorder's Chrome
    trace; any other path the :class:`~.trace.PipelineTrace` JSON of
    ``trace``. Returns which was written (``"perfetto"`` / ``"trace"``)."""
    if str(path).endswith(".perfetto.json"):
        flight_recorder().dump(path)
        return "perfetto"
    if trace is None:
        raise ValueError("write_trace_artifact needs a PipelineTrace for a "
                         "path that does not end in .perfetto.json")
    with open(path, "w") as f:
        f.write(trace.to_json())
    return "trace"
