"""Per-request causal tracing for the serving plane.

Counterpart of ``keystone_tpu/observability/reqtrace.py``. The
``serving.request_ms`` histogram says a tail moved, not where; this
module says where:

* :func:`mint_trace_id` / :func:`mint_flow_id` — process-unique ids. A
  trace id is minted at ``MicroBatcher.submit_request`` and carried on
  the ``Request`` across the worker-thread hop; the HTTP surface echoes
  it as the ``X-Keystone-Trace`` response header.
* :class:`ReqTrace` — ``perf_counter`` stamps at each edge of a
  request's life (enqueue, taken, dispatch, device done, respond). The
  phases are differences of adjacent stamps, so ``queue_wait +
  coalesce + dispatch + respond == request_ms`` exactly, and they feed
  the ``serving.phase_ms.<phase>`` histograms.
* :class:`ExemplarReservoir` — the slowest N completed traces per
  model (``GET /debug/slow``, and what an SLO post-mortem embeds),
  bounded by construction.
* :func:`tracing_suppressed` — suspends the plane for a block;
  ``KEYSTONE_TORCH_REQTRACE=0`` turns it off for the process.

Span linkage: the worker records one ``request:<model>`` span per
member and one ``batch:<model>`` span per executed batch; the request
spans carry ``flow_out`` ids and the batch span the matching
``flow_in`` list, which the flight recorder exports as flow events.

Thread model: handler threads mint traces; the worker that serves a
batch writes every later stamp of its members. The reservoir's
``_by_model`` is guarded by a plain lock; its ``_floor`` is rebound
only under it and read without it by the refusal fast path.
"""
from __future__ import annotations

import bisect
import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ..utils.guarded import guarded_by, hotpath, published_by

#: the phases, in lifecycle order (the batch-level ``drift_score`` phase
#: runs after the futures resolve, outside the per-request sum)
PHASES: Tuple[str, ...] = ("queue_wait", "coalesce", "dispatch", "respond")

# next() on an itertools.count is one C call, atomic under the GIL: the
# mint runs per request and takes no lock
_SEQ = itertools.count(1)
_PID_HEX = "%x" % os.getpid()

_SUPPRESS_DEPTH = 0


def mint_flow_id() -> int:
    """A process-unique increasing integer (flow ids, batch ids)."""
    return next(_SEQ)


def mint_trace_id(prefix: str = "req") -> str:
    """A process-unique trace id ``<prefix>-<pid hex>-<seq hex>``; the
    pid tells ids of different serving processes apart."""
    return f"{prefix}-{_PID_HEX}-{next(_SEQ):x}"


def tracing_enabled() -> bool:
    """The process switch: ``KEYSTONE_TORCH_REQTRACE=0`` mints no trace
    at all."""
    return os.environ.get("KEYSTONE_TORCH_REQTRACE", "1") != "0"


def tracing_active() -> bool:
    """Enabled, and not inside a :func:`tracing_suppressed` block."""
    return _SUPPRESS_DEPTH == 0 and tracing_enabled()


@contextlib.contextmanager
def tracing_suppressed() -> Iterator[None]:
    """Suspend request tracing (minting, stamps, phase histograms, spans,
    reservoir offers) for the block."""
    global _SUPPRESS_DEPTH
    _SUPPRESS_DEPTH += 1
    try:
        yield
    finally:
        _SUPPRESS_DEPTH -= 1


class ReqTrace:
    """One request's lifecycle stamps (``time.perf_counter`` seconds).

    ``enqueued_s`` is written by the submitting thread; every later stamp
    by the worker that serves the batch, ``responded_s`` before the
    request's future resolves, so a trace seen complete is immutable.
    ``trace_id`` is rendered lazily from ``flow_id``: one trace is built
    per request, and the string is read only by the response header,
    ``/debug/slow``, a post-mortem or a span."""

    __slots__ = ("flow_id", "model", "n", "enqueued_s", "taken_s",
                 "dispatch_s", "done_s", "responded_s", "bucket",
                 "fill", "batch_id")

    def __init__(self, flow_id: int, model: str, n: int,
                 enqueued_s: float):
        self.flow_id = flow_id
        self.model = model
        self.n = n
        self.enqueued_s = enqueued_s
        self.taken_s: Optional[float] = None      # popped by take
        self.dispatch_s: Optional[float] = None   # device work starts
        self.done_s: Optional[float] = None       # outputs on the host
        self.responded_s: Optional[float] = None  # slice delivered
        self.bucket: Optional[int] = None         # padded rows of batch
        self.fill: Optional[float] = None         # true rows / bucket rows
        self.batch_id: Optional[int] = None       # links batch members

    @property
    def trace_id(self) -> str:
        return f"req-{_PID_HEX}-{self.flow_id:x}"

    @classmethod
    @hotpath
    def new(cls, model: str, n: int) -> "ReqTrace":
        return cls(next(_SEQ), model, int(n), time.perf_counter())

    def complete(self) -> bool:
        return (self.responded_s is not None
                and self.done_s is not None
                and self.dispatch_s is not None
                and self.taken_s is not None)

    def request_ms(self) -> Optional[float]:
        if self.responded_s is None:
            return None
        return (self.responded_s - self.enqueued_s) * 1e3

    def phases_ms(self) -> Dict[str, float]:
        """The four phases; they sum to :meth:`request_ms` exactly.
        Empty until the trace is complete."""
        if not self.complete():
            return {}
        return {
            "queue_wait": (self.taken_s - self.enqueued_s) * 1e3,
            "coalesce": (self.dispatch_s - self.taken_s) * 1e3,
            "dispatch": (self.done_s - self.dispatch_s) * 1e3,
            "respond": (self.responded_s - self.done_s) * 1e3,
        }

    def tree(self) -> Dict[str, Any]:
        """JSON-able span tree: the request, its phases and the batch it
        rode (the ``/debug/slow`` body and an SLO post-mortem's
        exemplars)."""
        return {
            "trace_id": self.trace_id,
            "model": self.model,
            "n": self.n,
            "request_ms": (None if self.request_ms() is None
                           else round(self.request_ms(), 4)),
            "phases_ms": {k: round(v, 4)
                          for k, v in self.phases_ms().items()},
            "batch": {
                "id": self.batch_id,
                "bucket": self.bucket,
                "fill": None if self.fill is None else round(self.fill, 4),
            },
        }


def _env_cap() -> int:
    raw = os.environ.get("KEYSTONE_TORCH_EXEMPLARS")
    if not raw:
        return 8
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(
            f"KEYSTONE_TORCH_EXEMPLARS must be an integer, got {raw!r}"
        ) from None
    if cap < 1:
        raise ValueError("KEYSTONE_TORCH_EXEMPLARS must be >= 1")
    return cap


@published_by("_lock", "_floor")
@guarded_by("_lock", "_by_model")
class ExemplarReservoir:
    """The slowest N completed traces per model (N =
    ``KEYSTONE_TORCH_EXEMPLARS``, default 8). An offer is one lock and
    one scan of a short list; the common refusal (a full reservoir, a
    faster trace) is a dict read without the lock."""

    def __init__(self, cap: Optional[int] = None):
        self.cap = _env_cap() if cap is None else int(cap)
        if self.cap < 1:
            raise ValueError("cap must be >= 1")
        # model -> [(request_ms, flow_id, trace)], ascending request_ms
        self._by_model: Dict[str, List[Tuple[float, int, ReqTrace]]] = {}
        # model -> the fastest retained request_ms once the list is full
        self._floor: Dict[str, float] = {}
        self._lock = threading.Lock()

    @hotpath
    def offer(self, trace: ReqTrace) -> bool:
        """Keep ``trace`` if it is among the slowest ``cap`` of its model;
        returns whether it was kept."""
        ms = trace.request_ms()
        if ms is None:
            return False
        floor = self._floor.get(trace.model)
        if floor is not None and ms <= floor:
            return False
        key = (float(ms), trace.flow_id, trace)
        with self._lock:
            kept = self._by_model.setdefault(trace.model, [])
            if len(kept) >= self.cap:
                if ms <= kept[0][0]:
                    return False
                kept.pop(0)
            bisect.insort(kept, key)
            if len(kept) >= self.cap:
                self._floor[trace.model] = kept[0][0]
        return True

    def slowest(self, n: int = 8,
                model: Optional[str] = None) -> List[ReqTrace]:
        """The slowest ``n`` retained traces (one model, or all merged),
        slowest first."""
        with self._lock:
            if model is not None:
                pool = list(self._by_model.get(model, ()))
            else:
                pool = [e for kept in self._by_model.values() for e in kept]
        pool.sort(key=lambda e: (-e[0], e[1]))
        return [t for _, _, t in pool[:max(int(n), 0)]]

    def slowest_trees(self, n: int = 8,
                      model: Optional[str] = None) -> List[Dict[str, Any]]:
        return [t.tree() for t in self.slowest(n, model=model)]

    def clear(self) -> None:
        with self._lock:
            self._by_model = {}
            self._floor = {}


_RESERVOIR: Optional[ExemplarReservoir] = None
_RESERVOIR_LOCK = threading.Lock()


def exemplar_reservoir() -> ExemplarReservoir:
    """The process-global reservoir (built on first use)."""
    global _RESERVOIR
    res = _RESERVOIR
    if res is None:
        with _RESERVOIR_LOCK:
            res = _RESERVOIR
            if res is None:
                res = _RESERVOIR = ExemplarReservoir()
    return res


def reset_exemplars() -> None:
    """Drop the global reservoir (tests); the next offer rebuilds it and
    re-reads ``KEYSTONE_TORCH_EXEMPLARS``."""
    global _RESERVOIR
    with _RESERVOIR_LOCK:
        _RESERVOIR = None
