"""Streaming chunked execution: bounded, prefetched host-to-device ingest.

Counterpart of ``keystone_tpu/parallel/streaming.py`` on one device:

* `StreamingDataset` yields fixed-shape, zero-padded, masked
  `ArrayDataset` chunks from a host source. A producer thread stages the
  next chunks while the consumer computes on the current one; at most
  ``prefetch_depth`` chunks are staged at once, plus the one working
  chunk. Every chunk is padded to the same ``chunk_size`` rows.
* The accumulate/finalize protocol: a streamable estimator implements
  ``accumulate(carry, chunk[, labels_chunk]) -> carry`` and
  ``finalize(carry) -> Transformer``; `fit_streaming` drives the chunk
  loop. The least-squares estimators accumulate Gram and cross products
  through the fused Gram kernel (``ops/kernels.py::gram_cross``) and
  StandardScaler its moments, so a fit never holds the whole featurized
  matrix on the device.
* Dtype on the wire: ``wire_dtype`` narrows each host chunk before the
  copy (uint8 images cross PCIe at a quarter of the float32 bytes) and
  ``compute_dtype`` (default: the source's dtype) is what consumers see,
  restored by one cast on the device. One dtype applies to every leaf of
  a chunk. The residency ledger charges the post-cast working copy.

Staging on CUDA. The producer fills a small ring of pinned host buffers
and copies each chunk to the device on a side CUDA stream, recording an
event after the copy. A ring buffer is refilled only after the event of
the copy that last read it has completed. The consumer makes its current
stream wait on the chunk's event before using it and calls
``record_stream`` so the caching allocator cannot hand the chunk's
memory to another stream early. Staging slots are acquired before a
chunk is staged, so at most ``prefetch_depth`` chunks are staged-or-queued
and one is working: the device residency is ``(prefetch_depth + 1)``
chunks, which ``hbm_budget`` checks (statically before the first chunk,
and after every chunk).

Resilience (``keystone_tpu_torch/resilience``). Staging retries
transient failures under the stream's `RetryPolicy`; a retried attempt
refills its ring slot from the host chunk, and a slot is handed on only
once its copy is enqueued. The consumer's watchdog turns a producer that
died into `IngestTimeoutError` at once, and one that sends nothing for
``stall_timeout_s`` seconds into the same error, each with a
post-mortem. The fault sites are ``ingest.produce`` (per chunk, in the
producer loop) and ``ingest.stage`` (per staging attempt, after the host
fill; ``corrupt`` rules poison the host chunk before it is staged).
`fit_streaming` checkpoints its (cursor, carry, quarantine, sketch)
state every ``checkpoint_every`` chunks and resumes bit-identically,
runs the numerics plane's deferred health words and drift sketch over
the chunks it accumulates, and feeds the flight recorder's
``stage:<tag>`` (producer), ``stall:<tag>`` and ``accumulate:<tag>``
(consumer) lanes and the ``streaming.*`` metrics. An interpreter exit
under a live stream stops its producer and dumps a post-mortem.

``fit_streaming`` arms the capture observatory's fence after its warm
chunks.

The world loop (``parallel/distributed.py``). Under a world of more than
one rank each rank fits its shard-local stream and the ranks meet every
``checkpoint_every`` chunks (without checkpoints ``KEYSTONE_TORCH_COORD_ROUND_LEN``, 16 by default) in a :class:`~keystone_tpu_torch.parallel.
distributed.WorldCoordinator` round: a rank dispatches round k, folds
round k+1's chunks, and only then awaits round k, so every rank runs the
same rounds and a rank whose shard ends early keeps stepping with
``done`` until all are done. Checkpoints ride the rounds: at each
boundary a rank cuts a copy of its carry (``CarrySnapshot``, cloned on
the compute stream before the next chunk updates the carry in place),
writes it to its sidecar one boundary later, and reports the durable
cursor in the next round's payload; rank 0 merges the world snapshot
after awaiting a round in which every rank reported one. At finalize the
carries merge in rank order (``merge_carries``), every rank finalizes
the same merged carry, and the drift sketches merge likewise.
"""
from __future__ import annotations

import atexit
import os
import queue
import threading
import time
import weakref
from typing import (
    Any,
    Callable,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
)

import numpy as np
import torch

from ..observability.compilelog import compile_observatory
from ..observability.metrics import MetricsRegistry
from ..observability.postmortem import attach_postmortem, dump_postmortem
from ..observability.timeline import flight_span, record_span
from ..observability.trace import current_trace
from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..resilience.events import record_event
from ..resilience.faults import corrupt, inject
from ..resilience.retry import (
    IngestTimeoutError,
    RetryPolicy,
    default_retry_policy,
)
from ..utils.guarded import TracedLock, TracedSemaphore, guarded_by
from .distributed import WorldCoordinator, is_distributed
from .mesh import get_mesh
from .dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    _host,
    _pad_rows,
    is_streaming,
    to_numpy,
    tree_leaves,
    tree_map,
)

_DONE = object()


class _SourceError:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _LiveIteration:
    """A live ``chunks()`` iteration, as the exit teardown and the
    sampler's queue-depth probe see it."""

    __slots__ = ("stop", "producer", "queue", "__weakref__")

    def __init__(self, stop: threading.Event, q: queue.Queue):
        self.stop = stop
        self.queue = q
        self.producer: Optional[threading.Thread] = None


#: every live iteration; a finished one is garbage, not a leak
_LIVE_STREAMS: "weakref.WeakSet[_LiveIteration]" = weakref.WeakSet()


def staged_queue_depth() -> int:
    """Chunks staged and waiting in the queues of the live streams (the
    sampler's ``streaming.stage_queue_depth`` probe)."""
    return sum(it.queue.qsize() for it in list(_LIVE_STREAMS))


def _shutdown_live_streams() -> None:
    """Interpreter exit under a live stream: stop every producer, join it
    briefly (a producer may be mid-copy on its side stream; it must end
    before the CUDA context is torn down), and dump a post-mortem, so a
    killed fit still leaves its timeline."""
    live = list(_LIVE_STREAMS)
    for it in live:
        it.stop.set()
    for it in live:
        if it.producer is not None and it.producer is not \
                threading.current_thread():
            it.producer.join(timeout=2.0)
    if live:
        dump_postmortem("exit_under_active_stream",
                        {"live_streams": len(live)})


# threading._register_atexit callbacks run at threading shutdown, before
# the interpreter tears modules (and torch's CUDA context) down; plain
# atexit would run too late
getattr(threading, "_register_atexit", atexit.register)(
    _shutdown_live_streams)


def _rebuild(tree: Any, leaves: Iterator[Any]) -> Any:
    """``tree``'s tuple structure filled with ``leaves`` in order."""
    if isinstance(tree, (tuple, list)):
        return tuple(_rebuild(t, leaves) for t in tree)
    return next(leaves)


def _torch_dtype(dt: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dt)).dtype


class _IterLedger:
    """One live ``chunks()`` iteration's share of the shared residency,
    so that concurrent iterations of views of one root compose."""

    __slots__ = ("buffered", "working")

    def __init__(self) -> None:
        self.buffered = 0.0
        self.working = 0.0


@guarded_by("_lock", "buffered", "working", "chunk_nbytes", "peak")
class _Residency:
    """Thread-safe device-residency ledger of one prefetch pipeline:
    bytes staged in the queue plus working chunks, with a high-water
    mark. Shared by a root stream and every view derived from it. Its
    lock is a TracedLock: producer/consumer contention shows."""

    def __init__(self) -> None:
        self._lock = TracedLock("stream.residency")
        self.buffered = 0.0
        self.working = 0.0
        self.chunk_nbytes = 0.0
        self.peak = 0.0

    def stage(self, it: _IterLedger, nbytes: float) -> None:
        with self._lock:
            self.chunk_nbytes = nbytes
            it.buffered += nbytes
            self.buffered += nbytes
            self.peak = max(self.peak, self.buffered + self.working)

    def hand_off(self, it: _IterLedger, staged_nbytes: float,
                 work_nbytes: float, transient: float = 0.0) -> None:
        """One chunk leaves the buffer and becomes this iteration's
        working chunk (its previous working chunk is released).
        ``transient`` charges the wire copy that co-exists with the cast
        output while the cast runs."""
        with self._lock:
            self.buffered -= staged_nbytes
            it.buffered -= staged_nbytes
            self.working += work_nbytes - it.working
            it.working = work_nbytes
            self.peak = max(self.peak,
                            self.buffered + self.working + transient)

    def close(self, it: _IterLedger) -> None:
        """Remove one finished iteration's remaining contribution."""
        with self._lock:
            self.buffered -= it.buffered
            self.working -= it.working
            it.buffered = 0.0
            it.working = 0.0

    def live(self) -> float:
        with self._lock:
            return self.buffered + self.working


class _Stager:
    """Host-to-device copies for one ``chunks()`` iteration, run on the
    producer thread. On the CPU a chunk is a fresh padded array. On CUDA
    it is copied from a ring of pinned buffers on a side stream; the
    returned event marks the end of the copy. The ``ingest.stage`` fault
    site sits between the host fill and the copy: a failed attempt
    leaves its slot unclaimed, and the retry refills it from the host
    chunk."""

    def __init__(self, device: torch.device, ring: int):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            if device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.stream = torch.cuda.Stream(self.device)
            self.ring: List[Optional[List[torch.Tensor]]] = [None] * ring
            self.events: List[Optional[torch.cuda.Event]] = [None] * ring
            self.next_slot = 0

    @staticmethod
    def _fill(dst: np.ndarray, src: np.ndarray, rows: int) -> None:
        # the wire cast and the zero padding in one host pass
        np.copyto(dst[:rows], src, casting="unsafe")
        dst[rows:] = 0

    def stage(self, leaves: List[np.ndarray], rows: int, chunk_size: int,
              wire: List[np.dtype], context: str):
        shapes = [(chunk_size,) + x.shape[1:] for x in leaves]
        if not self.cuda:
            out = []
            for x, shape, dt in zip(leaves, shapes, wire):
                buf = np.empty(shape, dt)
                self._fill(buf, x, rows)
                out.append(torch.from_numpy(buf))
            inject("ingest.stage", context=context)
            return out, None
        slot = self.next_slot % len(self.ring)
        if self.events[slot] is not None:
            # the copy that last read this pinned buffer must be done
            self.events[slot].synchronize()
        bufs = self.ring[slot]
        if bufs is None or [tuple(b.shape) for b in bufs] != shapes:
            bufs = [torch.empty(shape, dtype=_torch_dtype(dt),
                                pin_memory=True)
                    for shape, dt in zip(shapes, wire)]
            self.ring[slot] = bufs
        for buf, x in zip(bufs, leaves):
            self._fill(buf.numpy(), x, rows)
        inject("ingest.stage", context=context)
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                   for b in bufs]
            for dst, src in zip(out, bufs):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        # the slot is claimed only once its copy is enqueued
        self.events[slot] = event
        self.next_slot += 1
        return out, event


class StreamingDataset(Dataset):
    """Chunked, prefetched view of a host data source.

    ``chunk_source`` is a callable returning a fresh iterator of host
    chunks, so the stream can be iterated again (a multi-pass fit opens
    it once per pass). Each host chunk is a numpy array, or a tuple of
    them, with at most ``chunk_size`` rows. Chunks are padded with zero
    rows to exactly ``chunk_size``, staged on ``device`` by a producer
    thread, and yielded as masked `ArrayDataset`s whose ``n`` is the
    chunk's true row count.

    ``n`` (the total item count) may be unknown (None); a completed pass
    pins it. ``hbm_budget`` (bytes), when given, is the residency bound a
    streamed fit of this stream or of a view of it checks.
    ``retry_policy`` (default: the shared default policy) retries
    staging; ``stall_timeout_s`` (default None: no deadline) arms the
    consumer's watchdog; ``quarantine`` is the corrupt-record quarantine
    the source feeds, which a streamed fit checkpoints. ``mesh`` (default
    the global mesh) must hold this rank alone: in a world each rank
    streams its own shard (:func:`~keystone_tpu_torch.parallel.mesh.
    local_mesh`) and the stream is refused otherwise."""

    def __init__(self, chunk_source: Callable[[], Iterator[Any]],
                 chunk_size: int, n: Optional[int] = None,
                 mesh: Any = None, prefetch_depth: int = 2,
                 tag: Optional[str] = None,
                 retry_policy: Optional[RetryPolicy] = None,
                 stall_timeout_s: Optional[float] = None,
                 quarantine: Any = None, wire_dtype: Any = None,
                 compute_dtype: Any = None,
                 _transforms: Tuple[Callable, ...] = (), *,
                 device=DEFAULT_DEVICE,
                 hbm_budget: Optional[float] = None):
        if not callable(chunk_source):
            raise TypeError(
                "chunk_source must be a callable returning a fresh chunk "
                "iterator (a one-shot generator cannot be iterated again; "
                "wrap its construction in a function)")
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.mesh = mesh if mesh is not None else get_mesh()
        if not self.mesh.is_local():
            # a streamed fit in a world is shard-local: each rank stages
            # only its own chunks onto its own device, and fit_streaming
            # merges the carries at finalize
            raise ValueError(
                f"StreamingDataset mesh {self.mesh!r} holds other ranks: "
                "streamed ingest in a world is shard-local (each rank "
                "stages its own chunks onto its own device and "
                "fit_streaming merges the carries at finalize). Build the "
                "stream under parallel.mesh.local_mesh() (mesh_scope or "
                "mesh=)")
        self.device = resolve_device(device)
        self.chunk_size = int(chunk_size)
        self.n = None if n is None else int(n)
        self.prefetch_depth = int(prefetch_depth)
        self.tag = tag
        self.wire_dtype = None if wire_dtype is None else np.dtype(wire_dtype)
        self.compute_dtype = (None if compute_dtype is None
                              else np.dtype(compute_dtype))
        self.hbm_budget = None if hbm_budget is None else float(hbm_budget)
        self.retry_policy = retry_policy
        self.stall_timeout_s = (None if stall_timeout_s is None
                                else float(stall_timeout_s))
        self.quarantine = quarantine
        self._chunk_source = chunk_source
        self._transforms = tuple(_transforms)
        # shared between a root stream and every view derived from it:
        # only one prefetch pipeline runs per iteration of the root
        self._residency = _Residency()
        #: per-leaf (item shape, source dtype) when known without
        #: consuming the stream (numpy-backed sources), else None
        self._element: Optional[List[Tuple[tuple, np.dtype]]] = None

    # -- derivation --------------------------------------------------------
    def _derive(self, transform: Callable[[ArrayDataset], ArrayDataset]
                ) -> "StreamingDataset":
        out = StreamingDataset(
            self._chunk_source, self.chunk_size, n=self.n,
            device=self.device, prefetch_depth=self.prefetch_depth,
            tag=self.tag, wire_dtype=self.wire_dtype,
            compute_dtype=self.compute_dtype, hbm_budget=self.hbm_budget,
            retry_policy=self.retry_policy,
            stall_timeout_s=self.stall_timeout_s, quarantine=self.quarantine,
            mesh=self.mesh, _transforms=self._transforms + (transform,))
        out._residency = self._residency
        out._element = self._element
        if getattr(self, "process_sharded", False):
            # a view of a rank-local stream is rank-local too
            out.process_sharded = True
        return out

    def map(self, fn: Callable[[Any], Any]) -> "StreamingDataset":
        """Per-item transform, applied chunk-wise (lazy: nothing runs
        until the stream is consumed)."""
        return self._derive(lambda ad: ad.map(fn))

    def map_chunks(self, fn: Callable[[ArrayDataset], ArrayDataset]
                   ) -> "StreamingDataset":
        """Chunk-level transform (an ``ArrayDataset -> ArrayDataset``
        function, e.g. a transformer's ``apply_dataset``), lazy."""
        return self._derive(fn)

    def __len__(self) -> int:
        if self.n is None:
            raise TypeError(
                "StreamingDataset length is unknown (n=None); consume the "
                "stream or construct it with an explicit n")
        return self.n

    # -- iteration ---------------------------------------------------------
    def _host_leaves(self, raw: Any):
        leaves = [x.cpu().numpy() if isinstance(x, torch.Tensor)
                  else np.asarray(x) for x in tree_leaves(raw)]
        if not leaves:
            raise ValueError("empty chunk from source")
        rows = int(leaves[0].shape[0])
        if rows > self.chunk_size:
            raise ValueError(f"source chunk has {rows} rows > chunk_size "
                             f"{self.chunk_size}")
        if any(x.shape[0] != rows for x in leaves):
            raise ValueError("chunk leaves differ in their row counts")
        return leaves, rows

    def chunks(self) -> Iterator[ArrayDataset]:
        """Iterate device chunks with background prefetch. Each call
        re-opens the source (a fresh epoch); leaving the loop early stops
        the producer thread."""
        reg = MetricsRegistry.get_or_create()
        tag = self.tag or "stream"
        policy = self.retry_policy or default_retry_policy()
        q: queue.Queue = queue.Queue()
        # the bound is the slots, acquired BEFORE staging: gating the
        # queue alone would let the producer stage chunk depth + 1 while
        # it waits for room, putting depth + 2 chunks on the device
        slots = TracedSemaphore("stream.slots", self.prefetch_depth)
        stop = threading.Event()
        live = _LiveIteration(stop, q)
        _LIVE_STREAMS.add(live)
        ledger = _IterLedger()
        stager = _Stager(self.device, self.prefetch_depth)

        def acquire_slot() -> bool:
            while not stop.is_set():
                if slots.acquire(timeout=0.05):
                    return True
            return False

        def produce():
            try:
                produced = 0
                for raw in self._chunk_source():
                    inject("ingest.produce", context=tag, abort=stop.is_set)
                    if not acquire_slot():
                        return
                    t0 = time.perf_counter()
                    raw = corrupt("ingest.stage", raw, context=tag)
                    leaves, rows = self._host_leaves(raw)
                    wire = [self.wire_dtype or x.dtype for x in leaves]
                    target = [self.compute_dtype or x.dtype for x in leaves]
                    staged, event = policy.call(
                        stager.stage, leaves, rows, self.chunk_size, wire,
                        tag, site="ingest.stage")
                    nbytes = float(sum(t.element_size() * t.numel()
                                       for t in staged))
                    work = float(sum(t.numel() * dt.itemsize
                                     for t, dt in zip(staged, target)))
                    cast = [None if dt == w else _torch_dtype(dt)
                            for dt, w in zip(target, wire)]
                    record_span(f"stage:{tag}", "ingest", t0,
                                time.perf_counter() - t0,
                                args={"chunk": produced, "h2d_bytes": nbytes})
                    produced += 1
                    reg.counter("streaming.h2d_bytes").inc(nbytes)
                    self._residency.stage(ledger, nbytes)
                    q.put((raw, staged, rows, nbytes, work, cast, event))
                q.put(_DONE)
            except BaseException as exc:  # raised again on the consumer
                q.put(_SourceError(exc))
            finally:
                if stop.is_set():
                    # the consumer left early and may have closed the
                    # ledger while this thread was still staging
                    self._residency.close(ledger)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="keystone-torch-stream-prefetch")
        live.producer = producer
        producer.start()
        seen = rows_seen = 0
        complete = False
        trace = current_trace()

        def watchdog_error(reason: str, msg: str, **extra) -> BaseException:
            record_event("watchdog_trip", source=tag, reason=reason,
                         chunk=seen, **extra)
            return attach_postmortem(
                IngestTimeoutError(f"stream {self.tag or '<untagged>'}: "
                                   f"{msg}"),
                "ingest_timeout",
                {"source": tag, "reason": reason, "chunk": seen, **extra})

        def get_with_watchdog(t0: float):
            """``q.get`` that wakes once a second to notice a dead
            producer and, with ``stall_timeout_s``, enforces the ingest
            deadline. Free while chunks flow."""
            deadline = (None if self.stall_timeout_s is None
                        else t0 + self.stall_timeout_s)
            while True:
                wait = 1.0
                if deadline is not None:
                    wait = min(wait, max(deadline - time.perf_counter(),
                                         0.01))
                try:
                    return q.get(timeout=wait)
                except queue.Empty:
                    if not producer.is_alive() and q.empty():
                        raise watchdog_error(
                            "producer_died", "the producer thread died "
                            f"without completing the stream (after chunk "
                            f"{seen})")
                    if deadline is not None and \
                            time.perf_counter() >= deadline:
                        stalled = time.perf_counter() - t0
                        raise watchdog_error(
                            "stall_deadline",
                            f"no chunk from the producer in {stalled:.1f}s "
                            f"(stall_timeout_s={self.stall_timeout_s:g}, "
                            f"after chunk {seen}; producer thread alive): "
                            "a hung source? Raise stall_timeout_s if the "
                            "source is this slow.", stall_s=stalled)

        try:
            while True:
                t0 = time.perf_counter()
                with flight_span(f"stall:{tag}", "ingest", chunk=seen):
                    item = get_with_watchdog(t0)
                stall = time.perf_counter() - t0
                if item is _DONE:
                    complete = True
                    break
                if isinstance(item, _SourceError):
                    raise item.exc
                raw, staged, rows, nbytes, work, cast, event = item
                occupancy = q.qsize()
                needs_cast = any(c is not None for c in cast)
                self._residency.hand_off(
                    ledger, nbytes, work,
                    transient=nbytes if needs_cast else 0.0)
                # the chunk left the buffer: the producer may stage the
                # next one while this one computes
                slots.release()
                reg.histogram("streaming.ingest_stall_s").observe(stall)
                reg.gauge("streaming.prefetch_occupancy").set(occupancy)
                reg.counter("streaming.chunks_total").inc()
                reg.gauge("streaming.resident_bytes").set(
                    self._residency.live())
                if trace is not None:
                    trace.record_chunk({
                        "source": tag, "chunk": seen, "n": rows,
                        "padded_n": self.chunk_size, "nbytes": work,
                        "h2d_bytes": nbytes, "ingest_stall_s": stall,
                        "prefetch_occupancy": occupancy})
                if event is not None:
                    current = torch.cuda.current_stream(staged[0].device)
                    current.wait_event(event)
                    for t in staged:
                        t.record_stream(current)
                staged = [t if c is None else t.to(c)
                          for t, c in zip(staged, cast)]
                out = ArrayDataset(_rebuild(raw, iter(staged)), rows)
                item = raw = staged = None
                for f in self._transforms:
                    out = f(out)
                yield out
                seen += 1
                rows_seen += rows
        finally:
            stop.set()
            # join before closing the ledger: a producer still staging
            # would otherwise charge the ledger after it was closed
            producer.join(timeout=5.0)
            self._residency.close(ledger)
            _LIVE_STREAMS.discard(live)
        if complete and self.n is None:
            self.n = rows_seen

    def __iter__(self) -> Iterator[ArrayDataset]:
        return self.chunks()

    # -- residency ---------------------------------------------------------
    def buffered_nbytes(self) -> float:
        """Current device residency of the stream's prefetch pipeline:
        chunks staged plus working chunks (``dataset.device_nbytes``
        reports this for streams)."""
        return self._residency.live()

    def chunk_nbytes(self) -> float:
        """Bytes of the last chunk staged, at its wire width."""
        return self._residency.chunk_nbytes

    @property
    def peak_device_nbytes(self) -> float:
        """High-water mark of the residency, shared by a root stream and
        its views."""
        return self._residency.peak

    def plan_geometry(self):
        """The static chunk geometry
        (:class:`~keystone_tpu_torch.analysis.resources.StreamGeometry`),
        or None when the source's items cannot be described without
        consuming it."""
        from ..analysis.resources import StreamGeometry

        if self._element is None:
            return None
        wire_row = work_row = 0.0
        cast = False
        for shape, src in self._element:
            size = float(int(np.prod(shape, dtype=np.int64)))
            wire = self.wire_dtype or src
            comp = self.compute_dtype or src
            wire_row += size * wire.itemsize
            work_row += size * comp.itemsize
            cast = cast or wire != comp
        return StreamGeometry(self.chunk_size, self.prefetch_depth,
                              wire_row, work_row, cast)

    def static_plan_nbytes(self) -> Optional[float]:
        """The residency bound of one live iteration, computed without
        touching the source: the static planner's charge at this
        stream's node (``analysis.resources.stream_plan_nbytes``, one
        sizer for both); None for an opaque source."""
        from ..analysis.resources import stream_plan_nbytes

        return stream_plan_nbytes(self)

    # -- identity (the resume fingerprint) ----------------------------------
    def element(self) -> Optional[Tuple[Tuple[tuple, str], ...]]:
        """Per-leaf ``(item shape, dtype name)`` as consumers see it
        (the compute dtype where one is set), or None for an opaque
        source."""
        if self._element is None:
            return None
        return tuple((tuple(int(d) for d in shape),
                      (self.compute_dtype or src).name)
                     for shape, src in self._element)

    def wire_dtype_name(self) -> Optional[str]:
        """The explicit wire dtype's name (None: each leaf's own)."""
        return None if self.wire_dtype is None else self.wire_dtype.name

    def compute_dtype_name(self) -> Optional[str]:
        """The explicit compute dtype's name (None: each leaf's own)."""
        return (None if self.compute_dtype is None
                else self.compute_dtype.name)

    # -- materialization ---------------------------------------------------
    def materialize(self) -> ArrayDataset:
        """Collect every chunk into one resident ArrayDataset (tests and
        small streams; a fit never needs it)."""
        parts, n = [], 0
        for chunk in self.chunks():
            parts.append(chunk.numpy())
            n += chunk.n
        if not parts:
            raise ValueError("empty stream")
        stacked = tree_map(lambda *xs: np.concatenate(xs, axis=0), *parts)
        return ArrayDataset.from_numpy(stacked, self.device, tag=self.tag)

    def collect(self) -> List[Any]:
        return self.materialize().collect()

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_chunks(factory: Callable[[], Iterator[Any]], chunk_size: int,
                    n: Optional[int] = None, **kw) -> "StreamingDataset":
        """Stream pre-stacked host chunks from ``factory()``."""
        return StreamingDataset(factory, chunk_size, n=n, **kw)

    @staticmethod
    def from_numpy(array: Any, chunk_size: int, mesh: Any = None,
                   **kw) -> "StreamingDataset":
        """Chunk a resident host array, or tuple of arrays (the parity
        path, and the way to bound device memory when host memory holds
        what the device cannot)."""
        array = tree_map(lambda x: x.cpu().numpy()
                         if isinstance(x, torch.Tensor) else np.asarray(x),
                         array)
        leaves = tree_leaves(array)
        total = int(leaves[0].shape[0])

        def chunked():
            for lo in range(0, total, chunk_size):
                yield tree_map(lambda x: x[lo:lo + chunk_size], array)

        out = StreamingDataset(chunked, chunk_size, n=total, mesh=mesh, **kw)
        out._element = [(x.shape[1:], x.dtype) for x in leaves]
        return out

    @staticmethod
    def from_items(items: Optional[Sequence[Any]] = None, *,
                   source: Optional[Callable[[], Iterable[Any]]] = None,
                   chunk_size: int = 256, **kw) -> "StreamingDataset":
        """Stream per-item arrays (or tuples of them): a sequence, or
        ``source=``, a callable returning a fresh iterable of items. The
        items are stacked into host chunks of ``chunk_size`` rows with
        numpy, in their own dtype, so uint8 items cross the link as
        uint8 whatever ``compute_dtype`` the consumers see."""
        if (items is None) == (source is None):
            raise TypeError("pass exactly one of items or source=")
        seq: List[Any] = []
        if source is None:
            seq = list(items)
            source = lambda: iter(seq)  # noqa: E731
            kw.setdefault("n", len(seq))

        def stack(buf):
            return tree_map(lambda *xs: np.stack([_host(x) for x in xs]),
                            *buf)

        def chunked():
            buf: List[Any] = []
            for it in source():
                buf.append(it)
                if len(buf) == chunk_size:
                    yield stack(buf)
                    buf = []
            if buf:
                yield stack(buf)

        out = StreamingDataset(chunked, chunk_size, **kw)
        if seq:
            out._element = [(_host(x).shape, _host(x).dtype)
                            for x in tree_leaves(seq[0])]
        return out

    @staticmethod
    def from_host_dataset(ds: HostDataset, chunk_size: int,
                          **kw) -> "StreamingDataset":
        """Stream a HostDataset of fixed-shape items."""
        return StreamingDataset.from_items(ds.items, chunk_size=chunk_size,
                                           **kw)


# -- accumulate/finalize protocol ------------------------------------------

def is_streamable(estimator: Any) -> bool:
    """True when ``estimator`` implements the streaming fit protocol:
    ``accumulate(carry, chunk[, labels_chunk])`` and ``finalize(carry)``."""
    return callable(getattr(estimator, "accumulate", None)) and callable(
        getattr(estimator, "finalize", None))


def _non_streamable_error(estimator: Any) -> TypeError:
    label = getattr(estimator, "label", None)
    name = label() if callable(label) else type(estimator).__name__
    return TypeError(
        f"estimator {name!r} cannot fit a StreamingDataset: it does not "
        "implement the streaming protocol (accumulate(carry, chunk[, "
        "labels]) / finalize(carry)). Materialize the stream first "
        "(StreamingDataset.materialize()) if it fits on the device, or use "
        "a streamable estimator (LinearMap / BlockLeastSquares, "
        "StandardScaler).")


def _resident_labels(labels: Any, device: torch.device) -> torch.Tensor:
    """Resident labels as one tensor of true rows on ``device``."""
    if hasattr(labels, "get") and not isinstance(labels, Dataset):
        labels = labels.get()  # a lazy pipeline result
    if isinstance(labels, ArrayDataset):
        if isinstance(labels.data, (tuple, list)):
            raise TypeError("resident labels must be one tensor")
        out = labels.data[: labels.n]
    elif isinstance(labels, torch.Tensor):
        out = labels
    else:
        out = torch.as_tensor(to_numpy(labels))
    return out.to(device)


def _paired_chunks(data: StreamingDataset, labels: Any
                   ) -> Iterator[Tuple[ArrayDataset, Optional[ArrayDataset]]]:
    """Yield (data_chunk, labels_chunk) pairs with the same padded rows.

    ``labels`` may be None (plain estimators), an aligned
    StreamingDataset (chunk row counts must match), or resident labels
    sliced by running offset (labels are k-wide, small next to the
    streamed features)."""
    if labels is None:
        for chunk in data.chunks():
            yield chunk, None
        return
    if is_streaming(labels):
        data_it, labels_it = data.chunks(), labels.chunks()
        try:
            for chunk in data_it:
                lchunk = next(labels_it, None)
                if lchunk is None:
                    raise ValueError(
                        "labels stream ended before the data stream")
                if lchunk.n != chunk.n:
                    raise ValueError(
                        f"misaligned streams: data chunk has {chunk.n} "
                        f"rows, labels chunk has {lchunk.n}")
                yield chunk, lchunk
            # leftover label chunks mean the pairs were row-shifted:
            # truncating silently would fit a wrong model
            if next(labels_it, None) is not None:
                raise ValueError("misaligned streams: labels stream has "
                                 "more rows than the data stream")
        finally:
            data_it.close()
            labels_it.close()
        return
    host = _resident_labels(labels, data.device)
    off = 0
    chunks = data.chunks()
    try:
        for chunk in chunks:
            rows = host[off:off + chunk.n]
            if rows.shape[0] != chunk.n:
                raise ValueError(
                    f"labels exhausted at row {off}: the stream yielded "
                    f"more rows than len(labels)={host.shape[0]}")
            off += chunk.n
            yield chunk, ArrayDataset(_pad_rows(rows, chunk.padded_n),
                                      chunk.n)
    finally:
        chunks.close()
    if off != host.shape[0]:
        raise ValueError(
            f"misaligned labels: the data stream yielded {off} rows but "
            f"len(labels)={host.shape[0]}; refusing to truncate silently")


def _carry_nbytes(carry: Any) -> float:
    if isinstance(carry, (tuple, list)):
        return sum(_carry_nbytes(x) for x in carry)
    if isinstance(carry, torch.Tensor):
        return float(carry.element_size() * carry.numel())
    return 0.0


#: chunks a world folds per coordination round when it does not
#: checkpoint (with checkpoints, ``checkpoint_every``) and
#: ``KEYSTONE_TORCH_COORD_ROUND_LEN`` is unset
_ROUND_LEN = 16


def _coord_round_len(checkpoint_every: Optional[int] = None) -> int:
    """Chunks a world folds per coordination round: ``checkpoint_every``
    where the fit checkpoints (a snapshot lands on a round boundary),
    else ``KEYSTONE_TORCH_COORD_ROUND_LEN`` (default 16). Longer rounds
    mean fewer gathers and a later view of a dead peer."""
    if checkpoint_every is not None:
        return int(checkpoint_every)
    raw = os.environ.get("KEYSTONE_TORCH_COORD_ROUND_LEN", str(_ROUND_LEN))
    try:
        round_len = int(raw)
    except ValueError:
        raise ValueError(
            "KEYSTONE_TORCH_COORD_ROUND_LEN must be an integer (chunks "
            f"folded per coordination round), got {raw!r}") from None
    if round_len < 1:
        raise ValueError(
            f"KEYSTONE_TORCH_COORD_ROUND_LEN must be >= 1, got {round_len}")
    return round_len


#: chunks a streamed fit runs before it arms its capture fence: the
#: numerics monitor computes the first chunk's health word eagerly and
#: captures the word's CUDA graph at the second
_WARM_CHUNKS = 2


def fit_streaming(estimator: Any, data: StreamingDataset, labels: Any = None,
                  hbm_budget: Optional[float] = None,
                  checkpoint_dir: Optional[str] = None,
                  checkpoint_every: Optional[int] = None,
                  quarantine: Any = None):
    """Drive a streamable estimator over a chunked dataset: one
    ``accumulate`` per chunk, then ``finalize``. Only the carry (Gram,
    cross products, moments) and the bounded prefetch buffer live on the
    device, never the whole featurized matrix.

    ``hbm_budget`` (bytes; default the stream's own ``hbm_budget``) is
    checked twice: against the stream's static plan before any chunk is
    staged, and against the measured residency after every chunk. Either
    excess raises MemoryError with a post-mortem.

    Checkpoint and resume: with ``checkpoint_dir``, every
    ``checkpoint_every`` chunks (default 16) the chunk cursor, the
    carry, the quarantine's state and the drift sketch are snapshotted
    atomically, under a fingerprint of the fit's configuration. A later
    call with the same configuration resumes: it replays the source,
    staging (and, through the stream's transforms, featurizing) the
    chunks below the cursor but not accumulating them, so the resumed
    weights have the same bits as an uninterrupted fit's. A snapshot of
    another configuration raises ``CheckpointMismatchError``; the
    snapshot is removed after a successful finalize. ``quarantine``
    (default the stream's) rides the snapshot.

    The capture fence (``observability/compilelog.py``): after the warm
    chunks (``_WARM_CHUNKS``) the fit arms ``fit_streaming:<tag>``, and
    disarms it when the chunk loop ends, so a CUDA graph captured in the
    steady chunk loop counts in ``compile.unexpected_total``.

    The numerics plane (``KEYSTONE_TORCH_NUMERICS=0`` turns it off)
    checks one deferred health word per chunk, raising ``NumericsError``
    naming the chunk and the stream, checks the fitted model at
    finalize, and attaches the fit's drift baseline to it as
    ``model.numerics_baseline``."""
    if not is_streamable(estimator):
        raise _non_streamable_error(estimator)
    if not is_streaming(data):
        raise TypeError(f"fit_streaming needs a StreamingDataset, got "
                        f"{type(data).__name__}")
    if checkpoint_every is not None and checkpoint_dir is None:
        raise ValueError("checkpoint_every requires checkpoint_dir")
    from ..observability.numerics import (
        HealthMonitor,
        SketchTracker,
        check_fitted,
        numerics_active,
        record_numerics_event,
    )

    budget = data.hbm_budget if hbm_budget is None else float(hbm_budget)
    tag = data.tag or "stream"
    plan = data.static_plan_nbytes()
    if budget is not None and plan is not None and plan > budget:
        raise attach_postmortem(MemoryError(
            f"streamed fit of {tag} would exceed its HBM budget before any "
            f"chunk is staged: static plan {plan:.0f} B (prefetch_depth x "
            f"staged chunk + working chunk + cast transient) > "
            f"{budget:.0f} B; shrink chunk_size or prefetch_depth"),
            "hbm_budget", {"source": tag, "phase": "static_plan",
                           "static_plan_nbytes": plan, "hbm_budget": budget})
    if quarantine is None:
        quarantine = data.quarantine
    world = None
    if is_distributed():
        world = WorldCoordinator(tag=tag)
        round_len = _coord_round_len(checkpoint_every)
    ckpt = fingerprint = numerics_state = carry = None
    start_chunk = 0
    if checkpoint_dir is not None:
        from ..resilience.stream_checkpoint import (
            CarrySnapshot,
            StreamCheckpoint,
            fit_fingerprint,
            restore_carry,
        )

        checkpoint_every = (16 if checkpoint_every is None
                            else int(checkpoint_every))
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        fingerprint = fit_fingerprint(estimator, data, labels)
        ckpt = StreamCheckpoint(checkpoint_dir)
        t0 = time.perf_counter()
        snap = (ckpt.load(fingerprint) if world is None
                else ckpt.load_world(fingerprint, world.pid, world.nproc))
        if snap is not None:
            start_chunk = int(snap["cursor"])
            carry = (None if snap["carry"] is None
                     else restore_carry(snap["carry"], data.device))
            if quarantine is not None and snap.get("quarantine"):
                quarantine.restore(snap["quarantine"])
            numerics_state = snap.get("numerics")
            # the file's read and the carry's copy back to the device
            # (from pageable memory: done when the copy call returns)
            MetricsRegistry.get_or_create().histogram(
                "checkpoint.restore_s").observe(time.perf_counter() - t0)
    reg = MetricsRegistry.get_or_create()
    active = numerics_active()
    monitor = HealthMonitor(tag) if active else None
    sketch = SketchTracker(source=tag) if active else None
    if sketch is not None:
        sketch.restore(numerics_state, data.device)
    chunks_seen = 0
    idx = -1
    obs = compile_observatory()
    fence_armed = False

    def accumulate_one(chunk, lchunk):
        """Fold one chunk into the carry: the per-chunk body of the
        single-process loop and the world's round loop."""
        nonlocal carry, chunks_seen, fence_armed
        # host time of the accumulate's launches; the device work runs
        # on past it
        with flight_span(f"accumulate:{tag}", "compute", chunk=idx):
            if labels is None:
                carry = estimator.accumulate(carry, chunk)
            else:
                carry = estimator.accumulate(carry, chunk, lchunk)
        if monitor is not None:
            # the pad rows are each chunk's tail
            monitor.observe(idx, chunk.data,
                            None if lchunk is None else lchunk.data,
                            rows=(chunk.n, chunk.padded_n))
            sketch.update(chunk)
        reg.gauge("streaming.carry_bytes").set(_carry_nbytes(carry))
        chunks_seen += 1
        if chunks_seen == _WARM_CHUNKS and not fence_armed:
            # every later chunk of the geometry replays what the
            # warm chunks built: a capture from here on is a bug
            obs.arm_fence(f"fit_streaming:{tag}")
            fence_armed = True
        if budget is not None:
            resident = data.buffered_nbytes()
            if resident > budget:
                raise attach_postmortem(MemoryError(
                    f"streamed fit of {tag} exceeded its HBM budget: "
                    f"{resident:.0f} B resident > {budget:.0f} B "
                    f"(chunk {chunks_seen}; shrink chunk_size or "
                    "prefetch_depth)"),
                    "hbm_budget",
                    {"source": tag, "phase": "runtime",
                     "resident_nbytes": resident, "hbm_budget": budget,
                     "chunk": chunks_seen})

    def snapshot_states():
        if monitor is not None:
            # a snapshot must not hold a carry that a chunk whose word
            # is still in flight poisoned
            monitor.flush()
        return (None if quarantine is None else quarantine.state(),
                None if sketch is None else sketch.state())

    pairs = _paired_chunks(data, labels)
    try:
        if world is None:
            for chunk, lchunk in pairs:
                idx += 1
                if idx < start_chunk:
                    continue  # resume replay: already in the restored carry
                accumulate_one(chunk, lchunk)
                if ckpt is not None and (idx + 1) % checkpoint_every == 0:
                    q_state, n_state = snapshot_states()
                    ckpt.save(fingerprint, idx + 1, carry, q_state,
                              numerics=n_state)
        else:
            final_state = None
            local_done = False
            last_saved = -1          # this rank's last durable sidecar
            last_merged = None       # rank 0: sidecar frontier merged
            pending = None           # dispatched, unawaited round
            pending_snap = None      # (cursor, CarrySnapshot, states)
            pinned: List[torch.Tensor] = []
            while True:
                in_round = 0
                while in_round < round_len and not local_done:
                    try:
                        chunk, lchunk = next(pairs)
                    except StopIteration:
                        local_done = True
                        break
                    idx += 1
                    if idx < start_chunk:
                        continue  # resume replay
                    accumulate_one(chunk, lchunk)
                    in_round += 1
                # the lagged sidecar: the copy cut at the last boundary
                # drained behind this round's chunks, and it lands (atomic
                # rename) before the dispatch below reports its cursor
                if pending_snap is not None:
                    snap_cursor, snap, q_state, n_state = pending_snap
                    ckpt.save_host(fingerprint, world.pid, snap_cursor,
                                   None if snap is None else snap.host(),
                                   q_state, numerics=n_state)
                    last_saved = snap_cursor
                    pending_snap = None
                new_pending = world.step_begin(
                    cursor=idx + 1, done=local_done,
                    has_carry=carry is not None, saved_cursor=last_saved)
                if ckpt is not None and idx + 1 != last_saved:
                    # cut this boundary's copy before the next chunk
                    # updates the carry in place
                    q_state, n_state = snapshot_states()
                    pending_snap = (
                        idx + 1,
                        None if carry is None else CarrySnapshot(carry,
                                                                 pinned),
                        q_state, n_state)
                if pending is not None:
                    state = world.step_await(pending)
                    if (ckpt is not None and world.pid == 0
                            and min(state.saved_cursors) >= 0
                            and state.saved_cursors != last_merged):
                        ckpt.merge_hosts(world.nproc)
                        last_merged = state.saved_cursors
                    if state.all_done:
                        final_state = state
                        # every rank saw all_done at the same awaited
                        # round, so every rank drains the same last one
                        world.step_await(new_pending)
                        break
                pending = new_pending
            if not all(final_state.carries):
                # every rank learned it from the same round, so every
                # rank raises the same error here
                empty = [p for p, c in enumerate(final_state.carries)
                         if not c]
                raise ValueError(
                    f"empty stream: rank(s) {empty} of {world.nproc} "
                    f"produced no chunks for {tag!r}; every rank must own "
                    "at least one chunk (repack the data into >= "
                    "process_count shards, or shrink the world)")
    finally:
        pairs.close()
        if fence_armed:
            obs.disarm_fence()
    if monitor is not None:
        # the deferred window's tail: a NaN born in the last chunks
        # trips here, before finalize turns it into garbage weights
        monitor.flush()
    if carry is None:
        raise ValueError("empty stream: nothing to fit")
    if world is not None:
        # gather every rank's carry once and sum in rank order: every rank
        # finalizes the same merged carry into the same weights
        t0 = time.perf_counter()
        with flight_span(f"merge:{tag}", "coord"):
            carry = world.merge_carries(
                carry, reducer=getattr(estimator, "merge_carries", None))
        reg.histogram("coord.merge_s").observe(time.perf_counter() - t0)
    model = estimator.finalize(carry)
    check_fitted(model, tag)
    baseline = None if sketch is None else sketch.baseline()
    if baseline is not None and world is not None:
        baseline = world.merge_baselines(baseline)
    if baseline is not None:
        try:
            model.numerics_baseline = baseline
        except (AttributeError, TypeError):
            pass  # a transformer with __slots__: nowhere to attach it
        record_numerics_event("fit_baseline", source=tag, rows=baseline.rows,
                              cols=int(len(baseline.cols)))
    if ckpt is not None:
        if world is not None:
            # every rank is past its finalize before the shared snapshot
            # goes (a rank lost here would find nothing to resume); rank 0
            # owns the shared files
            world.barrier("finalize-clear")
            if world.pid == 0:
                ckpt.clear()
        else:
            ckpt.clear()
    trace = current_trace()
    if trace is not None:
        trace.record_streamed_fit({
            "source": tag, "chunks": chunks_seen, "resumed_at": start_chunk,
            "static_plan_nbytes": plan,
            "peak_device_nbytes": float(data.peak_device_nbytes),
            "hbm_budget": budget,
            "processes": 1 if world is None else world.nproc})
    return model
