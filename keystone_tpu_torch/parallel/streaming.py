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

Left out of this port so far: checkpoint/resume, quarantine, retry
policy, fault-injection sites, the numerics monitor and sketch, the
compile fence, metrics, spans and post-mortems; the distributed world
loop and per-shard staging onto a mesh.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..ops.device import DEFAULT_DEVICE, resolve_device
from .dataset import (
    ArrayDataset,
    Dataset,
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


class _Residency:
    """Thread-safe device-residency ledger of one prefetch pipeline:
    bytes staged in the queue plus working chunks, with a high-water
    mark. Shared by a root stream and every view derived from it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
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
    returned event marks the end of the copy."""

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
              wire: List[np.dtype]):
        shapes = [(chunk_size,) + x.shape[1:] for x in leaves]
        if not self.cuda:
            out = []
            for x, shape, dt in zip(leaves, shapes, wire):
                buf = np.empty(shape, dt)
                self._fill(buf, x, rows)
                out.append(torch.from_numpy(buf))
            return out, None
        slot = self.next_slot % len(self.ring)
        self.next_slot += 1
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
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            out = [torch.empty(b.shape, dtype=b.dtype, device=self.device)
                   for b in bufs]
            for dst, src in zip(out, bufs):
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.events[slot] = event
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
    streamed fit of this stream or of a view of it checks."""

    def __init__(self, chunk_source: Callable[[], Iterator[Any]],
                 chunk_size: int, n: Optional[int] = None,
                 device=DEFAULT_DEVICE, prefetch_depth: int = 2,
                 tag: Optional[str] = None, wire_dtype: Any = None,
                 compute_dtype: Any = None,
                 hbm_budget: Optional[float] = None,
                 _transforms: Tuple[Callable, ...] = ()):
        if not callable(chunk_source):
            raise TypeError(
                "chunk_source must be a callable returning a fresh chunk "
                "iterator (a one-shot generator cannot be iterated again; "
                "wrap its construction in a function)")
        if prefetch_depth < 1:
            raise ValueError("prefetch_depth must be >= 1")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.device = resolve_device(device)
        self.chunk_size = int(chunk_size)
        self.n = None if n is None else int(n)
        self.prefetch_depth = int(prefetch_depth)
        self.tag = tag
        self.wire_dtype = None if wire_dtype is None else np.dtype(wire_dtype)
        self.compute_dtype = (None if compute_dtype is None
                              else np.dtype(compute_dtype))
        self.hbm_budget = None if hbm_budget is None else float(hbm_budget)
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
            _transforms=self._transforms + (transform,))
        out._residency = self._residency
        out._element = self._element
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
        q: queue.Queue = queue.Queue()
        # the bound is the slots, acquired BEFORE staging: gating the
        # queue alone would let the producer stage chunk depth + 1 while
        # it waits for room, putting depth + 2 chunks on the device
        slots = threading.Semaphore(self.prefetch_depth)
        stop = threading.Event()
        ledger = _IterLedger()
        stager = _Stager(self.device, self.prefetch_depth)

        def acquire_slot() -> bool:
            while not stop.is_set():
                if slots.acquire(timeout=0.05):
                    return True
            return False

        def produce():
            try:
                for raw in self._chunk_source():
                    if not acquire_slot():
                        return
                    leaves, rows = self._host_leaves(raw)
                    wire = [self.wire_dtype or x.dtype for x in leaves]
                    target = [self.compute_dtype or x.dtype for x in leaves]
                    staged, event = stager.stage(leaves, rows,
                                                 self.chunk_size, wire)
                    nbytes = float(sum(t.element_size() * t.numel()
                                       for t in staged))
                    work = float(sum(t.numel() * dt.itemsize
                                     for t, dt in zip(staged, target)))
                    cast = [None if dt == w else _torch_dtype(dt)
                            for dt, w in zip(target, wire)]
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
        producer.start()
        rows_seen, complete = 0, False
        try:
            while True:
                try:
                    item = q.get(timeout=1.0)
                except queue.Empty:
                    if not producer.is_alive() and q.empty():
                        raise RuntimeError(
                            f"stream {self.tag or '<untagged>'}: the "
                            "producer thread died without completing the "
                            "stream")
                    continue
                if item is _DONE:
                    complete = True
                    break
                if isinstance(item, _SourceError):
                    raise item.exc
                raw, staged, rows, nbytes, work, cast, event = item
                needs_cast = any(c is not None for c in cast)
                self._residency.hand_off(
                    ledger, nbytes, work,
                    transient=nbytes if needs_cast else 0.0)
                # the chunk left the buffer: the producer may stage the
                # next one while this one computes
                slots.release()
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
                rows_seen += rows
        finally:
            stop.set()
            # join before closing the ledger: a producer still staging
            # would otherwise charge the ledger after it was closed
            producer.join(timeout=5.0)
            self._residency.close(ledger)
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

    def static_plan_nbytes(self) -> Optional[float]:
        """The residency bound of one live iteration, computed without
        touching the source: ``prefetch_depth`` staged wire-width chunks,
        one working chunk at the compute width and, when a cast runs,
        one transient wire chunk. None when the source's items cannot be
        described without consuming it."""
        if self._element is None:
            return None
        wire_b = work_b = 0.0
        cast = False
        for shape, src in self._element:
            size = float(self.chunk_size * int(np.prod(shape, dtype=np.int64)))
            wire = self.wire_dtype or src
            comp = self.compute_dtype or src
            wire_b += size * wire.itemsize
            work_b += size * comp.itemsize
            cast = cast or wire != comp
        return (self.prefetch_depth * wire_b + work_b
                + (wire_b if cast else 0.0))

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
    def from_numpy(array: Any, chunk_size: int, **kw) -> "StreamingDataset":
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

        out = StreamingDataset(chunked, chunk_size, n=total, **kw)
        out._element = [(x.shape[1:], x.dtype) for x in leaves]
        return out


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


def fit_streaming(estimator: Any, data: StreamingDataset, labels: Any = None):
    """Drive a streamable estimator over a chunked dataset: one
    ``accumulate`` per chunk, then ``finalize``. Only the carry (Gram,
    cross products, moments) and the bounded prefetch buffer live on the
    device, never the whole featurized matrix.

    The stream's ``hbm_budget`` (bytes), when it has one, is checked
    twice: against the stream's static plan before any chunk is
    staged, and against the measured residency after every chunk. Either
    excess raises MemoryError."""
    if not is_streamable(estimator):
        raise _non_streamable_error(estimator)
    if not is_streaming(data):
        raise TypeError(f"fit_streaming needs a StreamingDataset, got "
                        f"{type(data).__name__}")
    budget = data.hbm_budget
    tag = data.tag or "stream"
    plan = data.static_plan_nbytes()
    if budget is not None and plan is not None and plan > budget:
        raise MemoryError(
            f"streamed fit of {tag} would exceed its HBM budget before any "
            f"chunk is staged: static plan {plan:.0f} B (prefetch_depth x "
            f"staged chunk + working chunk + cast transient) > "
            f"{budget:.0f} B; shrink chunk_size or prefetch_depth")
    carry = None
    chunks_seen = 0
    pairs = _paired_chunks(data, labels)
    try:
        for chunk, lchunk in pairs:
            if labels is None:
                carry = estimator.accumulate(carry, chunk)
            else:
                carry = estimator.accumulate(carry, chunk, lchunk)
            chunks_seen += 1
            if budget is not None:
                resident = data.buffered_nbytes()
                if resident > budget:
                    raise MemoryError(
                        f"streamed fit of {tag} exceeded its HBM budget: "
                        f"{resident:.0f} B resident > {budget:.0f} B "
                        f"(chunk {chunks_seen}; shrink chunk_size or "
                        "prefetch_depth)")
    finally:
        pairs.close()
    if carry is None:
        raise ValueError("empty stream: nothing to fit")
    return estimator.finalize(carry)
