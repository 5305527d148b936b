"""Structured per-run pipeline tracing.

Counterpart of ``keystone_tpu/observability/trace.py``. A
:class:`PipelineTrace` is entered around pipeline execution; while it is
active (:func:`current_trace` returns it) the workflow stack feeds it:

* per-node records (``node_timer`` / ``record_node``, from the
  executor's instrumented thunks): self and inclusive wall time, the
  output's device bytes, and whether the value came from a cache or the
  prefix memo;
* optimizer records: the auto-cache rule's report, the node rule's
  splice choices and the least-squares solver decisions;
* streamed-ingest chunks, streamed fits, resilience and numerics events,
  CUDA graph captures (``observability/compilelog.py``) and
  contended-lock waits.

Self times: a node's wall time minus the time spent in nested
instrumented nodes (a parent's first ``get()`` computes its ancestors),
so self times sum to the traced compute with no double counting.

Work: a trace made with ``count_flops=True`` (the command line's
``--trace-out``) runs each node under ``torch.utils.flop_counter.
FlopCounterMode`` and notes the kernels' counted work of its launches
(``ops/kernels.py::WORK``); each record gets its self torch FLOPs,
kernel FLOPs, kernel bytes and launches, charged like self time.
``observability/utilization.py::annotate_trace`` turns them into
``flops``, ``mfu`` and ``membw_util``. The counter routes every torch op
through Python, so a counting trace runs slower than a plain one.

Tracing costs nothing when no trace is active: every hook returns at
once and the executor wraps no thunk. The JAX trace's compile stream
holds XLA compiles; the port's holds CUDA graph captures.
:func:`profiler_trace` is
the counterpart of ``xprof_trace`` (also exported under that name), a
``torch.profiler`` capture with pipeline node names as
``record_function`` ranges.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Iterator, List, Optional

from ..utils.guarded import TracedLock, guarded_by

_ACTIVE: Optional["PipelineTrace"] = None


def current_trace() -> Optional["PipelineTrace"]:
    """The active trace, or None (instrumentation sites return on None)."""
    return _ACTIVE


_SUPPRESS_DEPTH = 0


@contextlib.contextmanager
def tracing_disabled() -> Iterator[None]:
    """Suspend the active trace and the executor's metrics for the block:
    the optimizers' sampled executions share node ids with the real
    graph and must not enter the per-node records; their cost is in the
    optimizer's own entries."""
    global _ACTIVE, _SUPPRESS_DEPTH
    prev = _ACTIVE
    _ACTIVE = None
    _SUPPRESS_DEPTH += 1
    try:
        yield
    finally:
        _ACTIVE = prev
        _SUPPRESS_DEPTH -= 1


def metrics_suppressed() -> bool:
    """True inside a :func:`tracing_disabled` block."""
    return _SUPPRESS_DEPTH > 0


@dataclass
class NodeRecord:
    """One executed graph node."""

    node_id: int
    operator: str
    wall_s: float = 0.0        # self time (nested node compute excluded)
    total_s: float = 0.0       # inclusive wall time of the node's thunk
    output_bytes: float = 0.0  # device bytes of the output
    cached: bool = False       # value came from the prefix/state memo
    shards: int = 1            # data shards of the output dataset
    kind: str = ""             # expression kind (dataset/datum/transformer)
    # counted work, self (count_flops traces; zero otherwise)
    torch_flops: float = 0.0   # FlopCounterMode FLOPs of torch ops
    kernel_flops: float = 0.0  # the CUDA kernels' counted FLOPs
    kernel_bytes: float = 0.0  # the CUDA kernels' counted bytes
    kernel_launches: Dict[str, float] = field(default_factory=dict)
    # utilization annotations (observability/utilization.py
    # ``annotate_trace``; zero = not annotated)
    flops: float = 0.0         # kernel + torch FLOPs
    mfu: float = 0.0           # achieved FLOP/s over the card's peak
    membw_util: float = 0.0    # achieved bytes/s over the HBM rate


#: the work a node's inclusive run is charged with
_WORK_KEYS = ("torch_flops", "kernel_flops", "kernel_bytes")


class _Frame:
    __slots__ = ("child_s", "child_work", "child_launches")

    def __init__(self) -> None:
        self.child_s = 0.0
        self.child_work = dict.fromkeys(_WORK_KEYS, 0.0)
        self.child_launches: Dict[str, float] = {}


@guarded_by("_resilience_lock", "resilience", "resilience_stats")
@guarded_by("_numerics_lock", "numerics", "numerics_stats")
@guarded_by("_lock_wait_lock", "lock_waits")
class PipelineTrace:
    """One run's execution telemetry; see the module docstring.

    Usage::

        with PipelineTrace("cifar") as tr:
            pipeline.apply(data).get()
        print(tr.summary())

    The node, chunk and optimizer streams are fed by the driver thread;
    resilience, numerics and lock-wait records may come from worker
    threads and take locks."""

    #: raw entries retained per stream (the ``*_stats`` counts stay exact)
    CHUNK_TAIL = 512
    STREAMED_FIT_TAIL = 512
    RESILIENCE_TAIL = 512
    NUMERICS_TAIL = 512
    COMPILE_TAIL = 512

    def __init__(self, name: str = "pipeline", count_flops: bool = False):
        self.name = name
        #: run nodes under a FlopCounterMode and note kernel work
        self.count_flops = count_flops
        #: nodes with no counted work, set by ``annotate_trace``
        self.uncovered: List[str] = []
        self.nodes: List[NodeRecord] = []
        self.auto_cache: List[Dict[str, Any]] = []
        self.node_choices: List[Dict[str, Any]] = []
        self.solver_decisions: List[Dict[str, Any]] = []
        self.chunks: List[Dict[str, Any]] = []
        self.chunk_stats: Dict[str, float] = {
            "count": 0, "ingest_stall_s": 0.0, "nbytes": 0.0,
            "occupancy_sum": 0.0, "h2d_bytes": 0.0}
        self.streamed_fits: List[Dict[str, Any]] = []
        self.resilience: List[Dict[str, Any]] = []
        self.resilience_stats: Dict[str, float] = {}
        self._resilience_lock = TracedLock("trace.resilience")
        self.numerics: List[Dict[str, Any]] = []
        self.numerics_stats: Dict[str, float] = {}
        self._numerics_lock = TracedLock("trace.numerics")
        #: CUDA graph captures; they may come from serving threads
        self.compiles: List[Dict[str, Any]] = []
        self._compile_lock = threading.Lock()
        #: {lock name: {"count": n, "wait_s": total}}; a plain guard,
        #: because TracedLock reports in here
        self.lock_waits: Dict[str, Dict[str, float]] = {}
        self._lock_wait_lock = threading.Lock()
        self.meta: Dict[str, Any] = {}
        self.wall_s = 0.0
        self._t0: Optional[float] = None
        self._stack: List[_Frame] = []
        self._prev: Optional["PipelineTrace"] = None

    # -- context ------------------------------------------------------------
    def __enter__(self) -> "PipelineTrace":
        global _ACTIVE
        import torch

        if self.count_flops:
            # the counter's first dispatched op pays a one-off set-up of
            # seconds; pay it here, outside the trace's wall and nodes
            from torch.utils.flop_counter import FlopCounterMode

            with FlopCounterMode(display=False):
                x = torch.zeros((2, 2))
                (x @ x + 1.0).sum()
        self._prev = _ACTIVE
        _ACTIVE = self
        self._t0 = time.perf_counter()
        if torch.cuda.is_available():
            self.meta.setdefault("backend", "cuda")
            self.meta.setdefault("device_kind",
                                 torch.cuda.get_device_name(0))
            self.meta.setdefault("num_devices", torch.cuda.device_count())
        else:
            self.meta.setdefault("backend", "cpu")
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        if self._t0 is not None:
            self.wall_s += time.perf_counter() - self._t0
            self._t0 = None
        _ACTIVE = self._prev
        self._prev = None

    # -- recording hooks ------------------------------------------------------
    @contextlib.contextmanager
    def node_timer(self, record: NodeRecord) -> Iterator[NodeRecord]:
        """Time one node's thunk, charging nested instrumented node time
        to the children."""
        frame = _Frame()
        self._stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield record
        finally:
            total = time.perf_counter() - t0
            self._stack.pop()
            record.total_s = total
            record.wall_s = max(total - frame.child_s, 0.0)
            work = getattr(record, "_inclusive_work", None)
            if work is not None:
                incl, launches = work
                for key in _WORK_KEYS:
                    setattr(record, key,
                            max(incl[key] - frame.child_work[key], 0.0))
                record.kernel_launches = {
                    k: v - frame.child_launches.get(k, 0.0)
                    for k, v in launches.items()
                    if v > frame.child_launches.get(k, 0.0)}
            if self._stack:
                parent = self._stack[-1]
                parent.child_s += total
                if work is not None:
                    for key in _WORK_KEYS:
                        parent.child_work[key] += incl[key]
                    for k, v in launches.items():
                        parent.child_launches[k] = (
                            parent.child_launches.get(k, 0.0) + v)
            self.nodes.append(record)

    def record_node(self, record: NodeRecord) -> None:
        """A node that ran no timed compute (constants, memo hits)."""
        self.nodes.append(record)

    def record_auto_cache(self, report: Dict[str, Any]) -> None:
        self.auto_cache.append(report)

    def record_node_choice(self, entry: Dict[str, Any]) -> None:
        self.node_choices.append(entry)

    def record_solver_decision(self, entry: Dict[str, Any]) -> None:
        self.solver_decisions.append(entry)

    def record_chunk(self, entry: Dict[str, Any]) -> None:
        """One streamed chunk: source tag, index, rows, working bytes,
        the bytes that crossed to the device, the consumer's stall and
        the prefetch occupancy at hand-off."""
        s = self.chunk_stats
        s["count"] += 1
        s["ingest_stall_s"] += float(entry.get("ingest_stall_s", 0.0))
        s["nbytes"] += float(entry.get("nbytes", 0.0))
        s["occupancy_sum"] += float(entry.get("prefetch_occupancy", 0.0))
        s["h2d_bytes"] += float(entry.get("h2d_bytes", 0.0))
        self.chunks.append(entry)
        if len(self.chunks) > self.CHUNK_TAIL:
            del self.chunks[: len(self.chunks) - self.CHUNK_TAIL]

    def record_streamed_fit(self, entry: Dict[str, Any]) -> None:
        """One finished streamed fit: the static residency plan beside
        the ledger's measured peak, and the budget."""
        self.streamed_fits.append(entry)
        if len(self.streamed_fits) > self.STREAMED_FIT_TAIL:
            del self.streamed_fits[: len(self.streamed_fits)
                                   - self.STREAMED_FIT_TAIL]

    def record_resilience(self, entry: Dict[str, Any]) -> None:
        """One resilience event (``resilience/events.py``)."""
        event = str(entry.get("event", "other"))
        with self._resilience_lock:
            self.resilience_stats[event] = (
                self.resilience_stats.get(event, 0) + 1)
            self.resilience.append(entry)
            if len(self.resilience) > self.RESILIENCE_TAIL:
                del self.resilience[: len(self.resilience)
                                    - self.RESILIENCE_TAIL]

    def record_numerics(self, entry: Dict[str, Any]) -> None:
        """One numerics event (``observability/numerics.py``)."""
        event = str(entry.get("event", "other"))
        with self._numerics_lock:
            self.numerics_stats[event] = self.numerics_stats.get(event, 0) + 1
            self.numerics.append(entry)
            if len(self.numerics) > self.NUMERICS_TAIL:
                del self.numerics[: len(self.numerics) - self.NUMERICS_TAIL]

    def record_compile(self, entry: Dict[str, Any]) -> None:
        """One CUDA graph capture (``observability/compilelog.py``)."""
        with self._compile_lock:
            self.compiles.append(entry)
            if len(self.compiles) > self.COMPILE_TAIL:
                del self.compiles[: len(self.compiles) - self.COMPILE_TAIL]

    def record_lock_wait(self, name: str, wait_s: float) -> None:
        with self._lock_wait_lock:
            entry = self.lock_waits.setdefault(name,
                                               {"count": 0, "wait_s": 0.0})
            entry["count"] += 1
            entry["wait_s"] += float(wait_s)

    def ingest_stall_s(self) -> float:
        return float(self.chunk_stats["ingest_stall_s"])

    # -- views ----------------------------------------------------------------
    def node_ids(self) -> set:
        return {r.node_id for r in self.nodes}

    def total_node_wall_s(self) -> float:
        return sum(r.wall_s for r in self.nodes)

    # -- export ---------------------------------------------------------------
    _LISTS = ("auto_cache", "node_choices",
              "solver_decisions", "chunks", "streamed_fits", "resilience",
              "numerics", "compiles", "uncovered")
    _DICTS = ("meta", "chunk_stats", "resilience_stats", "numerics_stats")

    def to_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "wall_s": self.wall_s,
                               "nodes": [asdict(r) for r in self.nodes]}
        for key in self._LISTS:
            out[key] = list(getattr(self, key))
        for key in self._DICTS:
            out[key] = dict(getattr(self, key))
        out["lock_waits"] = {k: dict(v) for k, v in self.lock_waits.items()}
        return out

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, default=str)

    @classmethod
    def from_json(cls, blob: str) -> "PipelineTrace":
        data = json.loads(blob)
        tr = cls(data.get("name", "pipeline"))
        tr.wall_s = float(data.get("wall_s", 0.0))
        tr.nodes = [NodeRecord(**r) for r in data.get("nodes", [])]
        for key in cls._LISTS:
            setattr(tr, key, list(data.get(key, [])))
        for key in cls._DICTS:
            if key in data:
                setattr(tr, key, dict(data[key]))
        tr.lock_waits = {k: dict(v)
                         for k, v in data.get("lock_waits", {}).items()}
        return tr

    def summary(self, top: int = 0) -> str:
        """Per-node table by self time, then the optimizer decisions and
        the ingest, resilience and numerics aggregates."""
        total = self.total_node_wall_s()
        lines = [f"PipelineTrace {self.name!r}: {len(self.nodes)} node "
                 f"executions, wall {self.wall_s:.3f}s, traced node compute "
                 f"{total:.3f}s"]
        rows = sorted(self.nodes, key=lambda r: -r.wall_s)
        for r in rows[:top] if top else rows:
            pct = 100.0 * r.wall_s / total if total else 0.0
            lines.append(
                f"{r.node_id:>6} {r.operator[:28]:<28} "
                f"{r.wall_s * 1e3:>10.2f} ms {pct:>6.1f}% "
                f"{r.output_bytes / (1 << 20):>9.2f} MiB"
                f"{' cached' if r.cached else ''}")
        for rep in self.auto_cache:
            lines.append(f"auto-cache[{rep.get('strategy')}]: cached "
                         f"{rep.get('selected', [])}")
        if self.chunk_stats["count"]:
            count = int(self.chunk_stats["count"])
            lines.append(
                f"streamed ingest: {count} chunk(s), stall "
                f"{self.ingest_stall_s():.3f}s, h2d "
                f"{self.chunk_stats['h2d_bytes'] / (1 << 20):.1f} MiB, mean "
                f"prefetch occupancy "
                f"{self.chunk_stats['occupancy_sum'] / count:.2f}")
        for title, stats in (("resilience", self.resilience_stats),
                             ("numerics", self.numerics_stats)):
            if stats:
                lines.append(f"{title} events: " + " ".join(
                    f"{k}={int(v)}" for k, v in sorted(stats.items())))
        if self.lock_waits:
            lines.append("contended locks: " + ", ".join(
                f"{k} ({int(v['count'])}x, {v['wait_s'] * 1e3:.1f} ms)"
                for k, v in sorted(self.lock_waits.items(),
                                   key=lambda kv: -kv[1]["wait_s"])[:3]))
        for d in self.solver_decisions:
            costs = ", ".join(f"{k}={v:.3g}s"
                              for k, v in d.get("costs", {}).items())
            lines.append(f"solver choice @ n={d.get('n')} d={d.get('d')} "
                         f"k={d.get('k')}: {d.get('chosen')} ({costs})")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: str, name: str = "pipeline"
                   ) -> Iterator[PipelineTrace]:
    """A ``torch.profiler`` capture (CPU and, where present, CUDA
    activity) of everything in scope, exported as a Chrome trace into
    ``log_dir``, with a :class:`PipelineTrace` active so every executed
    node is a ``record_function`` range named after it. An active trace
    is reused. The trace's per-node device synchronisation changes
    overlap relative to an untraced run; ``utils.profiling.trace`` is
    the capture without it."""
    import os

    import torch

    active = current_trace()
    ctx = (contextlib.nullcontext(active) if active is not None
           else PipelineTrace(name))
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with ctx as tr:
        with torch.profiler.profile(activities=acts) as prof:
            yield tr
        prof.export_chrome_trace(os.path.join(log_dir, f"{name}.json"))


#: the JAX package's name for :func:`profiler_trace` (its capture is the
#: XLA profiler; the port's is ``torch.profiler``)
xprof_trace = profiler_trace
