"""Memoized recursive DAG executor.

Counterpart of ``keystone_tpu/workflow/executor.py`` (reference
``workflow/graph/GraphExecutor.scala``): optimizes lazily on first
execution, refuses to execute ids reachable from unconnected sources,
and saves results of saveable nodes (estimator fits, caches) into the
global prefix state table.

Instrumentation (``keystone_tpu/workflow/executor.py:100-252``): while a
:class:`~keystone_tpu_torch.observability.trace.PipelineTrace` is
active, each node's thunk runs inside
``torch.profiler.record_function("<label>#<id>")`` and the capture
observatory's ``compile_context("node:<label>#<id>")`` (a CUDA graph
captured while the node runs is attributed to it), is timed into a
``NodeRecord`` (self time, output bytes), leaves a ``node`` span on the
flight recorder and has its output health-checked
(``check_node_output``). The timer synchronises the CUDA device before
it reads the clock, as the JAX package blocks on the value; that sync is
an observer effect, since it removes the overlap between a node and the
next one's launches. An untraced run wraps nothing. The
``executor.nodes_executed`` and ``executor.memo_hits`` counters are
always on, outside the optimizers' sampled executions.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, FrozenSet, Optional

import torch

from ..observability.compilelog import compile_context
from ..observability.metrics import MetricsRegistry
from ..observability.numerics import check_node_output
from ..observability.timeline import record_span
from ..observability.trace import NodeRecord, current_trace, \
    metrics_suppressed
from ..observability.utilization import kernel_work_delta, \
    kernel_work_snapshot
from ..parallel.dataset import device_nbytes
from .env import PipelineEnv
from .expression import (
    DatasetExpression,
    DatumExpression,
    Expression,
    TransformerExpression,
)
from .graph import Graph
from .graph_ids import GraphId, NodeId, SinkId
from .operators import (
    DatasetOperator,
    DatumOperator,
    EstimatorOperator,
    Operator,
)
from .prefix import compute_prefix


def is_saveable(op: Operator) -> bool:
    """Which operators' results enter the global prefix memo (reference
    ``ExtractSaveablePrefixes.scala:8-19``: Cacher or EstimatorOperator)."""
    return isinstance(op, EstimatorOperator) or getattr(op, "saveable", False)


def _expression_kind(expr: Expression) -> str:
    for cls, kind in ((DatasetExpression, "dataset"),
                      (DatumExpression, "datum"),
                      (TransformerExpression, "transformer")):
        if isinstance(expr, cls):
            return kind
    return "expression"


def _traced_thunk(orig, node_id: int, label: str, kind: str):
    """Wrap a thunk with trace recording. The active trace is looked up
    at call time: a saved expression outlives the trace it was made
    under."""

    def run():
        trace = current_trace()
        if trace is None:
            return orig()
        scope = f"{label}#{node_id}"
        record = NodeRecord(node_id=node_id, operator=label, kind=kind)
        counter, work0 = None, None
        if trace.count_flops:
            from torch.utils.flop_counter import FlopCounterMode

            counter = FlopCounterMode(display=False)
            work0 = kernel_work_snapshot()
        t0 = time.perf_counter()
        with trace.node_timer(record):
            with compile_context(f"node:{scope}"), \
                    torch.profiler.record_function(scope), \
                    (counter or contextlib.nullcontext()):
                value = orig()
            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            record.output_bytes = device_nbytes(value)
            if counter is not None:
                # inclusive here; the timer charges children's to them
                kernel = kernel_work_delta(work0)
                record._inclusive_work = ({
                    "torch_flops": float(counter.get_total_flops()),
                    "kernel_flops": sum(w["flops"] for w in kernel.values()),
                    "kernel_bytes": sum(w["bytes"] for w in kernel.values()),
                }, {k: w["launches"] for k, w in kernel.items()})
        record_span(scope, "node", t0, record.total_s,
                    args={"node_id": node_id, "kind": kind})
        # after the timer: the health check is the numerics plane's
        # cost, not the node's
        check_node_output(value, scope)
        return value

    run._keystone_traced = True
    return run


class GraphExecutor:
    def __init__(self, graph: Graph, optimize: bool = True):
        self._raw_graph = graph
        self._should_optimize = optimize
        self._optimized: Optional[Graph] = None
        self._cache: Dict[GraphId, Expression] = {}
        self._unexecutables: Optional[FrozenSet[GraphId]] = None

    @property
    def graph(self) -> Graph:
        """The optimized graph (optimization happens once, lazily)."""
        if self._optimized is None:
            if self._should_optimize:
                self._optimized = PipelineEnv.get_or_create().optimizer.execute(
                    self._raw_graph
                )
            else:
                self._optimized = self._raw_graph
        return self._optimized

    @property
    def raw_graph(self) -> Graph:
        return self._raw_graph

    @property
    def unexecutables(self) -> FrozenSet[GraphId]:
        """Ids whose value depends on an unconnected source."""
        if self._unexecutables is None:
            bad: set = set()
            for s in self.graph.sources:
                bad.add(s)
                bad |= self.graph.get_descendants(s)
            self._unexecutables = frozenset(bad)
        return self._unexecutables

    def execute(self, gid: GraphId) -> Expression:
        graph = self.graph
        if isinstance(gid, SinkId):
            return self.execute(graph.get_sink_dependency(gid))
        if gid in self.unexecutables:
            raise ValueError(
                f"cannot execute {gid!r}: it depends on an unconnected source"
            )
        metrics = (None if metrics_suppressed()
                   else MetricsRegistry.get_or_create())
        if gid in self._cache:
            if metrics is not None:
                metrics.counter("executor.memo_hits").inc()
            return self._cache[gid]
        assert isinstance(gid, NodeId), gid
        op = graph.get_operator(gid)
        deps = [self.execute(d) for d in graph.get_dependencies(gid)]
        expr = op.execute(deps)
        if metrics is not None:
            metrics.counter("executor.nodes_executed").inc()
        trace = current_trace()
        if trace is not None:
            self._instrument(trace, gid, op, expr)
        self._cache[gid] = expr
        if is_saveable(op):
            prefix = compute_prefix(graph, gid)
            if prefix is not None:
                # The expression memoizes itself on first get(), so saving
                # the lazy handle shares the eventual fit/cache result
                # across pipelines (GraphExecutor.scala:66-70).
                PipelineEnv.get_or_create().state[prefix] = expr
        return expr

    @staticmethod
    def _instrument(trace, gid: NodeId, op: Operator,
                    expr: Expression) -> None:
        """Attach trace recording to ``expr``. A computed expression is
        recorded at once: a constant as such, anything else (saved
        state, a prefix-memo hit) as a cache hit."""
        label = op.label()
        kind = _expression_kind(expr)
        if expr.computed:
            record = NodeRecord(
                node_id=gid.id, operator=label, kind=kind,
                cached=not isinstance(op, (DatasetOperator, DatumOperator)))
            record.output_bytes = device_nbytes(expr.get())
            trace.record_node(record)
            return
        if getattr(expr._thunk, "_keystone_traced", False):
            return  # a saved lazy handle, wrapped already
        expr._thunk = _traced_thunk(expr._thunk, gid.id, label, kind)
