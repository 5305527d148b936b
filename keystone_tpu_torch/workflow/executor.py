"""Memoized recursive DAG executor.

Counterpart of ``keystone_tpu/workflow/executor.py`` (reference
``workflow/graph/GraphExecutor.scala``): optimizes lazily on first
execution, refuses to execute ids reachable from unconnected sources,
and saves results of saveable nodes (estimator fits, caches) into the
global prefix state table. The JAX package's tracing, compile
attribution and numerics checks around each node are not ported yet.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Optional

from .env import PipelineEnv
from .expression import Expression
from .graph import Graph
from .graph_ids import GraphId, NodeId, SinkId
from .operators import EstimatorOperator, Operator
from .prefix import compute_prefix


def is_saveable(op: Operator) -> bool:
    """Which operators' results enter the global prefix memo (reference
    ``ExtractSaveablePrefixes.scala:8-19``: Cacher or EstimatorOperator)."""
    return isinstance(op, EstimatorOperator) or getattr(op, "saveable", False)


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
        if gid in self._cache:
            return self._cache[gid]
        assert isinstance(gid, NodeId), gid
        op = graph.get_operator(gid)
        deps = [self.execute(d) for d in graph.get_dependencies(gid)]
        expr = op.execute(deps)
        self._cache[gid] = expr
        if is_saveable(op):
            prefix = compute_prefix(graph, gid)
            if prefix is not None:
                # The expression memoizes itself on first get(), so saving
                # the lazy handle shares the eventual fit/cache result
                # across pipelines (GraphExecutor.scala:66-70).
                PipelineEnv.get_or_create().state[prefix] = expr
        return expr
