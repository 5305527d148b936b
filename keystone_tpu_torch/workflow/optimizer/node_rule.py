"""Node-level optimization rule.

Counterpart of ``keystone_tpu/workflow/optimizer/node_rule.py``
(reference ``workflow/NodeOptimizationRule.scala``). For every
optimizable operator that is not downstream of the pipeline's runtime
source, the rule resolves the node's choice and splices it into the
graph:

* the chosen operator replaces the optimizable one;
* the choice's prefix transformers are inserted on the fit-path data
  dependency AND on the runtime input of every delegating child, the
  same two-endpoint splice the reference performs on its instruction
  list (``NodeOptimizationRule.scala:82-299``).

Static first, as the JAX package's default: the rule runs the abstract
interpreter (``analysis.interpreter.analyze``, meta tensors, no device
work) once per graph state, a splice dropping it. Where the node's data
(and labels) dependencies resolve to dataset specs of known n, the
node's ``optimize_static`` hook is asked; a choice it returns is taken
with no data loaded and no kernel run, and the trace's choice record
says ``"provenance": "static"``. Where the analyzer or the node
declines, the rule executes the dependency prefix on *sampled* source
datasets (the reference's per-partition sample execution,
``NodeOptimizationRule.scala:337-350``) and calls ``optimize``
(``"sampled"``). The static path's density is STRUCTURAL (1.0 for dense
storage), not the sampled value-level one; ``static_shapes=False`` or
``KEYSTONE_TORCH_STATIC_NODE_OPT=0`` gives the sampled path everywhere,
JAX's ``static_shapes=False``.

An optimizable node fed by a stream whose shape the analyzer cannot
resolve is left in place: a streamable estimator makes its choice at
``finalize`` from the exact accumulated shape. The machine count is 1:
one GPU, no mesh.

Unlike the JAX rule, which runs a fresh executor over a sampled copy of
the graph for every optimizable node, one rule application computes each
node's value on the sample once and shares it with every optimizable
node downstream that the analyzer does not resolve, and keeps those
values to itself: nothing enters the global prefix memo, where a key
holding a sampled dataset would never be looked up again.
"""
from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ...observability.trace import current_trace
from ...parallel.dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    is_streaming,
    tree_map,
)
from ..expression import Expression
from ..graph import Graph
from ..graph_ids import GraphId, NodeId
from ..operators import DatasetOperator, DelegatingOperator
from ..optimizable import (
    NodeChoice,
    OptimizableEstimator,
    OptimizableLabelEstimator,
    OptimizableTransformer,
)
from .rule import Rule

DEFAULT_SAMPLE_SIZE = 96  # reference: samplesPerPartition=3 over many partitions

#: the switch of the static path (on unless set to 0, false or no)
STATIC_ENV = "KEYSTONE_TORCH_STATIC_NODE_OPT"

_OPTIMIZABLE = (OptimizableLabelEstimator, OptimizableEstimator,
                OptimizableTransformer)


def _sample_dataset(ds: Dataset, size: int) -> Dataset:
    """Evenly spread deterministic sample (the analogue of the
    reference's per-partition sampling, avoiding head bias on ordered
    datasets). A stream is sampled from its first chunk only, so the
    cost stays bounded and the stream is never materialized."""
    if is_streaming(ds):
        chunks = ds.chunks()
        try:
            for chunk in chunks:
                return _sample_dataset(chunk, size)
        finally:
            chunks.close()
        raise ValueError("cannot sample an empty stream")
    n = len(ds)
    idx = np.unique(np.linspace(0, n - 1, min(size, n)).astype(np.int64))
    if isinstance(ds, ArrayDataset):
        rows = torch.as_tensor(idx, device=ds.device)
        return ArrayDataset(tree_map(lambda x: x[rows], ds.data), len(idx),
                            shards=ds.shards)
    items = ds.collect()
    return HostDataset([items[i] for i in idx])


def _dataset_len(ds: Dataset) -> int:
    """len(ds), 0 for a stream of unknown length (callers take the max
    over the graph's datasets, and stream-fed optimizable nodes are not
    sampled)."""
    try:
        return len(ds)
    except TypeError:
        return 0


class _SampledValues:
    """Node values on the sample, for one rule application: each source
    dataset is cut to the sample once and each node is executed once. A
    splice changes the spliced node and what descends from it, so
    ``drop`` forgets their values; every other node keeps its operator
    and dependencies, and its value stays valid."""

    def __init__(self, sample_size: int):
        self.sample_size = sample_size
        self._values: Dict[GraphId, Expression] = {}

    def value(self, graph: Graph, gid: GraphId) -> Expression:
        expr = self._values.get(gid)
        if expr is None:
            op = graph.get_operator(gid)
            if isinstance(op, DatasetOperator):
                op = DatasetOperator(
                    _sample_dataset(op.dataset, self.sample_size))
            expr = op.execute([self.value(graph, d)
                               for d in graph.get_dependencies(gid)])
            self._values[gid] = expr
        return expr

    def drop(self, graph: Graph, node: NodeId) -> None:
        for gid in graph.get_descendants(node) | {node}:
            self._values.pop(gid, None)


class NodeOptimizationRule(Rule):
    def __init__(self, sample_size: int = DEFAULT_SAMPLE_SIZE,
                 num_machines: Optional[int] = None,
                 static_shapes: Optional[bool] = None):
        self.sample_size = sample_size
        self.num_machines = num_machines
        if static_shapes is None:
            static_shapes = os.environ.get(STATIC_ENV, "1").strip().lower() \
                not in ("0", "false", "no")
        self.static_shapes = static_shapes
        #: splices made by the last ``apply``
        self.splices = 0

    # -- sampling ---------------------------------------------------------
    @staticmethod
    def _execute_sampled(graph: Graph, deps: Tuple[GraphId, ...],
                         values: _SampledValues):
        """Execute dependency ids with the source datasets feeding them
        cut to the sample, through ``values``, the rule application's
        values on the sample. Returns (samples, n) where n is the full
        size of the feeding datasets (node transforms are 1:1 per item,
        as in the reference's numPerPartition count)."""
        relevant: set = set()
        for d in deps:
            relevant.add(d)
            relevant |= graph.get_ancestors(d)
        n = 0
        for node in relevant:
            op = graph.get_operator(node) if isinstance(node, NodeId) else None
            if isinstance(op, DatasetOperator):
                n = max(n, _dataset_len(op.dataset))
        return [values.value(graph, d).get() for d in deps], n

    # -- splicing ---------------------------------------------------------
    @staticmethod
    def _insert_prefix(graph: Graph, dep: GraphId,
                       prefix) -> Tuple[Graph, GraphId]:
        cur = dep
        for t in prefix:
            graph, cur = graph.add_node(t, (cur,))
        return graph, cur

    def _splice_estimator(self, graph: Graph, node: NodeId,
                          choice: NodeChoice) -> Graph:
        deps = graph.get_dependencies(node)
        data_dep, rest = deps[0], deps[1:]
        graph, new_data = self._insert_prefix(graph, data_dep, choice.prefix)
        graph = graph.set_operator(node, choice.node)
        graph = graph.set_dependencies(node, (new_data,) + tuple(rest))
        if not choice.prefix:
            return graph
        # runtime endpoint: delegating children apply the fitted model to
        # live input; that input must pass through the same prefix
        for child in list(graph.get_children(node)):
            if not isinstance(child, NodeId):
                continue
            if not isinstance(graph.get_operator(child), DelegatingOperator):
                continue
            cdeps = graph.get_dependencies(child)
            new_cdeps: List[GraphId] = [cdeps[0]]
            for rt_in in cdeps[1:]:
                graph, wrapped = self._insert_prefix(
                    graph, rt_in, choice.prefix)
                new_cdeps.append(wrapped)
            graph = graph.set_dependencies(child, tuple(new_cdeps))
        return graph

    def _splice_transformer(self, graph: Graph, node: NodeId,
                            choice: NodeChoice) -> Graph:
        new_deps = []
        for dep in graph.get_dependencies(node):
            graph, wrapped = self._insert_prefix(graph, dep, choice.prefix)
            new_deps.append(wrapped)
        graph = graph.set_operator(node, choice.node)
        return graph.set_dependencies(node, tuple(new_deps))

    @staticmethod
    def _feeds_streaming(graph: Graph, node: NodeId) -> bool:
        """True when any dataset feeding ``node`` is a StreamingDataset:
        executing the prefix on a sample there is the materialization
        streaming exists to avoid."""
        anc: set = set()
        for d in graph.get_dependencies(node):
            anc.add(d)
            anc |= graph.get_ancestors(d)
        for a in anc:
            if not isinstance(a, NodeId) or a not in graph.operators:
                continue
            op = graph.get_operator(a)
            if isinstance(op, DatasetOperator) and is_streaming(op.dataset):
                return True
        return False

    # -- static path ------------------------------------------------------
    @staticmethod
    def _static_choice(analysis, graph: Graph, node: NodeId, op,
                       machines: int) -> Optional[Tuple[NodeChoice, int]]:
        """The node's choice from statically inferred shapes, or None
        when the analyzer (or the node) declines."""
        from ...analysis.spec import DatasetSpec

        deps = graph.get_dependencies(node)
        data_spec = analysis.value(deps[0]) if deps else None
        if not isinstance(data_spec, DatasetSpec) or data_spec.n is None:
            return None
        n = data_spec.n
        if isinstance(op, OptimizableLabelEstimator):
            if len(deps) < 2:
                return None
            labels_spec = analysis.value(deps[1])
            if not isinstance(labels_spec, DatasetSpec):
                return None
            choice = op.optimize_static(data_spec, n, machines,
                                        labels_spec=labels_spec)
        else:
            choice = op.optimize_static(data_spec, n, machines)
        return None if choice is None else (choice, n)

    # -- trace hook -------------------------------------------------------
    @staticmethod
    def _record_choice(node: NodeId, op, choice: NodeChoice, n: int,
                       machines: int, wall_s: float,
                       provenance: str) -> None:
        """The splice decision, on the active trace (the per-solver cost
        table is the optimizable node's own record, e.g.
        ``LeastSquaresEstimator``'s solver decision)."""
        trace = current_trace()
        if trace is None:
            return
        trace.record_node_choice({
            "node_id": node.id,
            "optimizable": type(op).__name__,
            "chosen": type(choice.node).__name__,
            "prefix": [type(t).__name__ for t in choice.prefix],
            "full_n": n,
            "num_machines": machines,
            "sample_and_optimize_s": wall_s,
            "provenance": provenance,
        })

    # -- rule entry -------------------------------------------------------
    def apply(self, graph: Graph) -> Graph:
        self.splices = 0
        if not any(isinstance(op, _OPTIMIZABLE)
                   for op in graph.operators.values()):
            return graph
        # ids reachable from unconnected (runtime) sources can't be sampled
        downstream = graph.source_descendants()
        machines = self.num_machines or 1
        values = _SampledValues(self.sample_size)
        # one abstract interpretation serves every optimizable node on the
        # same graph state; a splice changes the graph and drops it. The
        # memo keeps the specs of unchanged transformers across splices
        analysis, memo = None, {}
        for node in graph.linearize():
            if not isinstance(node, NodeId) or node not in graph.operators:
                continue
            op = graph.get_operator(node)
            if node in downstream or not isinstance(op, _OPTIMIZABLE):
                continue
            t0 = time.perf_counter()
            static = None
            if self.static_shapes:
                if analysis is None:
                    from ...analysis.interpreter import analyze

                    analysis = analyze(graph, memo=memo)
                static = self._static_choice(analysis, graph, node, op,
                                             machines)
            if static is not None:
                choice, n = static
                provenance = "static"
            elif self._feeds_streaming(graph, node):
                # a streamable estimator chooses at finalize from the
                # exact accumulated shape; a non-streamable one raises
                # the non-streamable-fit error at fit
                continue
            else:
                provenance = "sampled"
                if isinstance(op, OptimizableLabelEstimator):
                    (sample, sample_labels), n = self._execute_sampled(
                        graph, graph.get_dependencies(node)[:2], values)
                    choice = op.optimize(sample, sample_labels, n, machines)
                else:
                    (sample,), n = self._execute_sampled(
                        graph, graph.get_dependencies(node)[:1], values)
                    choice = op.optimize(sample, n, machines)
            self._record_choice(node, op, choice, n, machines,
                                time.perf_counter() - t0, provenance)
            if isinstance(op, OptimizableTransformer):
                graph = self._splice_transformer(graph, node, choice)
            else:
                graph = self._splice_estimator(graph, node, choice)
            values.drop(graph, node)
            analysis = None
            self.splices += 1
        return graph
