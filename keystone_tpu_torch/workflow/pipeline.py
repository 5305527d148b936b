"""Typed pipeline API over the untyped graph layer.

Counterpart of ``keystone_tpu/workflow/pipeline.py`` (reference
``workflow/graph/{Pipeline,Chainable,PipelineDataset,PipelineDatum,
PipelineResult,FittedPipeline,GatherTransformerOperator}.scala``). A
Pipeline's graph has exactly one dangling Source (its input) and one Sink
(its output); ``and_then`` composes by source-to-sink splicing; ``apply``
binds data and returns a lazy result; ``fit`` executes every estimator and
freezes the DAG into a transformer-only FittedPipeline.

Raw arrays handed to ``apply`` / ``apply_datum`` are staged on
``device`` (default ``"cuda"``); a Dataset keeps the device it was made
on.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..observability.timeline import flight_span
from ..ops.device import DEFAULT_DEVICE, resolve_device
from ..parallel.dataset import ArrayDataset, Dataset, HostDataset, as_dataset
from .executor import GraphExecutor
from .graph import Graph
from .graph_ids import GraphId, SinkId, SourceId
from .operators import (
    DatasetOperator,
    DatumOperator,
    DelegatingOperator,
    TransformerOperator,
)


class PipelineResult:
    """Lazy handle on one sink of an executing graph."""

    def __init__(self, executor: GraphExecutor, sink: SinkId):
        self._executor = executor
        self._sink = sink

    def get(self) -> Any:
        with flight_span("execute:get", "pipeline"):
            return self._executor.execute(self._sink).get()

    # graph/sink exposed for splicing this result into other pipelines
    @property
    def _graph(self) -> Graph:
        return self._executor.raw_graph


class PipelineDataset(PipelineResult):
    """Lazy dataset result."""

    def collect(self) -> List[Any]:
        return self.get().collect()

    def numpy(self):
        return self.get().numpy()


class PipelineDatum(PipelineResult):
    """Lazy single-item result."""


DataInput = Union[PipelineResult, Dataset, np.ndarray, torch.Tensor, list,
                  tuple]


def _add_data_input(graph: Graph, data: DataInput,
                    device=DEFAULT_DEVICE) -> Tuple[Graph, GraphId]:
    """Splice a data input into ``graph``; returns the id producing it."""
    if isinstance(data, PipelineResult):
        g2, _, kmap = graph.add_graph(data._graph)
        new_sink = kmap[data._sink]
        out = g2.get_sink_dependency(new_sink)
        return g2.remove_sink(new_sink), out
    return graph.add_node(DatasetOperator(as_dataset(data, device)), ())


def _add_datum_input(graph: Graph, datum: Any,
                     device=DEFAULT_DEVICE) -> Tuple[Graph, GraphId]:
    if isinstance(datum, PipelineResult):
        return _add_data_input(graph, datum)
    if not isinstance(datum, torch.Tensor) and isinstance(
            datum, (np.ndarray, np.generic, float, int)):
        datum = torch.as_tensor(np.asarray(datum),
                                device=resolve_device(device))
    return graph.add_node(DatumOperator(datum), ())


class Chainable:
    """Anything that can appear as a pipeline stage."""

    def to_pipeline(self) -> "Pipeline":
        raise NotImplementedError

    def and_then(self, nxt, data: Optional[DataInput] = None, labels=None,
                 device=DEFAULT_DEVICE):
        """Compose with a transformer/pipeline, or with an (label)estimator
        plus its training data; mirrors the reference's andThen overloads.
        Raw training arrays are staged on ``device``."""
        from .estimator import Estimator
        from .label_estimator import LabelEstimator

        me = self.to_pipeline()
        if isinstance(nxt, LabelEstimator):
            if data is None or labels is None:
                raise ValueError("LabelEstimator stage needs data and labels")
            return me.and_then(nxt.with_data(me.bind(data, device), labels,
                                             device))
        if isinstance(nxt, Estimator):
            if data is None:
                raise ValueError("Estimator stage needs training data")
            return me.and_then(nxt.with_data(me.bind(data, device)))
        if data is not None or labels is not None:
            raise ValueError("data/labels only apply to estimator stages")
        other = nxt.to_pipeline()
        new_graph, _, kmap = me._graph.connect_graph(
            other._graph, {other._source: me._sink}
        )
        return Pipeline(new_graph, me._source, kmap[other._sink])

    def __rshift__(self, nxt) -> "Pipeline":
        return self.and_then(nxt)

    # -- execution entry points ------------------------------------------
    def bind(self, data: DataInput, device=DEFAULT_DEVICE) -> PipelineDataset:
        """Lazily apply to a dataset. Named ``bind`` (not ``apply``)
        because Transformer reserves ``apply`` for the per-item function,
        as in the reference."""
        me = self.to_pipeline()
        g, out = _add_data_input(Graph(), data, device)
        g, data_sink = g.add_sink(out)
        new_graph, _, kmap = g.connect_graph(me._graph, {me._source: data_sink})
        return PipelineDataset(GraphExecutor(new_graph), kmap[me._sink])

    def bind_datum(self, datum: Any, device=DEFAULT_DEVICE) -> PipelineDatum:
        me = self.to_pipeline()
        g, out = _add_datum_input(Graph(), datum, device)
        g, datum_sink = g.add_sink(out)
        new_graph, _, kmap = g.connect_graph(me._graph, {me._source: datum_sink})
        return PipelineDatum(GraphExecutor(new_graph), kmap[me._sink])

    def __call__(self, data: Any, device=DEFAULT_DEVICE):
        if isinstance(data, PipelineDatum):
            return self.bind_datum(data, device)
        if isinstance(data, (PipelineDataset, Dataset, list)) or hasattr(
                data, "ndim"):
            return self.bind(data, device)
        return self.bind_datum(data, device)


    def check(self, sample: Any = None, name: str = "pipeline",
              hbm_budget: Optional[float] = None,
              data_shards: Optional[int] = None):
        """Statically check this stage or pipeline: propagate shape and
        dtype specs from ``sample`` (a ``ShapeDtype``, ``(shape, dtype)``
        pair, tensor, Dataset or ``analysis`` spec describing ONE input
        item) through every node on meta tensors, run the graph lints and
        fold per-node resource effects into a static device-memory plan
        (``report.plan``). ``hbm_budget`` (bytes) turns a predicted
        over-budget fit into an ``hbm-budget`` error before anything runs.
        ``data_shards`` is the data-axis width the plan pads resident
        batches to (one rank's charge in a world of that many shards).
        Returns an :class:`~keystone_tpu_torch.analysis.AnalysisReport`."""
        from ..analysis import check_pipeline

        return check_pipeline(self, sample, name=name, hbm_budget=hbm_budget,
                              data_shards=data_shards)


class Pipeline(Chainable):
    """A DAG with one dangling source (input) and one sink (output)."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        assert source in graph.sources
        assert sink in graph.sinks
        self._graph = graph
        self._source = source
        self._sink = sink

    def to_pipeline(self) -> "Pipeline":
        return self

    # Pipelines have no per-item function, so ``apply`` can keep the
    # reference's name for data application.
    def apply(self, data: DataInput, device=DEFAULT_DEVICE) -> PipelineDataset:
        return self.bind(data, device)

    def apply_datum(self, datum: Any, device=DEFAULT_DEVICE) -> PipelineDatum:
        return self.bind_datum(datum, device)

    @property
    def graph(self) -> Graph:
        return self._graph

    def to_dot(self) -> str:
        return self._graph.to_dot()

    def fit(self) -> "FittedPipeline":
        """Execute every estimator fit reachable in this pipeline, replace
        delegating nodes by their fitted transformers, prune the fit-time
        branches, and freeze (``graph/Pipeline.scala:38-65``)."""
        from .optimizer.rules import UnusedBranchRemovalRule

        with flight_span("execute:fit", "pipeline"):
            executor = GraphExecutor(self._graph)
            g = executor.graph
            out = g
            for n in sorted(g.nodes, key=lambda x: x.id):
                if isinstance(g.get_operator(n), DelegatingOperator):
                    deps = g.get_dependencies(n)
                    fitted = executor.execute(deps[0]).get()
                    assert isinstance(fitted, TransformerOperator)
                    out = out.set_operator(n, fitted).set_dependencies(
                        n, deps[1:])
            out = UnusedBranchRemovalRule().apply(out)
            return FittedPipeline(out, self._source, self._sink)

    @staticmethod
    def gather(branches: Sequence[Chainable]) -> "Pipeline":
        """Parallel-branch combinator: one input fans out to every branch
        and the outputs are zipped into per-item tuples."""
        g = Graph()
        g, src = g.add_source()
        outs: List[GraphId] = []
        for b in branches:
            bp = b.to_pipeline()
            g, smap, kmap = g.add_graph(bp._graph)
            g = g.replace_dependency(smap[bp._source], src).remove_source(
                smap[bp._source]
            )
            new_sink = kmap[bp._sink]
            outs.append(g.get_sink_dependency(new_sink))
            g = g.remove_sink(new_sink)
        g, gather_node = g.add_node(GatherTransformerOperator(len(branches)), outs)
        g, sink = g.add_sink(gather_node)
        return Pipeline(g, src, sink)

    @staticmethod
    def identity() -> "Pipeline":
        g = Graph()
        g, src = g.add_source()
        g, sink = g.add_sink(src)
        return Pipeline(g, src, sink)


class GatherTransformerOperator(TransformerOperator):
    """Zips N branch outputs into per-item tuples."""

    def __init__(self, arity: int):
        self.arity = arity

    def single_transform(self, inputs: Sequence[Any]) -> Any:
        return tuple(inputs)

    def batch_transform(self, inputs: Sequence[Dataset]) -> Dataset:
        assert len(inputs) == self.arity
        first = inputs[0]
        if isinstance(first, ArrayDataset):
            return first.zip(*inputs[1:])  # type: ignore[arg-type]
        zipped = zip(*[d.collect() for d in inputs])
        return HostDataset([tuple(t) for t in zipped])

    def label(self) -> str:
        return f"Gather[{self.arity}]"


class FittedPipeline(Chainable):
    """A transformer-only pipeline; applying it never fits anything and it
    is serializable."""

    def __init__(self, graph: Graph, source: SourceId, sink: SinkId):
        for n in graph.nodes:
            op = graph.get_operator(n)
            assert isinstance(op, (TransformerOperator,)) or not hasattr(
                op, "fit_datasets"
            ), f"estimator survived fit(): {op}"
        self._graph = graph
        self._source = source
        self._sink = sink

    def to_pipeline(self) -> Pipeline:
        return Pipeline(self._graph, self._source, self._sink)

    def apply(self, data: DataInput, device=DEFAULT_DEVICE) -> PipelineDataset:
        return self.to_pipeline().bind(data, device)

    def apply_datum(self, datum: Any, device=DEFAULT_DEVICE) -> PipelineDatum:
        return self.to_pipeline().bind_datum(datum, device)

    # FittedPipelines pickle via their graphs; executors/expressions are
    # rebuilt on demand.
    def __getstate__(self):
        return {"graph": self._graph, "source": self._source, "sink": self._sink}

    def __setstate__(self, state):
        self._graph = state["graph"]
        self._source = state["source"]
        self._sink = state["sink"]
