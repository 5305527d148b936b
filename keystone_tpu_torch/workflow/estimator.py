"""Estimator: fits on a dataset, yielding a Transformer.

Counterpart of ``keystone_tpu/workflow/estimator.py`` (reference
``workflow/Estimator.scala``): ``fit`` is the eager user-facing entry;
``with_data`` builds the lazy 3-node fit-time subgraph (data ->
estimator -> delegating transformer) whose estimator executes only when
the pipeline is first used. A StreamingDataset routes through the
accumulate/finalize protocol (``parallel.streaming.fit_streaming``).
"""
from __future__ import annotations

from typing import Any, Callable

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import Dataset, as_dataset, is_streaming
from ..parallel.streaming import fit_streaming
from .graph import Graph
from .operators import DelegatingOperator, EstimatorOperator
from .pipeline import DataInput, Pipeline, PipelineDataset, _add_data_input
from .transformer import Transformer


class Estimator(EstimatorOperator):
    def fit(self, data: Any, device=DEFAULT_DEVICE) -> Transformer:
        """Eagerly fit on a dataset (raw arrays are staged on ``device``),
        returning the fitted transformer. A StreamingDataset is fitted
        chunk by chunk through ``fit_streaming``, under the stream's own
        ``hbm_budget``."""
        if isinstance(data, PipelineDataset):
            data = data.get()
        if is_streaming(data):
            return fit_streaming(self, data)
        return self._fit(as_dataset(data, device))

    def _fit(self, ds: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, inputs):
        if is_streaming(inputs[0]):
            return fit_streaming(self, inputs[0])
        return self._fit(inputs[0])

    def with_data(self, data: DataInput, device=DEFAULT_DEVICE) -> Pipeline:
        """Lazy pipeline: source -> (fitted on ``data``) -> sink."""
        g = Graph()
        g, data_id = _add_data_input(g, data, device)
        g, est_id = g.add_node(self, (data_id,))
        g, src = g.add_source()
        g, dl = g.add_node(DelegatingOperator(), (est_id, src))
        g, sink = g.add_sink(dl)
        return Pipeline(g, src, sink)


class LambdaEstimator(Estimator):
    """Function lift (reference Estimator.scala:51-53)."""

    def __init__(self, fn: Callable[[Dataset], Transformer], name: str = "LambdaEst"):
        self.fn = fn
        self.name = name

    def eq_key(self):
        return (LambdaEstimator, self.fn, self.name)

    def _fit(self, ds: Dataset) -> Transformer:
        return self.fn(ds)

    def label(self) -> str:
        return self.name


def estimator(fn: Callable[[Dataset], Transformer]) -> LambdaEstimator:
    return LambdaEstimator(fn, getattr(fn, "__name__", "LambdaEst"))
