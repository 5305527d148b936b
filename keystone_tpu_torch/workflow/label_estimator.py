"""LabelEstimator: fits on (data, labels) pairs.

Counterpart of ``keystone_tpu/workflow/label_estimator.py`` (reference
``workflow/LabelEstimator.scala``): same contract as Estimator with a
second labels input; ``with_data(data, labels)`` builds the 4-node
fit-time subgraph. Streamed data routes through ``fit_streaming``, with
labels either an aligned stream or resident and sliced chunk by chunk.
"""
from __future__ import annotations

from typing import Any, Callable

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import Dataset, as_dataset, is_streaming
from ..parallel.streaming import fit_streaming
from .estimator import _refuse_stream_opts
from .graph import Graph
from .operators import DelegatingOperator, EstimatorOperator
from .pipeline import DataInput, Pipeline, PipelineDataset, _add_data_input
from .transformer import Transformer


class LabelEstimator(EstimatorOperator):
    def fit(self, data: Any, labels: Any, device=DEFAULT_DEVICE,
            **stream_opts: Any) -> Transformer:
        """Eager fit; raw arrays are staged on ``device``. Streamed
        ``data`` is fitted chunk by chunk through ``fit_streaming``
        (``labels`` an aligned StreamingDataset, or resident and sliced
        chunk-wise); ``stream_opts`` (``hbm_budget``,
        ``checkpoint_dir``, ``checkpoint_every``, ``quarantine``) apply
        only to such a fit and are refused for a resident one."""
        if isinstance(data, PipelineDataset):
            data = data.get()
        if isinstance(labels, PipelineDataset):
            labels = labels.get()
        if is_streaming(data):
            return fit_streaming(self, data, labels, **stream_opts)
        _refuse_stream_opts(self, stream_opts)
        self._refuse_streamed_labels(labels)
        return self._fit(as_dataset(data, device), as_dataset(labels, device))

    def _refuse_streamed_labels(self, labels: Any) -> None:
        if is_streaming(labels):
            raise TypeError(
                f"{self.label()}: labels are a StreamingDataset but the "
                "data is resident; the chunk loop is driven by the DATA "
                "stream. Stream the data too (chunk sizes must align), or "
                "materialize() the labels (they are k-wide, usually tiny).")

    def _fit(self, ds: Dataset, labels: Dataset) -> Transformer:
        raise NotImplementedError

    def fit_datasets(self, inputs):
        if is_streaming(inputs[0]):
            return fit_streaming(self, inputs[0], inputs[1])
        self._refuse_streamed_labels(inputs[1])
        return self._fit(inputs[0], inputs[1])

    def with_data(self, data: DataInput, labels: DataInput,
                  device=DEFAULT_DEVICE) -> Pipeline:
        g = Graph()
        g, data_id = _add_data_input(g, data, device)
        g, labels_id = _add_data_input(g, labels, device)
        g, est_id = g.add_node(self, (data_id, labels_id))
        g, src = g.add_source()
        g, dl = g.add_node(DelegatingOperator(), (est_id, src))
        g, sink = g.add_sink(dl)
        return Pipeline(g, src, sink)


class LambdaLabelEstimator(LabelEstimator):
    def __init__(
        self,
        fn: Callable[[Dataset, Dataset], Transformer],
        name: str = "LambdaLabelEst",
    ):
        self.fn = fn
        self.name = name

    def eq_key(self):
        return (LambdaLabelEstimator, self.fn, self.name)

    def _fit(self, ds: Dataset, labels: Dataset) -> Transformer:
        return self.fn(ds, labels)

    def label(self) -> str:
        return self.name
