"""Utility nodes (reference ``nodes/util``).

Counterpart of the label, classifier, combiner and densifying nodes of
``keystone_tpu/nodes/util/__init__.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.device import resolve_device
from ...parallel.dataset import ArrayDataset, Dataset, is_streaming
from ...workflow.transformer import Transformer


class ClassLabelIndicatorsFromIntLabels(Transformer):
    """int label -> +-1 one-hot vector
    (reference ``util/ClassLabelIndicators.scala:15-34``)."""

    def __init__(self, num_classes: int):
        assert num_classes > 1, "numClasses must be > 1"
        self.num_classes = num_classes

    def apply_batch(self, labels):
        idx = torch.arange(self.num_classes, device=labels.device)
        hit = idx == labels.reshape(labels.shape + (1,))
        return torch.where(hit, 1.0, -1.0).to(torch.float32)

    def apply(self, label):
        return self.apply_batch(label)


class ClassLabelIndicatorsFromIntArrayLabels(Transformer):
    """multi-label int array -> +-1 multi-hot vector
    (reference ``util/ClassLabelIndicators.scala:41-55``). Inputs are
    fixed-width label arrays padded with -1 for missing entries."""

    def __init__(self, num_classes: int):
        assert num_classes > 1, "numClasses must be > 1"
        self.num_classes = num_classes

    def apply_batch(self, labels):
        idx = torch.arange(self.num_classes, device=labels.device)
        hits = (labels[..., :, None] == idx).any(dim=-2)
        return torch.where(hits, 1.0, -1.0).to(torch.float32)

    def apply(self, labels):
        return self.apply_batch(labels)


class VectorCombiner(Transformer):
    """Concatenate a gathered tuple of vectors into one vector
    (reference ``util/VectorCombiner.scala:12-14``)."""

    def apply(self, xs):
        return torch.cat(list(xs), dim=-1)

    def apply_batch(self, Xs):
        return self.apply(Xs)


class MaxClassifier(Transformer):
    """argmax (reference ``util/MaxClassifier.scala:9-11``)."""

    def apply(self, x):
        return torch.argmax(x, dim=-1).to(torch.int32)

    def apply_batch(self, X):
        return self.apply(X)


class FloatToDouble(Transformer):
    """Precision promotion (reference ``util/FloatToDouble.scala``). Like
    the JAX package without x64, it yields float32: the solvers downstream
    run in true float32."""

    def apply(self, x):
        return x.to(torch.float32)

    def apply_batch(self, X):
        return X.to(torch.float32)


class MatrixVectorizer(Transformer):
    """Flatten a matrix into a vector, column-major to match Breeze's
    ``toDenseVector`` (reference ``util/MatrixVectorizer.scala``)."""

    def apply(self, x):
        return x.T.reshape(-1)

    def apply_batch(self, X):
        return X.transpose(1, 2).reshape(X.shape[0], -1)


class Densify(Transformer):
    """Sparse -> dense (reference ``util/Densify.scala:10-21``). Array
    datasets and streams are already dense and pass through; a host
    dataset is stacked into an ArrayDataset. Tensors stay on their
    device; host items (SparseVectors, numpy arrays) go to ``device``,
    the default device (``"cuda"``) when it is None."""

    fusable = False

    def __init__(self, device=None):
        self.device = device

    def _host_device(self):
        return resolve_device() if self.device is None else resolve_device(
            self.device)

    def apply(self, x):
        if hasattr(x, "todense"):
            return torch.as_tensor(x.todense(), device=self._host_device())
        return x

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if isinstance(ds, ArrayDataset) or is_streaming(ds):
            return ds
        items = ds.collect()
        if items and all(isinstance(it, torch.Tensor) for it in items):
            return ArrayDataset.from_items([it.reshape(-1) for it in items],
                                           items[0].device)
        dense = [np.asarray(it.todense() if hasattr(it, "todense") else it,
                            dtype=np.float32).ravel() for it in items]
        return ArrayDataset.from_numpy(np.stack(dense), self._host_device())
