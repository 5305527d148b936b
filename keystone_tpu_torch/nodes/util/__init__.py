"""Utility nodes (reference ``nodes/util``).

Counterpart of the label and classifier nodes of
``keystone_tpu/nodes/util/__init__.py``.
"""
from __future__ import annotations

import torch

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
