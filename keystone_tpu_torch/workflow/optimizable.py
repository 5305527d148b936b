"""Node-level optimizable operators.

Counterpart of ``keystone_tpu/workflow/optimizable.py`` (reference
``workflow/OptimizableNodes.scala``). An optimizable node carries a
``default`` implementation and fits, and applies, through it. The JAX
package's node-level rule (``optimizer/node_rule.py``) calls each node's
``optimize`` hook and its cost models to splice a choice into the DAG;
the port has neither the rule nor the cost models yet (ROADMAP A6), so
every optimizable node runs its ``default``. ``NodeChoice`` is the
result type that rule will return.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from ..parallel.dataset import Dataset
from .estimator import Estimator
from .label_estimator import LabelEstimator
from .transformer import Transformer


@dataclass
class NodeChoice:
    """The sub-pipeline an optimizable node resolves to: ``prefix``
    transformers feed both the fit path and the runtime path, then
    ``node`` replaces the optimizable operator."""

    node: object
    prefix: Tuple[Transformer, ...] = ()


class OptimizableTransformer(Transformer):
    """A transformer with implementation choices
    (reference ``OptimizableNodes.scala:10-16``)."""

    @property
    def default(self) -> Transformer:
        raise NotImplementedError

    def apply(self, x):
        return self.default.apply(x)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        return self.default.apply_dataset(ds)


class OptimizableEstimator(Estimator):
    """An estimator with implementation choices
    (reference ``OptimizableNodes.scala:21-33``)."""

    @property
    def default(self) -> Estimator:
        raise NotImplementedError

    def _fit(self, ds: Dataset) -> Transformer:
        return self.default._fit(ds)


class OptimizableLabelEstimator(LabelEstimator):
    """A label estimator with implementation choices
    (reference ``OptimizableNodes.scala:38-46``)."""

    @property
    def default(self) -> LabelEstimator:
        raise NotImplementedError

    def _fit(self, ds: Dataset, labels: Dataset) -> Transformer:
        return self.default._fit(ds, labels)
