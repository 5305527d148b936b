"""Node-level optimizable operators.

Counterpart of ``keystone_tpu/workflow/optimizable.py`` (reference
``workflow/OptimizableNodes.scala``). An optimizable node carries a
``default`` implementation (used when the optimizer never runs) and an
``optimize(sample..., n, num_machines)`` hook that inspects a data
sample and the workload shape and returns a :class:`NodeChoice`: the
implementation the cost model prefers, plus a transformer prefix applied
both to the training data and to the runtime input (``Sparsify`` before
a sparse solver, reference ``LeastSquaresEstimator.scala:36-53``).

``optimize_static(spec, n, num_machines)`` is the same choice from the
static analyzer's input spec (``analysis.spec.DatasetSpec``) instead of
a sample; it returns None where the cost inputs are not statically
derivable. ``NodeOptimizationRule`` (``optimizer/node_rule.py``) asks
``optimize_static`` first and falls back to ``optimize`` on a sampled
execution, then splices the choice into the DAG.
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

    fusable = False

    @property
    def default(self) -> Transformer:
        raise NotImplementedError

    def apply(self, x):
        return self.default.apply(x)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        return self.default.apply_dataset(ds)

    def optimize(self, sample: Dataset, n: int,
                 num_machines: int) -> NodeChoice:
        raise NotImplementedError

    def optimize_static(self, spec, n: int, num_machines: int):
        """The cost-model choice from the static analyzer's input spec
        instead of a sampled execution: a NodeChoice, or None to fall back
        to sampling (the default: nodes whose cost inputs are not
        statically derivable)."""
        return None


class OptimizableEstimator(Estimator):
    """An estimator with implementation choices
    (reference ``OptimizableNodes.scala:21-33``)."""

    @property
    def default(self) -> Estimator:
        raise NotImplementedError

    def _fit(self, ds: Dataset) -> Transformer:
        return self.default._fit(ds)

    def optimize(self, sample: Dataset, n: int,
                 num_machines: int) -> NodeChoice:
        raise NotImplementedError

    def optimize_static(self, spec, n: int, num_machines: int):
        """See :meth:`OptimizableTransformer.optimize_static`."""
        return None


class OptimizableLabelEstimator(LabelEstimator):
    """A label estimator with implementation choices
    (reference ``OptimizableNodes.scala:38-46``)."""

    @property
    def default(self) -> LabelEstimator:
        raise NotImplementedError

    def _fit(self, ds: Dataset, labels: Dataset) -> Transformer:
        return self.default._fit(ds, labels)

    def optimize(self, sample: Dataset, sample_labels: Dataset, n: int,
                 num_machines: int) -> NodeChoice:
        raise NotImplementedError

    def optimize_static(self, spec, n: int, num_machines: int,
                        labels_spec=None):
        """See :meth:`OptimizableTransformer.optimize_static`; label
        estimators also receive the labels' DatasetSpec."""
        return None
