"""Binary classifier evaluation (reference
``evaluation/BinaryClassifierEvaluator.scala``).

Counterpart of ``keystone_tpu/evaluation/binary.py``: one pass over the
zipped predictions and actuals, four masked sums of boolean tensors on
the predictions' device, where the reference zips RDDs and reduces
per-item tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from ..parallel.dataset import ArrayDataset, to_numpy


def _div(num: float, denom: float) -> float:
    """JVM double division: 0 / 0 is nan, nothing raises."""
    return num / denom if denom != 0.0 else float("nan")


@dataclass
class BinaryClassificationMetrics:
    """Contingency table and the metrics derived from it
    (reference ``BinaryClassifierEvaluator.scala:17-57``)."""

    tp: float
    fp: float
    tn: float
    fn: float

    def merge(self, other: "BinaryClassificationMetrics"):
        return BinaryClassificationMetrics(
            self.tp + other.tp, self.fp + other.fp,
            self.tn + other.tn, self.fn + other.fn)

    @property
    def accuracy(self) -> float:
        return _div(self.tp + self.tn, self.tp + self.fp + self.tn + self.fn)

    @property
    def error(self) -> float:
        return _div(self.fp + self.fn, self.tp + self.fp + self.tn + self.fn)

    @property
    def recall(self) -> float:
        return _div(self.tp, self.tp + self.fn)

    @property
    def precision(self) -> float:
        return _div(self.tp, self.tp + self.fp)

    @property
    def specificity(self) -> float:
        return _div(self.tn, self.fp + self.tn)

    def f_score(self, beta: float = 1.0) -> float:
        num = (1.0 + beta * beta) * self.tp
        denom = (1.0 + beta * beta) * self.tp + beta * beta * self.fn + self.fp
        return _div(num, denom)

    def summary(self) -> str:
        return (
            f" Accuracy:\t{self.accuracy:2.3f}\n"
            f"Precision:\t{self.precision:2.3f}\n"
            f"Recall:\t{self.recall:2.3f}\n"
            f"Specificity:\t{self.specificity:2.3f}\n"
            f"F1:\t{self.f_score():2.3f}\n"
        )


def _to_bool(x: Any) -> torch.Tensor:
    """A flat bool tensor: tensors and array datasets stay on their
    device, anything else is read on the host."""
    if hasattr(x, "get") and not isinstance(x, torch.Tensor):
        x = x.get()
    if isinstance(x, ArrayDataset):
        x = x.data[: x.n]
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(to_numpy(x, dtype=bool))
    return x.reshape(-1).to(torch.bool)


def evaluate_binary(predictions: Any,
                    actuals: Any) -> BinaryClassificationMetrics:
    """Contingency table of boolean predictions against actuals
    (reference ``BinaryClassifierEvaluator.scala:70-79``)."""
    p = _to_bool(predictions)
    a = _to_bool(actuals).to(p.device)
    assert p.shape == a.shape, "predictions and actuals must align"
    counts = torch.stack([(p & a).sum(), (p & ~a).sum(), (~p & ~a).sum(),
                          (~p & a).sum()]).tolist()
    return BinaryClassificationMetrics(*(float(c) for c in counts))


class BinaryClassifierEvaluator:
    def evaluate(self, predictions: Any,
                 actuals: Any) -> BinaryClassificationMetrics:
        return evaluate_binary(predictions, actuals)
