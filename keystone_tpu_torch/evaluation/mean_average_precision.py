"""Mean average precision.

Counterpart of ``keystone_tpu/evaluation/mean_average_precision.py``
(reference ``evaluation/MeanAveragePrecisionEvaluator.scala``; the
VOC2007-2009 11-point interpolated AP of the enceval toolkit), on the
host in float64: the score matrix is (n, numClasses) and small.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from ..parallel.dataset import Dataset, to_numpy


def _labels_matrix(actual: Any, n: int, num_classes: int) -> np.ndarray:
    """Multi-label ground truth -> dense {0,1} (n, num_classes)."""
    if isinstance(actual, Dataset):
        actual = actual.collect()
    gt = np.zeros((n, num_classes), dtype=np.float64)
    for i, labels in enumerate(actual):
        arr = np.atleast_1d(np.asarray(to_numpy(labels), dtype=np.int64))
        arr = arr[arr >= 0]  # padded multi-label rows use -1 for missing
        gt[i, arr] = 1.0
    return gt


def _per_class_pr(scores: np.ndarray, gt: np.ndarray):
    """Per-class precision/recall curves: sort each class's scores
    descending, cumulative true and false positives (the scanLeft at
    ``MeanAveragePrecisionEvaluator.scala:47-56``)."""
    order = np.argsort(-scores, axis=0, kind="stable")  # (n, k)
    gt_sorted = np.take_along_axis(gt, order, axis=0)
    tps = np.cumsum(gt_sorted, axis=0)
    fps = np.cumsum(1.0 - gt_sorted, axis=0)
    total = gt.sum(axis=0)
    recalls = tps / np.maximum(total, 1.0)[None, :]
    precisions = tps / np.maximum(tps + fps, 1.0)
    return precisions, recalls


def _ap_11point(precisions: np.ndarray, recalls: np.ndarray) -> float:
    """11-point interpolated AP (reference ``getAP``,
    ``MeanAveragePrecisionEvaluator.scala:69-84``)."""
    ap = 0.0
    for t in (i / 10.0 for i in range(11)):
        px = precisions[recalls >= t]
        ap += (px.max() if px.size else 0.0) / 11.0
    return ap


def evaluate_mean_average_precision(
    actual: Any, predicted: Any, num_classes: int
) -> np.ndarray:
    """Average precision per class; the mean of the result is the MAP.
    ``predicted`` is an (n, num_classes) score matrix (array, tensor,
    dataset or lazy result); ``actual`` the n label lists."""
    scores = to_numpy(predicted, dtype=np.float64)
    n = scores.shape[0]
    gt = _labels_matrix(actual, n, num_classes)
    precisions, recalls = _per_class_pr(scores, gt)
    return np.array([
        _ap_11point(precisions[:, c], recalls[:, c])
        for c in range(num_classes)
    ])


class MeanAveragePrecisionEvaluator:
    """The evaluator object over :func:`evaluate_mean_average_precision`
    (the JAX package's ``MeanAveragePrecisionEvaluator``)."""

    def evaluate(self, actual: Any, predicted: Any,
                 num_classes: int) -> np.ndarray:
        return evaluate_mean_average_precision(actual, predicted,
                                               num_classes)
