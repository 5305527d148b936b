"""Augmented-example evaluation (reference
``evaluation/AugmentedExamplesEvaluator.scala``).

Counterpart of ``keystone_tpu/evaluation/augmented.py``: test-time
augmentation gives several predictions a source example (center and
corner patches); they are grouped by example name, aggregated (the
elementwise average, or the Borda count: the sum of each patch's score
ranks), and the argmax goes to multiclass evaluation. Grouping runs on
the host (names are arbitrary keys), in float64.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..parallel.dataset import ArrayDataset, Dataset, to_numpy
from .multiclass import MulticlassMetrics, evaluate_multiclass

AVERAGE_POLICY = "average"
BORDA_POLICY = "borda"


def average_policy(preds: np.ndarray) -> np.ndarray:
    """Mean of the per-patch score vectors
    (reference ``AugmentedExamplesEvaluator.scala:17-19``)."""
    return preds.mean(axis=0)


def borda_policy(preds: np.ndarray) -> np.ndarray:
    """Sum of per-patch ranks: each patch gives each class its rank in
    sorted order (reference ``AugmentedExamplesEvaluator.scala:28-35``)."""
    ranks = np.argsort(np.argsort(preds, axis=1), axis=1).astype(np.float64)
    return ranks.sum(axis=0)


def _collect(x: Any) -> List[Any]:
    if isinstance(x, Dataset) and not isinstance(x, ArrayDataset):
        return [to_numpy(v) for v in x.collect()]   # ragged host items
    arr = to_numpy(x) if not isinstance(x, list) else x
    return [arr[i] for i in range(len(arr))]


def evaluate_augmented(names: Any, predicted: Any, actual_labels: Any,
                       num_classes: int,
                       policy: str = AVERAGE_POLICY) -> MulticlassMetrics:
    """Group augmented predictions by example name (in order of first
    appearance), aggregate, argmax, then multiclass evaluation
    (reference ``AugmentedExamplesEvaluator.scala:37-69``). Every copy
    of an example must carry the same label."""
    agg = borda_policy if policy == BORDA_POLICY else average_policy
    names_l = _collect(names)
    preds_l = _collect(predicted)
    labels_l = [int(np.asarray(v)) for v in _collect(actual_labels)]
    assert len(names_l) == len(preds_l) == len(labels_l)

    groups: Dict[Any, List[int]] = {}
    for i, name in enumerate(names_l):
        key = name if np.isscalar(name) or isinstance(name, (str, tuple)) \
            else np.asarray(name).tobytes()
        groups.setdefault(key, []).append(i)

    final_preds, final_actuals = [], []
    for idx in groups.values():
        group_labels = {labels_l[i] for i in idx}
        assert len(group_labels) == 1, (
            f"augmented copies of one example disagree on label: "
            f"{group_labels}")
        stacked = np.stack([np.asarray(preds_l[i], np.float64) for i in idx])
        final_preds.append(int(np.argmax(agg(stacked))))
        final_actuals.append(labels_l[idx[0]])
    return evaluate_multiclass(np.asarray(final_preds),
                               np.asarray(final_actuals), num_classes)


class AugmentedExamplesEvaluator:
    def evaluate(self, names, predicted, actual_labels, num_classes,
                 policy: str = AVERAGE_POLICY) -> MulticlassMetrics:
        return evaluate_augmented(names, predicted, actual_labels,
                                  num_classes, policy)
