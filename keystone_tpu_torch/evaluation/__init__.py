"""Evaluators of the port (counterpart of ``keystone_tpu/evaluation``):
multiclass, binary, mean average precision and augmented examples."""
from .augmented import (
    AVERAGE_POLICY,
    BORDA_POLICY,
    AugmentedExamplesEvaluator,
    evaluate_augmented,
)
from .binary import (
    BinaryClassificationMetrics,
    BinaryClassifierEvaluator,
    evaluate_binary,
)
from .mean_average_precision import (
    MeanAveragePrecisionEvaluator,
    evaluate_mean_average_precision,
)
from .multiclass import (
    MulticlassClassifierEvaluator,
    MulticlassMetrics,
    evaluate_multiclass,
)

__all__ = [
    "AVERAGE_POLICY",
    "BORDA_POLICY",
    "AugmentedExamplesEvaluator",
    "evaluate_augmented",
    "BinaryClassificationMetrics",
    "BinaryClassifierEvaluator",
    "evaluate_binary",
    "MeanAveragePrecisionEvaluator",
    "evaluate_mean_average_precision",
    "MulticlassClassifierEvaluator",
    "MulticlassMetrics",
    "evaluate_multiclass",
]
