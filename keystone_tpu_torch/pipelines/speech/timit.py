"""TIMIT: random cosine features + block least squares.

Counterpart of ``keystone_tpu/pipelines/speech/timit.py`` (reference
``pipelines/speech/TimitPipeline.scala:21-148``): gather(num_cosines x
CosineRandomFeatures(440 -> 4096, Gaussian or Cauchy W)) ->
VectorCombiner -> BlockLeastSquares(4096, num_epochs, lambda) ->
MaxClassifier over 147 phone classes. The published 50 branches give
204,800 features. The optimizer fuses the branches, their gather and the
combiner into one node, which writes each branch's features into its
column block of the gathered matrix. ``run`` takes the data as
``TimitFeaturesData``, or reads the CSV files its config names
(``loaders/timit.py``); ``main`` is ``python -m keystone_tpu_torch
speech.timit``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

from ...evaluation.multiclass import evaluate_multiclass
from ...loaders.csv_loader import LabeledData
from ...loaders.timit import (
    NUM_CLASSES,
    TIMIT_DIMENSION,
    TimitFeaturesData,
    timit_features_loader,
)
from ...nodes.learning import BlockLeastSquaresEstimator
from ...nodes.stats import CosineRandomFeatures
from ...nodes.util import (
    ClassLabelIndicatorsFromIntLabels,
    MaxClassifier,
    VectorCombiner,
)
from ...ops.device import DEFAULT_DEVICE, resolve_device
from ...workflow.pipeline import Pipeline

NUM_COSINE_FEATURES = 4096


@dataclass
class TimitConfig:
    train_data_location: str = ""
    train_labels_location: str = ""
    test_data_location: str = ""
    test_labels_location: str = ""
    num_cosines: int = 50
    gamma: float = 0.05555
    rf_type: str = "gaussian"  # or "cauchy"
    lam: float = 0.0
    num_epochs: int = 5
    seed: int = 123
    num_cosine_features: int = NUM_COSINE_FEATURES


def build_featurizer(config: TimitConfig,
                     input_dim: int = TIMIT_DIMENSION) -> Pipeline:
    """The gathered cosine branches, branch i seeded ``seed + i``, then
    the concatenation."""
    branches = [
        CosineRandomFeatures.create(
            input_dim, config.num_cosine_features, config.gamma,
            w_dist="cauchy" if config.rf_type == "cauchy" else "gaussian",
            b_dist="uniform", seed=config.seed + i)
        for i in range(config.num_cosines)
    ]
    return Pipeline.gather(branches) >> VectorCombiner()


def build_pipeline(config: TimitConfig, train: LabeledData,
                   num_classes: int = NUM_CLASSES,
                   input_dim: Optional[int] = None):
    """The unfitted predictor: (n, input_dim) frames -> class indices, its
    solver fitted on ``train``. ``input_dim`` defaults to the frames'."""
    if input_dim is None:
        input_dim = int(train.data.data.shape[-1])
    labels = ClassLabelIndicatorsFromIntLabels(num_classes)(train.labels)
    return build_featurizer(config, input_dim).and_then(
        BlockLeastSquaresEstimator(config.num_cosine_features,
                                   config.num_epochs, config.lam),
        train.data, labels) >> MaxClassifier()


def run(config: TimitConfig, data: Optional[TimitFeaturesData] = None,
        num_classes: int = NUM_CLASSES, input_dim: Optional[int] = None,
        device=DEFAULT_DEVICE):
    """Fit on ``data.train`` (read from the config's files when ``data``
    is None) and evaluate on ``data.test``, both moved to ``device``.
    Returns (fitted pipeline, test metrics)."""
    dev = resolve_device(device)
    start = time.time()
    if data is None:
        data = timit_features_loader(
            config.train_data_location, config.train_labels_location,
            config.test_data_location, config.test_labels_location, dev)
    train, test = data.train.to(dev), data.test.to(dev)
    pipeline = build_pipeline(config, train, num_classes, input_dim).fit()
    test_eval = evaluate_multiclass(pipeline(test.data), test.labels,
                                    num_classes)
    print(f"TEST Error is {100 * test_eval.total_error:.2f}%")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return pipeline, test_eval


def main(argv=None):
    p = argparse.ArgumentParser("Timit")
    p.add_argument("--trainDataLocation", required=True)
    p.add_argument("--trainLabelsLocation", required=True)
    p.add_argument("--testDataLocation", required=True)
    p.add_argument("--testLabelsLocation", required=True)
    p.add_argument("--numCosines", type=int, default=50)
    p.add_argument("--gamma", type=float, default=0.05555)
    p.add_argument("--rfType", default="gaussian")
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--numEpochs", type=int, default=5)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(TimitConfig(
        a.trainDataLocation, a.trainLabelsLocation, a.testDataLocation,
        a.testLabelsLocation, a.numCosines, a.gamma, a.rfType, a.lam,
        a.numEpochs), device=a.device)


if __name__ == "__main__":
    main()
