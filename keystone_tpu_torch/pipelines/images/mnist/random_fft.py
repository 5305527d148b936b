"""MnistRandomFFT: random-FFT featurization + block least squares.

Counterpart of ``keystone_tpu/pipelines/images/mnist/random_fft.py``
(reference ``pipelines/images/mnist/MnistRandomFFT.scala:21-113``):
gather(num_ffts x [RandomSign -> PaddedFFT -> LinearRectifier]) ->
VectorCombiner -> BlockLeastSquares(block_size, 1, lambda) ->
MaxClassifier. Each branch maps a 784-pixel image to 512 features, so
the published 200 branches give 102,400 features. ``run`` takes the
data as LabeledData; the CSV-reading ``main`` waits for the port's CSV
loader.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from ....evaluation.multiclass import evaluate_multiclass
from ....loaders.csv_loader import LabeledData
from ....nodes.learning import BlockLeastSquaresEstimator
from ....nodes.stats import LinearRectifier, PaddedFFT, RandomSignNode
from ....nodes.util import (
    ClassLabelIndicatorsFromIntLabels,
    MaxClassifier,
    VectorCombiner,
)
from ....ops.device import DEFAULT_DEVICE, resolve_device
from ....workflow.pipeline import Pipeline

NUM_CLASSES = 10
MNIST_IMAGE_SIZE = 784


@dataclass
class MnistRandomFFTConfig:
    train_location: str = ""
    test_location: str = ""
    num_ffts: int = 200
    block_size: int = 2048
    lam: float = 0.0
    seed: int = 0


def build_featurizer(config: MnistRandomFFTConfig) -> Pipeline:
    """The gathered branches, each with its seeded sign vector, then the
    concatenation."""
    rng = np.random.RandomState(config.seed)
    branches = []
    for _ in range(config.num_ffts):
        signs = 2.0 * rng.randint(0, 2, size=MNIST_IMAGE_SIZE) - 1.0
        branches.append(
            RandomSignNode(signs) >> PaddedFFT() >> LinearRectifier(0.0))
    return Pipeline.gather(branches) >> VectorCombiner()


def build_pipeline(config: MnistRandomFFTConfig, train: LabeledData):
    """The unfitted predictor: (n, 784) images -> class indices, its
    solver fitted on ``train``."""
    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    return build_featurizer(config).and_then(
        BlockLeastSquaresEstimator(config.block_size, 1, config.lam),
        train.data, labels) >> MaxClassifier()


def run(config: MnistRandomFFTConfig, train: LabeledData = None,
        test: LabeledData = None, device=DEFAULT_DEVICE):
    """Fit on ``train`` and evaluate on both sets (LabeledData of (n, 784)
    float32 images in [0, 1] and int labels, moved to ``device``).
    Returns (fitted pipeline, train metrics, test metrics)."""
    if train is None or test is None:
        raise ValueError("MnistRandomFFT: pass train and test LabeledData; "
                         "the CSV loader is not ported yet")
    dev = resolve_device(device)
    start = time.time()
    train, test = train.to(dev), test.to(dev)
    pipeline = build_pipeline(config, train).fit()
    train_eval = evaluate_multiclass(pipeline(train.data), train.labels,
                                     NUM_CLASSES)
    print(f"TRAIN Error is {100 * train_eval.total_error:.2f}%")
    test_eval = evaluate_multiclass(pipeline(test.data), test.labels,
                                    NUM_CLASSES)
    print(f"TEST Error is {100 * test_eval.total_error:.2f}%")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return pipeline, train_eval, test_eval
