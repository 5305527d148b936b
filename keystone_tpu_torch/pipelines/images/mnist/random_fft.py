"""MnistRandomFFT: random-FFT featurization + block least squares.

Counterpart of ``keystone_tpu/pipelines/images/mnist/random_fft.py``
(reference ``pipelines/images/mnist/MnistRandomFFT.scala:21-113``):
gather(num_ffts x [RandomSign -> PaddedFFT -> LinearRectifier]) ->
VectorCombiner -> BlockLeastSquares(block_size, 1, lambda) ->
MaxClassifier. Each branch maps a 784-pixel image to 512 features, so
the published 200 branches give 102,400 features. ``run`` reads the
train and test CSVs its config names (rows of a 1-based label and 784
pixels, ``loaders.csv_loader.csv_labeled_loader``) unless the caller
passes LabeledData; ``main`` is ``python -m keystone_tpu_torch
mnist.random_fft``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np

from ....evaluation.multiclass import evaluate_multiclass
from ....loaders.csv_loader import LabeledData, csv_labeled_loader
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
    float32 images and int labels, read from the config's CSV files when
    not given), on ``device``. Returns (fitted pipeline, train metrics,
    test metrics)."""
    dev = resolve_device(device)
    start = time.time()
    train = (csv_labeled_loader(config.train_location, label_offset=1,
                                device=dev) if train is None
             else train.to(dev))
    test = (csv_labeled_loader(config.test_location, label_offset=1,
                               device=dev) if test is None
            else test.to(dev))
    pipeline = build_pipeline(config, train).fit()
    train_eval = evaluate_multiclass(pipeline(train.data), train.labels,
                                     NUM_CLASSES)
    print(f"TRAIN Error is {100 * train_eval.total_error:.2f}%")
    test_eval = evaluate_multiclass(pipeline(test.data), test.labels,
                                    NUM_CLASSES)
    print(f"TEST Error is {100 * test_eval.total_error:.2f}%")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return pipeline, train_eval, test_eval


def main(argv=None):
    p = argparse.ArgumentParser("MnistRandomFFT")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--numFFTs", type=int, default=200)
    p.add_argument("--blockSize", type=int, default=2048)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(MnistRandomFFTConfig(
        train_location=a.trainLocation, test_location=a.testLocation,
        num_ffts=a.numFFTs, block_size=a.blockSize, lam=a.lam, seed=a.seed),
        device=a.device)


if __name__ == "__main__":
    main()
