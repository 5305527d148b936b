"""RandomCifar: unwhitened Gaussian random filters.

Counterpart of ``keystone_tpu/pipelines/images/cifar/random_cifar.py``
(reference ``pipelines/images/cifar/RandomCifar.scala:21-110``):
Convolver (random filters, normalized patches, no whitening) ->
SymmetricRectifier -> Pooler(sum) -> ImageVectorizer -> StandardScaler
-> exact least squares (LinearMapEstimator) -> MaxClassifier. The
featurizer is a plain map chain of per-batch nodes, which the optimizer
fuses into one node; it runs no kernel of the port.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ....evaluation.multiclass import evaluate_multiclass
from ....loaders.cifar_loader import cifar_loader
from ....loaders.csv_loader import LabeledData
from ....nodes.images.core import (
    Convolver,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
)
from ....nodes.learning import LinearMapEstimator
from ....nodes.stats import StandardScaler
from ....nodes.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from ....ops.device import DEFAULT_DEVICE, resolve_device
from ....workflow.common import Cacher
from ....workflow.pipeline import Pipeline

NUM_CLASSES = 10
IMAGE_SIZE = 32
NUM_CHANNELS = 3


@dataclass
class RandomCifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    patch_size: int = 6
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: Optional[float] = None
    seed: int = 0


def random_filters(config: RandomCifarConfig) -> np.ndarray:
    """(num_filters, patch_size^2 * 3) float32 Gaussian filters, drawn as
    the JAX package draws them (``RandomState(seed).randn``)."""
    rng = np.random.RandomState(config.seed)
    return rng.randn(
        config.num_filters,
        config.patch_size * config.patch_size * NUM_CHANNELS,
    ).astype(np.float32)


def build_featurizer(config: RandomCifarConfig,
                     filters: np.ndarray) -> Pipeline:
    """Convolve, rectify, pool and vectorize, then a Cacher."""
    return (
        Convolver(filters, IMAGE_SIZE, IMAGE_SIZE, NUM_CHANNELS,
                  whitener=None, normalize_patches=True)
        >> SymmetricRectifier(alpha=config.alpha)
        >> Pooler(config.pool_stride, config.pool_size, "identity", "sum")
        >> ImageVectorizer()
        >> Cacher()
    )


def build_pipeline(config: RandomCifarConfig, train_images, train_labels,
                   filters: Optional[np.ndarray] = None) -> Pipeline:
    """The unfitted predictor, with the Cachers where the JAX app has
    them; ``train_labels`` are the +-1 indicator vectors."""
    if filters is None:
        filters = random_filters(config)
    return (
        build_featurizer(config, filters).and_then(StandardScaler(),
                                                   train_images)
        >> Cacher()
    ).and_then(
        LinearMapEstimator(config.lam), train_images, train_labels
    ) >> MaxClassifier()


def run(config: RandomCifarConfig, train: Optional[LabeledData] = None,
        test: Optional[LabeledData] = None, device=DEFAULT_DEVICE):
    """Fit on ``train``, evaluate on both sets (read from the config's
    files when not given), all on ``device``. Returns the fitted
    pipeline and the two evaluations."""
    dev = resolve_device(device)
    start = time.time()
    train = (cifar_loader(config.train_location, device=dev) if train is None
             else train.to(dev))
    test = (cifar_loader(config.test_location, device=dev) if test is None
            else test.to(dev))

    train_labels = (
        ClassLabelIndicatorsFromIntLabels(NUM_CLASSES) >> Cacher("labels")
    )(train.labels)
    pipeline = build_pipeline(config, train.data, train_labels).fit()

    train_eval = evaluate_multiclass(pipeline(train.data), train.labels,
                                     NUM_CLASSES)
    test_eval = evaluate_multiclass(pipeline(test.data), test.labels,
                                    NUM_CLASSES)
    print(f"Training error is: {train_eval.total_error:.4f}")
    print(f"Test error is: {test_eval.total_error:.4f}")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return pipeline, train_eval, test_eval


def main(argv=None):
    p = argparse.ArgumentParser("RandomCifar")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lambda", dest="lam", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(RandomCifarConfig(
        a.trainLocation, a.testLocation, a.numFilters, a.patchSize,
        a.poolSize, a.poolStride, a.alpha, a.lam, a.seed), device=a.device)


if __name__ == "__main__":
    main()
