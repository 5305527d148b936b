"""RandomPatchCifarAugmented.

Counterpart of
``keystone_tpu/pipelines/images/cifar/random_patch_cifar_augmented.py``
(reference ``pipelines/images/cifar/RandomPatchCifarAugmented.scala:25-154``):
RandomPatchCifar with train-time augmentation (random 24 x 24 crops and
random horizontal flips, labels repeated to match) and test-time
augmentation (center and corner crops with their flips, predictions
averaged per source image by ``evaluate_augmented``). The featurizer is
the unfused ``Convolver >> SymmetricRectifier >> Pooler >>
ImageVectorizer`` chain (the optimizer fuses it into one node); it runs
no kernel of the port.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ....evaluation.augmented import AVERAGE_POLICY, evaluate_augmented
from ....loaders.cifar_loader import cifar_loader
from ....loaders.csv_loader import LabeledData
from ....nodes.images.core import (
    CenterCornerPatcher,
    Convolver,
    ImageVectorizer,
    Pooler,
    RandomFlipper,
    RandomPatcher,
    SymmetricRectifier,
)
from ....nodes.learning import BlockLeastSquaresEstimator
from ....nodes.stats import StandardScaler
from ....nodes.util import ClassLabelIndicatorsFromIntLabels, LabelAugmenter
from ....ops.device import DEFAULT_DEVICE, resolve_device
from ....parallel.dataset import ArrayDataset
from ....workflow.common import Cacher
from ....workflow.pipeline import Pipeline
from .random_patch_cifar import RandomCifarConfig, learn_filters

NUM_CLASSES = 10
NUM_CHANNELS = 3
AUGMENT_IMG_SIZE = 24
FLIP_CHANCE = 0.5


@dataclass
class AugmentedConfig(RandomCifarConfig):
    num_random_patches_augment: int = 10
    pool_size: int = 14
    pool_stride: int = 13


def augment_train(config: AugmentedConfig, train: LabeledData):
    """Train-time augmentation (reference :65-77): ``(images, labels)``,
    each training image as ``num_random_patches_augment`` random 24 x 24
    crops, each crop flipped with probability 0.5, and the +-1 label
    indicators repeated to match (a lazy pipeline result)."""
    augment = RandomPatcher(config.num_random_patches_augment,
                            AUGMENT_IMG_SIZE, AUGMENT_IMG_SIZE,
                            seed=config.seed)
    images = RandomFlipper(FLIP_CHANCE, seed=config.seed).apply_dataset(
        augment.apply_dataset(train.data))
    labels = (ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)
              >> LabelAugmenter(config.num_random_patches_augment)
              )(train.labels)
    return images, labels


def augment_test(images: ArrayDataset):
    """Test-time augmentation (reference :105-125): ``(patches, ids)``,
    the 4 corner and the center 24 x 24 crops of every image with their
    flips, and the source image's index for each."""
    patcher = CenterCornerPatcher(AUGMENT_IMG_SIZE, AUGMENT_IMG_SIZE,
                                  horizontal_flips=True)
    ids = np.repeat(np.arange(len(images)), patcher.patches_per_image)
    return patcher.apply_dataset(images), ids


def build_pipeline(config: AugmentedConfig, filters: np.ndarray, whitener,
                   train_images, train_labels) -> Pipeline:
    """The unfitted predictor on 24 x 24 patches: convolve, rectify,
    pool, vectorize, scale, BlockLeastSquares(4096, 1, lam); class
    scores out."""
    featurizer = (
        Convolver(filters, AUGMENT_IMG_SIZE, AUGMENT_IMG_SIZE, NUM_CHANNELS,
                  whitener=whitener, normalize_patches=True)
        >> SymmetricRectifier(alpha=config.alpha)
        >> Pooler(config.pool_stride, config.pool_size, "identity", "sum")
        >> ImageVectorizer()
        >> Cacher("features")
    )
    return featurizer.and_then(
        StandardScaler(), train_images
    ).and_then(
        BlockLeastSquaresEstimator(4096, 1, config.lam), train_images,
        train_labels,
    ) >> Cacher()


def run(config: AugmentedConfig, train: Optional[LabeledData] = None,
        test: Optional[LabeledData] = None, device=DEFAULT_DEVICE):
    """Learn the filters, fit on the augmented training set and evaluate
    the test set's patches averaged per image, all on ``device`` (the
    data read from the config's files when not given). Returns the
    fitted pipeline and the test evaluation."""
    dev = resolve_device(device)
    start = time.time()
    train = (cifar_loader(config.train_location, device=dev) if train is None
             else train.to(dev))
    test = (cifar_loader(config.test_location, device=dev) if test is None
            else test.to(dev))

    filters, whitener = learn_filters(train.data, config)
    images, labels = augment_train(config, train)
    pipeline = build_pipeline(config, filters, whitener, images,
                              labels).fit()

    patches, ids = augment_test(test.data)
    n_aug = len(patches) // max(len(test.data), 1)
    test_labels = np.repeat(test.labels.numpy().ravel(), n_aug)
    test_eval = evaluate_augmented(ids, pipeline(patches).get(), test_labels,
                                   NUM_CLASSES, AVERAGE_POLICY)
    print(f"Test error is: {test_eval.total_error:.4f}")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return pipeline, test_eval


def main(argv=None):
    p = argparse.ArgumentParser("RandomPatchCifarAugmented")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--numFilters", type=int, default=100)
    p.add_argument("--whiteningEpsilon", type=float, default=0.1)
    p.add_argument("--patchSize", type=int, default=6)
    p.add_argument("--patchSteps", type=int, default=1)
    p.add_argument("--poolSize", type=int, default=14)
    p.add_argument("--poolStride", type=int, default=13)
    p.add_argument("--alpha", type=float, default=0.25)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--numRandomPatchesAugment", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(AugmentedConfig(
        train_location=a.trainLocation, test_location=a.testLocation,
        num_filters=a.numFilters, whitening_epsilon=a.whiteningEpsilon,
        patch_size=a.patchSize, patch_steps=a.patchSteps,
        pool_size=a.poolSize, pool_stride=a.poolStride, alpha=a.alpha,
        lam=a.lam, num_random_patches_augment=a.numRandomPatchesAugment,
        seed=a.seed), device=a.device)


if __name__ == "__main__":
    main()
