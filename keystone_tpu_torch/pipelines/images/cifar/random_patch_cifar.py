"""RandomPatchCifar: the north-star pipeline.

Counterpart of ``keystone_tpu/pipelines/images/cifar/random_patch_cifar.py``
(reference ``pipelines/images/cifar/RandomPatchCifar.scala:21-87``):
sample patches -> normalize + ZCA-whiten -> random whitened filters ->
fused convolve / rectify / pool (one CUDA kernel) -> StandardScaler ->
BlockLeastSquares(4096, 1, lambda) -> MaxClassifier.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ....evaluation.multiclass import evaluate_multiclass
from ....loaders.cifar_loader import cifar_loader
from ....loaders.csv_loader import LabeledData
from ....nodes.images.core import FusedConvRectifyPool
from ....nodes.learning import BlockLeastSquaresEstimator
from ....nodes.learning.zca import ZCAWhitener, ZCAWhitenerEstimator
from ....nodes.stats import StandardScaler
from ....nodes.stats.sampling import sample_indices, sample_rows
from ....nodes.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from ....ops.device import DEFAULT_DEVICE, resolve_device
from ....ops.image_ops import normalize_rows
from ....parallel.dataset import ArrayDataset
from ....workflow.common import Cacher

NUM_CLASSES = 10
IMAGE_SIZE = 32
NUM_CHANNELS = 3
WHITENER_SAMPLES = 100000


@dataclass
class RandomCifarConfig:
    train_location: str = ""
    test_location: str = ""
    num_filters: int = 100
    whitening_epsilon: float = 0.1
    patch_size: int = 6
    patch_steps: int = 1
    pool_size: int = 14
    pool_stride: int = 13
    alpha: float = 0.25
    lam: float = 0.0
    seed: int = 0


def sample_windows(images: ArrayDataset, size: int, stride: int,
                   num_samples: int, seed: int) -> torch.Tensor:
    """The rows ``Windower(stride, size) >> ImageVectorizer() >>
    Sampler(num_samples, seed)`` yields, as a (num_samples, size*size*C)
    tensor in (dy, dx, c) order.

    The composed nodes would first materialize every window of every
    image (at 20480 CIFAR images: 20480 x 729 x 108 floats, about 6.4
    GB) only to keep 100000 of them. The Sampler's indices depend on
    nothing but the window count and the seed, so they are drawn first
    (the same sorted ``RandomState(seed).choice`` draw) and only those
    windows are gathered. The result is identical."""
    imgs = images.data
    H, W = imgs.shape[1], imgs.shape[2]
    nH, nW = (H - size) // stride + 1, (W - size) // stride + 1
    idx = torch.as_tensor(
        sample_indices(images.n * nH * nW, num_samples, seed),
        device=imgs.device)
    img_i, win = idx // (nH * nW), idx % (nH * nW)
    ar = torch.arange(size, device=imgs.device)
    rows = (win // nW * stride)[:, None] + ar
    cols = (win % nW * stride)[:, None] + ar
    windows = imgs[img_i[:, None, None], rows[:, :, None], cols[:, None, :]]
    return windows.reshape(len(idx), -1)


def learn_filters(train_images: ArrayDataset, config: RandomCifarConfig):
    """The imperative filter-learning prefix
    (reference RandomPatchCifar.scala:41-57)."""
    sample = sample_windows(train_images, config.patch_size,
                            config.patch_steps, WHITENER_SAMPLES, config.seed)
    # normalize on the device; the ZCA fit stays there, the small filter
    # arithmetic below runs on the host as in the reference
    normalized = normalize_rows(sample.to(torch.float32), 10.0)
    whitener = ZCAWhitenerEstimator(config.whitening_epsilon).fit_single(
        normalized)
    base_filter_mat = normalized.cpu().numpy()
    sampled = sample_rows(base_filter_mat, config.num_filters, seed=config.seed)
    unnorm = (sampled - whitener.means) @ whitener.whitener
    norms = np.sqrt(np.sum(unnorm**2, axis=1))
    filters = (unnorm / (norms + 1e-10)[:, None]) @ whitener.whitener.T
    return filters.astype(np.float32), whitener


def build_pipeline(filters: np.ndarray, whitener: ZCAWhitener,
                   config: RandomCifarConfig, train_images, train_labels):
    featurizer = FusedConvRectifyPool(
        filters, IMAGE_SIZE, config.patch_size, NUM_CHANNELS,
        config.pool_stride, config.pool_size, config.alpha,
        whitener=whitener,
    ) >> Cacher("features")
    return (
        featurizer.and_then(StandardScaler(), train_images)
        .and_then(BlockLeastSquaresEstimator(4096, 1, config.lam),
                  train_images, train_labels)
        >> MaxClassifier()
    )


def run(config: RandomCifarConfig, train: Optional[LabeledData] = None,
        test: Optional[LabeledData] = None, device=DEFAULT_DEVICE):
    """Fit on ``train``, evaluate on both sets; returns the fitted
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

    filters, whitener = learn_filters(train.data, config)
    pipeline = build_pipeline(filters, whitener, config, train.data,
                              train_labels).fit()

    train_eval = evaluate_multiclass(pipeline(train.data), train.labels,
                                     NUM_CLASSES)
    test_eval = evaluate_multiclass(pipeline(test.data), test.labels,
                                    NUM_CLASSES)
    print(f"Training error is: {train_eval.total_error:.4f}")
    print(f"Test error is: {test_eval.total_error:.4f}")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return pipeline, train_eval, test_eval


def main(argv=None):
    p = argparse.ArgumentParser("RandomPatchCifar")
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
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(
        RandomCifarConfig(
            train_location=a.trainLocation,
            test_location=a.testLocation,
            num_filters=a.numFilters,
            whitening_epsilon=a.whiteningEpsilon,
            patch_size=a.patchSize,
            patch_steps=a.patchSteps,
            pool_size=a.poolSize,
            pool_stride=a.poolStride,
            alpha=a.alpha,
            lam=a.lam,
            seed=a.seed,
        ),
        device=a.device,
    )


if __name__ == "__main__":
    main()
