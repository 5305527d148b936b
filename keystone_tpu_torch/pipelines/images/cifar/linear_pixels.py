"""LinearPixels: grayscale pixels + linear model baseline.

Counterpart of ``keystone_tpu/pipelines/images/cifar/linear_pixels.py``
(reference ``pipelines/images/cifar/LinearPixels.scala:35-38``):
GrayScaler -> ImageVectorizer -> LinearMapEstimator -> MaxClassifier.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

from ....evaluation.multiclass import evaluate_multiclass
from ....loaders.cifar_loader import cifar_loader
from ....nodes.images.core import GrayScaler, ImageVectorizer
from ....nodes.learning import LinearMapEstimator
from ....nodes.util import ClassLabelIndicatorsFromIntLabels, MaxClassifier
from ....ops.device import DEFAULT_DEVICE, resolve_device

NUM_CLASSES = 10


@dataclass
class LinearPixelsConfig:
    train_location: str = ""
    test_location: str = ""
    lam: float = 0.0


def run(config: LinearPixelsConfig, train=None, test=None,
        device=DEFAULT_DEVICE):
    dev = resolve_device(device)
    train = (cifar_loader(config.train_location, device=dev) if train is None
             else train.to(dev))
    test = (cifar_loader(config.test_location, device=dev) if test is None
            else test.to(dev))

    labels = ClassLabelIndicatorsFromIntLabels(NUM_CLASSES)(train.labels)
    featurizer = GrayScaler() >> ImageVectorizer()
    pipeline = (
        featurizer.and_then(LinearMapEstimator(config.lam), train.data, labels)
        >> MaxClassifier()
    ).fit()
    train_eval = evaluate_multiclass(pipeline(train.data), train.labels,
                                     NUM_CLASSES)
    test_eval = evaluate_multiclass(pipeline(test.data), test.labels,
                                    NUM_CLASSES)
    print(f"Training error is: {train_eval.total_error:.4f}")
    print(f"Test error is: {test_eval.total_error:.4f}")
    return pipeline, train_eval, test_eval


def main(argv=None):
    p = argparse.ArgumentParser("LinearPixels")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--lambda", dest="lam", type=float, default=0.0)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(LinearPixelsConfig(a.trainLocation, a.testLocation, a.lam),
        device=a.device)


if __name__ == "__main__":
    main()
