"""AmazonReviewsPipeline: n-gram term presence and logistic regression.

Counterpart of ``keystone_tpu/pipelines/text/amazon_reviews.py``
(reference ``pipelines/text/AmazonReviewsPipeline.scala:17-46``): the
Newsgroups featurization (bigrams, binary term frequency, the 100,000
most common features), then binary logistic regression by L-BFGS on
``device`` from the SparseVectors, evaluated with the binary
contingency-table metrics. ``run`` reads the JSON-lines reviews its
config names (``loaders.amazon``) unless the caller passes LabeledData;
``main`` is ``python -m keystone_tpu_torch text.amazon_reviews``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ...evaluation.binary import evaluate_binary
from ...loaders.amazon import amazon_reviews_loader
from ...loaders.csv_loader import LabeledData
from ...nodes.learning import LogisticRegressionEstimator
from ...nodes.nlp import LowerCase, NGramsFeaturizer, Tokenizer, Trim
from ...nodes.stats import TermFrequency
from ...nodes.util import CommonSparseFeatures
from ...ops.device import DEFAULT_DEVICE, resolve_device


@dataclass
class AmazonReviewsConfig:
    train_location: str = ""
    test_location: str = ""
    threshold: float = 3.5
    n_grams: int = 2
    common_features: int = 100000
    num_iters: int = 20


def run(config: AmazonReviewsConfig, train: Optional[LabeledData] = None,
        test: Optional[LabeledData] = None, device=DEFAULT_DEVICE):
    """Fit on ``train`` and evaluate on ``test`` (host texts and 0/1
    labels, read from the config's files when not given), the model on
    ``device``. Returns (fitted pipeline, test metrics)."""
    dev = resolve_device(device)
    start = time.time()
    train = (amazon_reviews_loader(config.train_location, config.threshold,
                                   device=dev)
             if train is None else train.to(dev))
    test = (amazon_reviews_loader(config.test_location, config.threshold,
                                  device=dev)
            if test is None else test.to(dev))

    predictor = (
        Trim() >> LowerCase() >> Tokenizer()
        >> NGramsFeaturizer(list(range(1, config.n_grams + 1)))
        >> TermFrequency(lambda x: 1)
    ).and_then(CommonSparseFeatures(config.common_features), train.data)
    predictor = predictor.and_then(
        LogisticRegressionEstimator(num_classes=2,
                                    num_iters=config.num_iters),
        train.data, train.labels).fit()

    test_results = np.asarray(predictor(test.data).numpy()).ravel()
    test_labels = np.asarray(test.labels.numpy()).ravel()
    eval_ = evaluate_binary(test_results > 0, test_labels > 0)
    print(eval_.summary())
    print(f"TEST Error is {100 * eval_.error:.2f}%")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return predictor, eval_


def main(argv=None):
    p = argparse.ArgumentParser("AmazonReviewsPipeline")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--threshold", type=float, default=3.5)
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100000)
    p.add_argument("--numIters", type=int, default=20)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(AmazonReviewsConfig(a.trainLocation, a.testLocation, a.threshold,
                            a.nGrams, a.commonFeatures, a.numIters),
        device=a.device)


if __name__ == "__main__":
    main()
