"""NewsgroupsPipeline: n-gram term presence and naive Bayes.

Counterpart of ``keystone_tpu/pipelines/text/newsgroups.py`` (reference
``pipelines/text/NewsgroupsPipeline.scala:15-77``): Trim -> LowerCase ->
Tokenizer -> NGramsFeaturizer(1..n) -> TermFrequency(binary) ->
CommonSparseFeatures(100k) -> NaiveBayes -> MaxClassifier. With
``lemmatize`` the tokenize and n-gram stages are
:class:`CoreNLPFeatureExtractor` (lemmatized, entity-typed n-grams, the
reference's CoreNLP variant). The string stages run on the host; naive
Bayes fits and scores on ``device`` from the SparseVectors, never a
densified (n, 100k) matrix. ``run`` reads the split directories its
config names (``loaders.newsgroups``) unless the caller passes
LabeledData; ``main`` is ``python -m keystone_tpu_torch text.newsgroups``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

from ...evaluation.multiclass import evaluate_multiclass
from ...loaders.csv_loader import LabeledData
from ...loaders.newsgroups import CLASSES, newsgroups_loader
from ...nodes.learning import NaiveBayesEstimator
from ...nodes.nlp import (
    CoreNLPFeatureExtractor,
    LowerCase,
    NGramsFeaturizer,
    Tokenizer,
    Trim,
)
from ...nodes.stats import TermFrequency
from ...nodes.util import CommonSparseFeatures, MaxClassifier
from ...ops.device import DEFAULT_DEVICE, resolve_device


@dataclass
class NewsgroupsConfig:
    train_location: str = ""
    test_location: str = ""
    n_grams: int = 2
    common_features: int = 100000
    lemmatize: bool = False


def featurizer(config: NewsgroupsConfig):
    """The host stages: text -> (n-gram, 1.0) presence pairs."""
    orders = list(range(1, config.n_grams + 1))
    if config.lemmatize:
        tokens = Trim() >> CoreNLPFeatureExtractor(orders)
    else:
        tokens = (Trim() >> LowerCase() >> Tokenizer()
                  >> NGramsFeaturizer(orders))
    return tokens >> TermFrequency(lambda x: 1)


def run(config: NewsgroupsConfig, train: Optional[LabeledData] = None,
        test: Optional[LabeledData] = None,
        num_classes: Optional[int] = None, device=DEFAULT_DEVICE):
    """Fit on ``train`` and evaluate on ``test`` (host texts and int
    labels, read from the config's directories when not given), the
    model on ``device``. Returns (fitted pipeline, test metrics)."""
    dev = resolve_device(device)
    start = time.time()
    train = (newsgroups_loader(config.train_location, device=dev)
             if train is None else train.to(dev))
    test = (newsgroups_loader(config.test_location, device=dev)
            if test is None else test.to(dev))
    num_classes = num_classes or len(CLASSES)

    predictor = featurizer(config).and_then(
        CommonSparseFeatures(config.common_features), train.data)
    predictor = (predictor.and_then(NaiveBayesEstimator(num_classes),
                                    train.data, train.labels)
                 >> MaxClassifier()).fit()

    test_results = predictor(test.data)
    eval_ = evaluate_multiclass(test_results, test.labels, num_classes)
    print(eval_.summary())
    print(f"TEST Error is {100 * eval_.total_error:.2f}%")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return predictor, eval_


def main(argv=None):
    p = argparse.ArgumentParser("NewsgroupsPipeline")
    p.add_argument("--trainLocation", required=True)
    p.add_argument("--testLocation", required=True)
    p.add_argument("--nGrams", type=int, default=2)
    p.add_argument("--commonFeatures", type=int, default=100000)
    p.add_argument("--lemmatize", action="store_true")
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(NewsgroupsConfig(a.trainLocation, a.testLocation, a.nGrams,
                         a.commonFeatures, a.lemmatize), device=a.device)


if __name__ == "__main__":
    main()
