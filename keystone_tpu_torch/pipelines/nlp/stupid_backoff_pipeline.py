"""StupidBackoffPipeline: an n-gram language model from a text corpus.

Counterpart of ``keystone_tpu/pipelines/nlp/stupid_backoff_pipeline.py``
(reference ``pipelines/nlp/StupidBackoffPipeline.scala:10-58``):
tokenize the lines, frequency-encode the vocabulary, count the n-grams
of orders 2..n, fit the Stupid Backoff model and report the corpus's
statistics. Every stage is host work on strings, ids and counts, as in
the reference (a Spark shuffle job); ``device`` is checked as every
entry point checks it, and no stage runs there. ``main`` is ``python -m
keystone_tpu_torch nlp.stupid_backoff``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass
from typing import Optional

from ...nodes.nlp import (
    NGramsCounts,
    NGramsFeaturizer,
    NO_ADD_MODE,
    StupidBackoffEstimator,
    Tokenizer,
    WordFrequencyEncoder,
)
from ...ops.device import DEFAULT_DEVICE, resolve_device
from ...parallel.dataset import Dataset, HostDataset


@dataclass
class StupidBackoffConfig:
    train_data: str = ""
    n: int = 3


def run(config: StupidBackoffConfig, text: Optional[Dataset] = None,
        device=DEFAULT_DEVICE):
    """Fit on ``text`` (a host dataset of lines, read from the config's
    file when not given). Returns the fitted StupidBackoffModel."""
    resolve_device(device)
    start = time.time()
    if text is None:
        with open(config.train_data, errors="replace") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        text = HostDataset(lines)

    tokens = Tokenizer().apply_dataset(text)
    frequency_encode = WordFrequencyEncoder().fit(tokens)
    unigram_counts = frequency_encode.unigram_counts

    make_ngrams = frequency_encode >> NGramsFeaturizer(
        list(range(2, config.n + 1)))
    ngram_counts = NGramsCounts(NO_ADD_MODE).apply_dataset(
        make_ngrams(tokens).get())

    language_model = StupidBackoffEstimator(unigram_counts).fit(ngram_counts)

    print(f"number of tokens: {language_model.num_tokens}")
    print(f"size of vocabulary: {len(language_model.unigram_counts)}")
    print(f"number of ngrams: {len(language_model.scores)}")
    print(f"Pipeline took {time.time() - start:.1f} s")
    return language_model


def main(argv=None):
    p = argparse.ArgumentParser("StupidBackoffPipeline")
    p.add_argument("--trainData", required=True)
    p.add_argument("--n", type=int, default=3)
    p.add_argument("--device", default=DEFAULT_DEVICE)
    a = p.parse_args(argv)
    run(StupidBackoffConfig(a.trainData, a.n), device=a.device)


if __name__ == "__main__":
    main()
