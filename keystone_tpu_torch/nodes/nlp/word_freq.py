"""Word frequency encoding (reference ``nodes/nlp/WordFrequencyEncoder.scala``).

Counterpart of ``keystone_tpu/nodes/nlp/word_freq.py``. Each token maps
to its rank in count order (the most frequent word is 0, ties by first
appearance); an out-of-vocabulary word maps to -1. The fit counts
unigrams in one host pass (the reference counts them with
``NGramsFeaturizer(1..1)`` and ``NGramsCounts`` and collects them).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from ...parallel.dataset import Dataset
from ...workflow.estimator import Estimator
from ...workflow.operators import data_token
from ...workflow.transformer import HostTransformer

OOV_INDEX = -1


class WordFrequencyTransformer(HostTransformer):
    """Token sequence -> frequency-rank sequence (reference
    ``WordFrequencyEncoder.scala:42-62``). Keyed for common-subexpression
    elimination by a token of this object (``data_token``), where the
    JAX package keys it by ``id()`` of its dict (ROADMAP C1)."""

    def __init__(self, word_index: Dict[str, int],
                 unigram_counts: Dict[int, int]):
        self.word_index = dict(word_index)
        self.unigram_counts = dict(unigram_counts)

    def eq_key(self):
        return (WordFrequencyTransformer, data_token(self))

    def apply(self, words: Sequence[str]) -> List[int]:
        index = self.word_index
        return [index.get(w, OOV_INDEX) for w in words]

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_keystone_token", None)
        return state


class WordFrequencyEncoder(Estimator):
    """Fit a WordFrequencyTransformer by counting unigrams (reference
    ``WordFrequencyEncoder.scala:12-30``): rank order is count
    descending, ties broken by first appearance."""

    def _fit(self, ds: Dataset) -> WordFrequencyTransformer:
        counts: Dict[str, int] = {}
        first: Dict[str, int] = {}
        i = 0
        for tokens in ds.collect():
            for w in tokens:
                counts[w] = counts.get(w, 0) + 1
                if w not in first:
                    first[w] = i
                i += 1
        ranked = sorted(counts, key=lambda w: (-counts[w], first[w]))
        word_index = {w: r for r, w in enumerate(ranked)}
        unigrams = {word_index[w]: c for w, c in counts.items()}
        return WordFrequencyTransformer(word_index, unigrams)
