"""Stupid Backoff language model (reference ``nodes/nlp/StupidBackoff.scala``;
Brants et al., "Large language models in machine translation", 2007).

Counterpart of ``keystone_tpu/nodes/nlp/stupid_backoff.py``. Scores are
relative frequencies with a multiplicative ``alpha`` backoff:

    S(w_i | context) = freq(ngram) / freq(context)    if freq(ngram) > 0
                       alpha * S(w_i | shorter ctx)   otherwise
    S(w_i)           = freq(w_i) / N

The fit aggregates the (n-gram, count) pairs into a dict and scores
every seen n-gram in one host pass (the reference's
``InitialBigramPartitioner`` and per-partition scoring,
``StupidBackoff.scala:152-176``, are a shuffle of its cluster). Scores
are Python floats, computed in the JAX package's order, so both give
the same values.
"""
from __future__ import annotations

from typing import Dict, Tuple

from ...parallel.dataset import Dataset
from ...workflow.estimator import Estimator
from ...workflow.operators import data_token
from ...workflow.transformer import HostTransformer
from .indexers import NGramIndexerImpl
from .ngrams import NGram


class StupidBackoffModel(HostTransformer):
    """Query with ``score(ngram)`` (reference ``StupidBackoff.scala:98-128``)."""

    def __init__(
        self,
        scores: Dict[NGram, float],
        ngram_counts: Dict[NGram, int],
        unigram_counts: Dict[object, int],
        num_tokens: int,
        alpha: float = 0.4,
    ):
        self.scores = scores
        self.ngram_counts = ngram_counts
        self.unigram_counts = unigram_counts
        self.num_tokens = int(num_tokens)
        self.alpha = float(alpha)
        self._indexer = NGramIndexerImpl()

    def eq_key(self):
        # a token of this model, where the JAX package keys it by id() of
        # its scores (ROADMAP C1)
        return (StupidBackoffModel, data_token(self))

    def score(self, ngram: NGram) -> float:
        ngram = NGram(ngram)
        cached = self.scores.get(ngram)
        if cached is not None:
            return cached
        return self._score(1.0, ngram, self.ngram_counts.get(ngram, 0))

    def _score(self, accum: float, ngram: NGram, freq: int) -> float:
        """Recursive local scoring (reference ``StupidBackoff.scala:62-92``)."""
        idx = self._indexer
        order = idx.ngram_order(ngram)
        if order == 1:
            return accum * self.unigram_counts.get(ngram[0], 0) / self.num_tokens
        if freq != 0:
            context = idx.remove_current_word(ngram)
            if order != 2:
                context_freq = self.ngram_counts.get(context, 0)
            else:
                context_freq = self.unigram_counts.get(context[0], 0)
            if context_freq > 0:
                return accum * freq / context_freq
            # an unseen context (counts fitted without its order) backs
            # off instead of dividing by zero
        backed = idx.remove_farthest_word(ngram)
        if order != 2:
            freq2 = self.ngram_counts.get(backed, 0)
        else:
            freq2 = self.unigram_counts.get(backed[0], 0)
        return self._score(self.alpha * accum, backed, freq2)

    def apply(self, pair: Tuple[NGram, int]) -> Tuple[NGram, float]:
        ngram, _ = pair
        return NGram(ngram), self.score(NGram(ngram))

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_keystone_token", None)
        return state


class StupidBackoffEstimator(Estimator):
    """Fit from a dataset of (n-gram, count) pairs (reference
    ``StupidBackoff.scala:143-182``)."""

    def __init__(self, unigram_counts: Dict[object, int], alpha: float = 0.4):
        self.unigram_counts = dict(unigram_counts)
        self.alpha = float(alpha)

    def eq_key(self):
        return (StupidBackoffEstimator, data_token(self), self.alpha)

    def _fit(self, ds: Dataset) -> StupidBackoffModel:
        counts: Dict[NGram, int] = {}
        for ngram, c in ds.collect():
            key = NGram(ngram)
            counts[key] = counts.get(key, 0) + int(c)
        num_tokens = sum(self.unigram_counts.values())
        model = StupidBackoffModel(
            {}, counts, self.unigram_counts, num_tokens, self.alpha)
        scores: Dict[NGram, float] = {}
        for ngram, freq in counts.items():
            s = model._score(1.0, ngram, freq)
            if not 0.0 <= s <= 1.0:
                raise ValueError(f"score {s} not in [0, 1] for {ngram}")
            scores[ngram] = s
        model.scores = scores
        return model
