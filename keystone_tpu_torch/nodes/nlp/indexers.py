"""N-gram indexers (reference ``nodes/nlp/indexers.scala``).

Counterpart of ``keystone_tpu/nodes/nlp/indexers.py``: ``pack`` /
``unpack`` utilities for language models needing backoff
contexts. ``NaiveBitPackIndexer`` packs up to trigrams of word ids
(< 2**20) into one int64 — the layout the reference documents at
``indexers.scala:47-58`` — making n-gram keys fixed-width integers that
can live in tensors.
"""
from __future__ import annotations

from typing import Sequence

from .ngrams import NGram

_WORD_BITS = 20
_WORD_MASK = (1 << _WORD_BITS) - 1


class NGramIndexer:
    min_ngram_order = 1
    max_ngram_order = 5

    def pack(self, ngram: Sequence) -> NGram:
        raise NotImplementedError


class NGramIndexerImpl(NGramIndexer):
    """Tuple-backed indexer (reference ``indexers.scala:120-135``)."""

    def pack(self, ngram: Sequence) -> NGram:
        return NGram(ngram)

    def unpack(self, ngram: NGram, pos: int):
        return ngram[pos]

    def remove_farthest_word(self, ngram: NGram) -> NGram:
        return NGram(ngram[1:])

    def remove_current_word(self, ngram: NGram) -> NGram:
        return NGram(ngram[:-1])

    def ngram_order(self, ngram: NGram) -> int:
        return len(ngram)


class NaiveBitPackIndexer(NGramIndexer):
    """Bit-packs up to 3 word ids into an int64: 4 control bits (order-1),
    then words left-aligned farthest-first (reference
    ``indexers.scala:60-118``)."""

    min_ngram_order = 1
    max_ngram_order = 3

    def pack(self, ngram: Sequence[int]) -> int:
        for w in ngram:
            assert 0 <= w < (1 << _WORD_BITS), f"word id {w} >= 2**20"
        n = len(ngram)
        if n == 1:
            return ngram[0] << 40
        if n == 2:
            return (ngram[0] << 40) | (ngram[1] << 20) | (1 << 60)
        if n == 3:
            return (ngram[0] << 40) | (ngram[1] << 20) | ngram[2] | (1 << 61)
        raise ValueError("ngram order must be in {1, 2, 3}")

    def unpack(self, packed: int, pos: int) -> int:
        if pos == 0:
            return (packed >> 40) & _WORD_MASK
        if pos == 1:
            return (packed >> 20) & _WORD_MASK
        if pos == 2:
            return packed & _WORD_MASK
        raise ValueError("pos must be in {0, 1, 2}")

    def ngram_order(self, packed: int) -> int:
        order = (packed >> 60) & 0xF
        assert 0 <= order <= 2, f"invalid control bits {order}"
        return order + 1

    def remove_farthest_word(self, packed: int) -> int:
        order = self.ngram_order(packed)
        words = [self.unpack(packed, i) for i in range(order)]
        if order == 2:
            return self.pack(words[1:])
        if order == 3:
            return self.pack(words[1:])
        raise ValueError(f"ngram order {order} not supported")

    def remove_current_word(self, packed: int) -> int:
        order = self.ngram_order(packed)
        words = [self.unpack(packed, i) for i in range(order)]
        if order in (2, 3):
            return self.pack(words[:-1])
        raise ValueError(f"ngram order {order} not supported")
