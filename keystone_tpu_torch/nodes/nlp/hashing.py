"""Feature hashing (reference ``nodes/nlp/HashingTF.scala`` and
``nodes/nlp/NGramsHashingTF.scala``).

Counterpart of ``keystone_tpu/nodes/nlp/hashing.py``. Python's ``hash``
is salted per process, so feature indices would change from run to run;
these are the reference's own hashes instead: the JVM ``String.hashCode``
for terms and the MurmurHash3 ordered ("Seq") hash for n-gram tuples,
signed 32-bit values computed on Python ints. So ``NGramsHashingTF``
gives exactly ``NGramsFeaturizer`` followed by ``HashingTF``, as the
reference promises (``NGramsHashingTF.scala:14-17``). Its hot loop runs
in the native host library (``keystone_tpu_torch.native``) when that is
built, which gives the same indices.

The output is a host :class:`~keystone_tpu_torch.nodes.util.sparse.SparseVector`.
"""
from __future__ import annotations

from typing import Any, List, Sequence

import numpy as np

from ...workflow.transformer import HostTransformer
from ..util.sparse import SparseVector
from .ngrams import _check_orders

_MASK = 0xFFFFFFFF


def _to_signed(x: int) -> int:
    x &= _MASK
    return x - (1 << 32) if x >= (1 << 31) else x


def java_string_hash(s: str) -> int:
    """JVM ``String.hashCode``: h = 31*h + c over UTF-16 code units."""
    h = 0
    data = s.encode("utf-16-be")
    for i in range(0, len(data), 2):
        unit = (data[i] << 8) | data[i + 1]
        h = (31 * h + unit) & _MASK
    return _to_signed(h)


def _rotl(x: int, r: int) -> int:
    x &= _MASK
    return ((x << r) | (x >> (32 - r))) & _MASK


def murmur_mix(h: int, k: int) -> int:
    """MurmurHash3 mix step (reference ``NGramsHashingTF.scala:41-46``)."""
    h = murmur_mix_last(h, k)
    h = _rotl(h, 13)
    return (h * 5 + 0xE6546B64) & _MASK


def murmur_mix_last(h: int, k: int) -> int:
    k = (k * 0xCC9E2D51) & _MASK
    k = _rotl(k, 15)
    k = (k * 0x1B873593) & _MASK
    return (h ^ k) & _MASK


def murmur_finalize(h: int, length: int) -> int:
    h = (h ^ length) & _MASK
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return _to_signed(h)


SEQ_SEED = java_string_hash("Seq")


def scala_hash(term: Any) -> int:
    """Scala's ``.##`` for the term types pipelines hash: strings
    (``String.hashCode``), ints (identity) and n-gram sequences (the
    MurmurHash3 ordered hash with the "Seq" seed)."""
    if isinstance(term, str):
        return java_string_hash(term)
    if isinstance(term, (int, np.integer)):
        return _to_signed(int(term))
    if isinstance(term, (tuple, list)):
        h = SEQ_SEED & _MASK
        for w in term:
            h = murmur_mix(h, scala_hash(w) & _MASK)
        return murmur_finalize(h, len(term))
    raise TypeError(f"unhashable term type for feature hashing: {type(term)}")


def non_negative_mod(x: int, mod: int) -> int:
    """x mod ``mod`` in [0, mod) (Python's ``%`` already is, for a
    positive ``mod``)."""
    return x % mod


def ngram_feature_indices(tokens: Sequence[Any], lo: int, hi: int,
                          num_features: int) -> List[int]:
    """The hashed feature index of every n-gram of orders ``lo`` to
    ``hi``, start position by start position (reference
    ``NGramsHashingTF.scala:26-118``): one running hash a start, mixed
    one term at a time and finalized at every order, so no n-gram is
    materialized. The pure-Python form of the native ``ngram_hash_doc``."""
    hashes = [scala_hash(t) & _MASK for t in tokens]
    n = len(tokens)
    out: List[int] = []
    for i in range(n - lo + 1):
        h = SEQ_SEED & _MASK
        for j in range(i, i + lo):
            h = murmur_mix(h, hashes[j])
        out.append(non_negative_mod(murmur_finalize(h, lo), num_features))
        for order in range(lo + 1, hi + 1):
            if i + order > n:
                break
            h = murmur_mix(h, hashes[i + order - 1])
            out.append(non_negative_mod(murmur_finalize(h, order),
                                        num_features))
    return out


class HashingTF(HostTransformer):
    """Term sequence -> sparse term-frequency vector by the hashing trick
    (reference ``HashingTF.scala:15-30``)."""

    def __init__(self, num_features: int):
        self.num_features = int(num_features)

    def eq_key(self):
        return (HashingTF, self.num_features)

    def apply(self, document: Sequence[Any]) -> SparseVector:
        tf: dict = {}
        for term in document:
            i = non_negative_mod(scala_hash(term), self.num_features)
            tf[i] = tf.get(i, 0.0) + 1.0
        return SparseVector.from_dict(tf, self.num_features)


class NGramsHashingTF(HostTransformer):
    """``NGramsFeaturizer`` and ``HashingTF`` in one rolling hash
    (reference ``NGramsHashingTF.scala:26-118``), through the native
    host library's ``ngram_hash_doc`` when it is built."""

    def __init__(self, orders: Sequence[int], num_features: int):
        _check_orders(orders)
        self.orders = tuple(orders)
        self.num_features = int(num_features)

    def eq_key(self):
        return (NGramsHashingTF, self.orders, self.num_features)

    def apply(self, line: Sequence[str]) -> SparseVector:
        from ...native import ngram_hash_features

        feats = ngram_hash_features(list(line), self.orders,
                                    self.num_features)
        idx, counts = np.unique(feats, return_counts=True)
        return SparseVector(idx, counts.astype(np.float32),
                            self.num_features)
