"""N-gram featurization and counting (reference ``nodes/nlp/ngrams.scala``).

Counterpart of ``keystone_tpu/nodes/nlp/ngrams.py``. Host stages:
``NGram`` is a hashable tuple; counting is one host pass over a dict
(the reference's per-partition hash map and ``reduceByKey``,
``ngrams.scala:142-185``), and the sorted (n-gram, count) pairs flow on
as a host dataset.
"""
from __future__ import annotations

from typing import Any, List, Sequence

from ...parallel.dataset import Dataset, HostDataset
from ...workflow.transformer import HostTransformer


class NGram(tuple):
    """Hashable n-gram key (reference ``ngrams.scala:100-133``)."""

    @property
    def words(self):
        return tuple(self)

    def __repr__(self):
        return "[" + ",".join(str(w) for w in self) + "]"


def _check_orders(orders: Sequence[int]) -> None:
    orders = list(orders)
    assert min(orders) >= 1, f"minimum order is not >= 1, found {min(orders)}"
    for a, b in zip(orders, orders[1:]):
        assert b == a + 1, f"orders are not consecutive; contains {a} and {b}"


class NGramsFeaturizer(HostTransformer):
    """All n-grams of consecutive orders from a token sequence (reference
    ``ngrams.scala:20-91``): for each start position, the lowest-order
    gram, then one word longer up to the highest order."""

    def __init__(self, orders: Sequence[int]):
        _check_orders(orders)
        self.orders = tuple(orders)

    def eq_key(self):
        return (NGramsFeaturizer, self.orders)

    def apply(self, tokens: Sequence[Any]) -> List[NGram]:
        lo, hi = min(self.orders), max(self.orders)
        out: List[NGram] = []
        n = len(tokens)
        for i in range(n - lo + 1):
            for order in range(lo, hi + 1):
                if i + order > n:
                    break
                out.append(NGram(tokens[i:i + order]))
        return out


DEFAULT_MODE = "default"
NO_ADD_MODE = "noAdd"


class NGramsCounts(HostTransformer):
    """Count n-gram occurrences over the whole dataset, sorted by count
    descending and then by first appearance (reference
    ``ngrams.scala:142-185``, whose sort leaves ties to partition order).
    The output is a host dataset of (NGram, int) pairs; ``noAdd`` keeps
    each item's own counts, unaggregated."""

    def __init__(self, mode: str = DEFAULT_MODE):
        assert mode in (DEFAULT_MODE, NO_ADD_MODE), (
            "`mode` must be `default` or `noAdd`")
        self.mode = mode

    def apply(self, ngrams):
        counts: dict = {}
        for g in ngrams:
            key = NGram(g)
            counts[key] = counts.get(key, 0) + 1
        return list(counts.items())

    def apply_dataset(self, ds: Dataset) -> Dataset:
        items = ds.collect()
        if self.mode == NO_ADD_MODE:
            return HostDataset([pair for item in items
                                for pair in self.apply(item)])
        counts: dict = {}
        order: dict = {}
        for item in items:
            for g in item:
                key = NGram(g)
                counts[key] = counts.get(key, 0) + 1
                if key not in order:
                    order[key] = len(order)
        pairs = sorted(counts.items(), key=lambda kv: (-kv[1], order[kv[0]]))
        return HostDataset(pairs)
