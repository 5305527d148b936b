"""Sparse feature vectors, their packed forms, Sparsify and the text
vectorizers.

Counterpart of ``keystone_tpu/nodes/util/sparse.py`` (reference
``nodes/util/Sparsify.scala``, ``SparseFeatureVectorizer.scala``,
``CommonSparseFeatures.scala``, ``AllSparseFeatures.scala``): a host
:class:`SparseVector` (sorted int32 indices + float32 values) per item;
:func:`sparse_batch`, which packs a batch into fixed-width padded COO
arrays (the row-wise gather form of a sparse apply); :class:`CSRMatrix`,
the row-compressed form the sparse solvers and the sparse naive Bayes
fit multiply by; and the vectorizers that map (feature, value) pairs to
SparseVectors over a feature space fitted on the host.

A ``CSRMatrix`` product sums each row's terms in a fixed order: the
terms of a row are cut into runs of ``SEGMENT_WIDTH``, each run summed
by one padded gather, and the run sums summed the same way until one
value a row is left. No product scatters, so none depends on the order
of atomic adds: the same inputs give the same bits on every run. The
sparse solver multiplies by both X and Xᵀ, so it forms Xᵀ once per fit
(``transpose``) and both products are row sums. A matrix holds float32
values unless it is made with ``dtype=torch.float64`` (the naive Bayes
sums, and float64 references of the solvers).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...parallel.dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    is_streaming,
)
from ...workflow.estimator import Estimator
from ...workflow.operators import data_token
from ...workflow.transformer import HostTransformer, Transformer

#: terms summed by one padded gather in a CSRMatrix product
SEGMENT_WIDTH = 32


class SparseVector:
    """Host sparse vector: sorted unique indices + values + logical size."""

    __slots__ = ("indices", "values", "size")

    def __init__(self, indices, values, size: int):
        idx = np.asarray(indices, dtype=np.int32)
        val = np.asarray(values, dtype=np.float32)
        # duplicates are coalesced by summing, so todense() and the
        # padded-COO paths (which sum contributions) agree; np.unique
        # also sorts, which the class invariant requires
        uniq, inverse = np.unique(idx, return_inverse=True)
        summed = np.zeros(uniq.shape[0], dtype=np.float32)
        np.add.at(summed, inverse, val)
        self.indices = uniq
        self.values = summed
        self.size = int(size)

    @staticmethod
    def from_dict(tf, size: int) -> "SparseVector":
        if not tf:
            return SparseVector(np.zeros(0, np.int32),
                                np.zeros(0, np.float32), size)
        idx, val = zip(*sorted(tf.items()))
        return SparseVector(np.asarray(idx), np.asarray(val), size)

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def todense(self) -> np.ndarray:
        out = np.zeros(self.size, dtype=np.float32)
        out[self.indices] = self.values
        return out

    def __eq__(self, other):
        return (
            isinstance(other, SparseVector)
            and self.size == other.size
            and np.array_equal(self.indices, other.indices)
            and np.array_equal(self.values, other.values)
        )

    def __repr__(self):
        return f"SparseVector(nnz={self.nnz}, size={self.size})"


def sparse_batch(items: Sequence[SparseVector], max_nnz: Optional[int] = None,
                 allow_truncate: bool = False):
    """Pack SparseVectors into padded COO arrays.

    Returns ``(indices int32[n, m], values f32[n, m], size)`` where padding
    entries have index 0 and value 0, so value-weighted gathers are exact
    without a mask. A vector with more than ``max_nnz`` entries is an
    error unless ``allow_truncate`` (lossy) is requested.
    """
    n = len(items)
    size = items[0].size if items else 0
    m = max(max_nnz or max((it.nnz for it in items), default=1), 1)
    indices = np.zeros((n, m), dtype=np.int32)
    values = np.zeros((n, m), dtype=np.float32)
    for i, it in enumerate(items):
        if it.nnz > m and not allow_truncate:
            raise ValueError(
                f"item {i} has nnz={it.nnz} > max_nnz={m}; pass "
                "allow_truncate=True to drop features")
        if it.size != size:
            raise ValueError(
                f"item {i} has size {it.size} != {size} (mixed feature "
                "spaces in one sparse batch)")
        k = min(it.nnz, m)
        indices[i, :k] = it.indices[:k]
        values[i, :k] = it.values[:k]
    return indices, values, size


def is_sparse_host(ds) -> bool:
    """True for a HostDataset whose items are SparseVectors: the shared
    dispatch predicate of the sparse-input model paths."""
    return (isinstance(ds, HostDataset) and bool(ds.items)
            and isinstance(ds.items[0], SparseVector))


def pack_sparse_fit_inputs(ds, labels):
    """Collect a sparse host dataset and its labels into aligned arrays
    for a solver: ``(indices, values, size, y ndarray)``. Validates the
    item type, one feature-space size, and feature/label alignment."""
    items = ds.collect()
    if not (items and isinstance(items[0], SparseVector)):
        raise TypeError("sparse fit needs a host dataset of SparseVectors")
    indices, values, size = sparse_batch(items)
    if isinstance(labels, ArrayDataset):
        y = np.asarray(labels.numpy())
    else:
        y = np.asarray([v.cpu().numpy() if isinstance(v, torch.Tensor)
                        else v for v in labels.collect()])
    if len(items) != len(y):
        raise ValueError(
            f"labels ({len(y)} rows) do not align with data "
            f"({len(items)} rows)")
    return indices, values, size, y


# -- row-compressed products ------------------------------------------------

def _run_index(lens: np.ndarray, width: int, groups: np.ndarray,
               sentinel: int) -> np.ndarray:
    """(sum(groups), width) gather rows: run j of row r covers the
    row's terms j*width .. (j+1)*width - 1; slots past the row's end
    point at ``sentinel`` (a zero row)."""
    starts = np.cumsum(lens) - lens
    row = np.repeat(np.arange(lens.shape[0]), groups)
    first = np.cumsum(groups) - groups
    j = np.arange(row.shape[0]) - np.repeat(first, groups)
    lo = starts[row] + j * width
    live = np.minimum(lens[row] - j * width, width)
    idx = lo[:, None] + np.arange(width)[None, :]
    idx[np.arange(width)[None, :] >= live[:, None]] = sentinel
    return idx


class CSRMatrix:
    """A sparse (rows, cols) matrix stored row by row: the column index
    and value of every stored term, and the terms of each row, in
    float32 or (``dtype=torch.float64``) float64. ``matmul`` sums each
    row's products in a fixed order (see the module docstring); the
    gather tables are built once, on the host."""

    def __init__(self, counts: np.ndarray, cols: np.ndarray,
                 values: np.ndarray, shape: Tuple[int, int], device,
                 dtype: torch.dtype = torch.float32):
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"CSRMatrix holds float32 or float64, not {dtype}")
        self.shape = (int(shape[0]), int(shape[1]))
        self.counts = np.asarray(counts, np.int64)
        self._cols_host = np.asarray(cols, np.int64)
        self.dtype = dtype
        self._values_host = np.asarray(
            values, np.float32 if dtype == torch.float32 else np.float64)
        self.device = torch.device(device)
        self.cols = torch.as_tensor(self._cols_host, device=self.device)
        self.values = torch.as_tensor(self._values_host, device=self.device)
        self._levels = self._plan()

    @property
    def nnz(self) -> int:
        return int(self._cols_host.shape[0])

    @staticmethod
    def from_padded(indices: np.ndarray, values: np.ndarray, size: int,
                    device, dtype: torch.dtype = torch.float32
                    ) -> "CSRMatrix":
        """From padded COO arrays (``sparse_batch``), dropping the padding
        (and any stored zero, which adds nothing to a product)."""
        live = values != 0
        return CSRMatrix(live.sum(axis=1), indices[live], values[live],
                         (indices.shape[0], size), device, dtype)

    def _plan(self) -> List[torch.Tensor]:
        levels, lens = [], self.counts
        total = self.nnz
        while lens.max(initial=0) > SEGMENT_WIDTH:
            groups = -(-lens // SEGMENT_WIDTH)
            levels.append(_run_index(lens, SEGMENT_WIDTH, groups, total))
            lens, total = groups, int(groups.sum())
        width = max(int(lens.max(initial=0)), 1)
        levels.append(_run_index(lens, width, np.ones_like(lens), total))
        return [torch.as_tensor(i, device=self.device) for i in levels]

    def row_sums(self, terms: torch.Tensor) -> torch.Tensor:
        """(rows, k) sums of each row's (nnz, k) terms, in the fixed
        order of the gather tables."""
        x = terms
        for idx in self._levels:
            x = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
            x = x[idx].sum(dim=1)
        return x

    def matmul(self, M: torch.Tensor) -> torch.Tensor:
        """self @ M for a dense (cols, k) M on this matrix's device."""
        return self.row_sums(self.values[:, None] * M[self.cols])

    def transpose(self) -> "CSRMatrix":
        """The (cols, rows) transpose, row-compressed (a stable sort of
        the terms by column keeps each column's terms in row order)."""
        rows = np.repeat(np.arange(self.shape[0]), self.counts)
        order = np.argsort(self._cols_host, kind="stable")
        counts = np.bincount(self._cols_host, minlength=self.shape[1])
        return CSRMatrix(counts, rows[order], self._values_host[order],
                         (self.shape[1], self.shape[0]), self.device,
                         self.dtype)


class Sparsify(Transformer):
    """Dense vector -> SparseVector (reference ``util/Sparsify.scala``).
    A host stage: a dense batch is copied to the host once and cut into
    items; SparseVectors pass through."""

    fusable = False

    def apply(self, x) -> SparseVector:
        if isinstance(x, SparseVector):
            return x
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        idx = np.nonzero(x)[0]
        return SparseVector(idx, x[idx], x.shape[0])

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if is_streaming(ds):
            raise TypeError(
                "Sparsify is a host stage and cannot consume a "
                "StreamingDataset: its chunks are device-resident. "
                "Sparsify before building the stream, or materialize() it.")
        if isinstance(ds, ArrayDataset):
            return HostDataset([self.apply(row) for row in ds.numpy()])
        return ds.map(self.apply)


# -- text vectorizers -------------------------------------------------------

def _key(feat: Any) -> Any:
    # list-like n-gram keys become hashable tuples
    return tuple(feat) if isinstance(feat, list) else feat


def _iter_pairs(ds: Dataset):
    for item in ds.collect():
        for feat, value in item:
            yield _key(feat), float(value)


class SparseFeatureVectorizer(HostTransformer):
    """(feature, value) pairs -> SparseVector over a fixed feature space
    (reference ``util/SparseFeatureVectorizer.scala:7-18``); features
    outside the space are dropped. Keyed for common-subexpression
    elimination by a token of this vectorizer (``data_token``): the JAX
    package keys it by ``id()`` of its feature space, which a freed
    space can hand on to a new one (ROADMAP C1)."""

    def __init__(self, feature_space: Dict[Any, int]):
        self.feature_space = dict(feature_space)

    def eq_key(self):
        return (SparseFeatureVectorizer, data_token(self))

    def apply(self, pairs: Sequence[Tuple[Any, float]]) -> SparseVector:
        space = self.feature_space
        tf: Dict[int, float] = {}
        for feat, value in pairs:
            j = space.get(_key(feat))
            if j is not None:
                tf[j] = tf.get(j, 0.0) + float(value)
        return SparseVector.from_dict(tf, len(space))

    def __getstate__(self):
        state = super().__getstate__()
        state.pop("_keystone_token", None)
        return state


class CommonSparseFeatures(Estimator):
    """Keep the ``num_features`` most frequent features, ordered by count
    descending, then by first appearance (reference
    ``CommonSparseFeatures.scala:20-64``: a count and the least unique
    id per feature, merged across partitions; here one host pass). This
    order is every later stage's feature index."""

    def __init__(self, num_features: int):
        self.num_features = int(num_features)

    def _fit(self, ds: Dataset) -> SparseFeatureVectorizer:
        counts: Dict[Any, int] = {}
        first: Dict[Any, int] = {}
        i = 0
        for feat, _ in _iter_pairs(ds):
            counts[feat] = counts.get(feat, 0) + 1
            if feat not in first:
                first[feat] = i
            i += 1
        top = sorted(counts, key=lambda f: (-counts[f], first[f]))
        top = top[: self.num_features]
        return SparseFeatureVectorizer({f: j for j, f in enumerate(top)})


class AllSparseFeatures(Estimator):
    """Keep every observed feature, in order of first appearance
    (reference ``AllSparseFeatures.scala:15-27``)."""

    def _fit(self, ds: Dataset) -> SparseFeatureVectorizer:
        space: Dict[Any, int] = {}
        for feat, _ in _iter_pairs(ds):
            if feat not in space:
                space[feat] = len(space)
        return SparseFeatureVectorizer(space)
