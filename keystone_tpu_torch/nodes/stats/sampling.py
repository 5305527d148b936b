"""Sampling nodes (reference ``stats/Sampling.scala``).

Counterpart of ``keystone_tpu/nodes/stats/sampling.py``. The random
indices are drawn with ``np.random.RandomState`` exactly as the JAX
package draws them, so both packages select the same rows.
"""
from __future__ import annotations

import numpy as np
import torch

from ...parallel.dataset import ArrayDataset, Dataset, HostDataset, tree_map
from ...workflow.transformer import Transformer


def sample_indices(n: int, size: int, seed: int) -> np.ndarray:
    """The sorted row indices a Sampler(size, seed) keeps out of n."""
    rng = np.random.RandomState(seed)
    idx = rng.choice(n, size=min(size, n), replace=False)
    idx.sort()
    return idx


class Sampler(Transformer):
    """Random subsample of ``size`` items without replacement (reference
    ``Sampler``: RDD takeSample). Deterministic seed."""

    fusable = False

    def __init__(self, size: int, seed: int = 42):
        self.size = size
        self.seed = seed

    def apply(self, x):
        return x

    def apply_dataset(self, ds: Dataset) -> Dataset:
        idx = sample_indices(len(ds), self.size, self.seed)
        if isinstance(ds, ArrayDataset):
            # gather on the device: the input may be every window of
            # every image, the sample a few MB
            sel = torch.as_tensor(idx, device=ds.device)
            return ArrayDataset(tree_map(lambda x: x[sel], ds.data),
                                len(idx), shards=ds.shards)
        items = ds.collect()
        return HostDataset([items[i] for i in idx])

    def abstract_eval(self, dep_specs):
        from ...analysis.spec import DatasetSpec

        out = super().abstract_eval(dep_specs)
        if isinstance(out, DatasetSpec) and out.n is not None:
            return DatasetSpec(out.element, n=min(self.size, out.n),
                               host=out.host, sparsity=out.sparsity)
        return out


class ColumnSampler(Transformer):
    """Sample ``num_cols`` columns of each per-item (d, cols) matrix
    (reference ``ColumnSampler``, used to subsample SIFT descriptors).
    The columns are those of the JAX package's draw: a fresh
    ``RandomState(seed).choice`` over the item's column count, sorted."""

    def __init__(self, num_cols: int, seed: int = 42):
        self.num_cols = num_cols
        self.seed = seed

    def apply(self, x):
        # the draw depends only on the column count: cached per (count,
        # device)
        cache = self.__dict__.setdefault("_idx_cache", {})
        key = (x.shape[-1], str(x.device))
        if key not in cache:
            cache[key] = torch.as_tensor(
                sample_indices(x.shape[-1], self.num_cols, self.seed),
                device=x.device)
        return x[..., cache[key]]


def sample_rows(mat: np.ndarray, num_rows: int, seed: int = 0) -> np.ndarray:
    """Random row subset (reference ``MatrixUtils.sampleRows``)."""
    return np.asarray(mat)[sample_indices(mat.shape[0], num_rows, seed)]
