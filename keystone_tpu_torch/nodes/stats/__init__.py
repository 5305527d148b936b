"""Statistical feature nodes.

Counterpart of the scaler in ``keystone_tpu/nodes/stats/__init__.py``
(reference ``stats/StandardScaler.scala``).
"""
from __future__ import annotations

import numpy as np
import torch

from ...parallel.dataset import ArrayDataset, Dataset
from ...workflow.estimator import Estimator
from ...workflow.transformer import Transformer


class StandardScalerModel(Transformer):
    """(x - mean) [/ std] (reference ``stats/StandardScaler.scala:16-31``).
    The batch path multiplies by the reciprocal std, as the JAX package's
    batch path does; the datum path divides."""

    def __init__(self, mean, std=None):
        self.mean = mean
        self.std = std

    def apply_params(self, device):
        def build(d):
            mean = torch.as_tensor(np.asarray(self.mean), dtype=torch.float32,
                                   device=d)
            if self.std is None:
                return mean, None, torch.ones_like(mean)
            std = torch.as_tensor(np.asarray(self.std), dtype=torch.float32,
                                  device=d)
            return mean, std, 1.0 / std
        return self._params_on(device, build)

    def apply(self, x):
        mean, std, _ = self.apply_params(x.device)
        out = x - mean
        return out if std is None else out / std

    def apply_batch(self, X):
        mean, _, inv = self.apply_params(X.device)
        return (X - mean) * inv


class StandardScaler(Estimator):
    """Fit column means (and optionally stds) over the dataset.

    The column sums and sums of squares are two reductions on the device;
    the moments are finished on the host in float64, as in the JAX
    package. Degenerate stds (NaN/inf/<eps) are replaced by 1.0, as in
    the reference.
    """

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def _fit(self, ds: Dataset) -> StandardScalerModel:
        assert isinstance(ds, ArrayDataset), "StandardScaler needs array data"
        X = ds.data
        if not torch.is_floating_point(X):
            X = X.to(torch.float32)
        s = X.sum(dim=0).cpu().numpy()
        sq = (X * X).sum(dim=0).cpu().numpy()
        n = ds.n
        mean = s.astype(np.float64) / n
        if not self.normalize_std_dev:
            return StandardScalerModel(mean.astype(np.float32))
        # unbiased sample variance, matching MultivariateOnlineSummarizer
        var = (sq.astype(np.float64) - n * mean * mean) / max(n - 1, 1)
        std = np.sqrt(np.maximum(var, 0.0))
        bad = ~np.isfinite(std) | (np.abs(std) < self.eps)
        std = np.where(bad, 1.0, std)
        return StandardScalerModel(mean.astype(np.float32),
                                   std.astype(np.float32))
