"""ZCA whitening (reference ``nodes/learning/ZCAWhitener.scala``).

Counterpart of ``keystone_tpu/nodes/learning/zca.py``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.device import DEFAULT_DEVICE, resolve_device
from ...parallel.dataset import ArrayDataset, Dataset
from ...workflow.estimator import Estimator
from ...workflow.transformer import Transformer


class ZCAWhitener(Transformer):
    """(x - means) @ whitener (reference ZCAWhitener.scala:12-18).
    Operates on patch matrices or vectors."""

    def __init__(self, whitener: np.ndarray, means: np.ndarray):
        self.whitener = np.asarray(whitener, dtype=np.float32)
        self.means = np.asarray(means, dtype=np.float32)

    def apply_params(self, device):
        return self._params_on(device, lambda d: (
            torch.as_tensor(self.whitener, device=d),
            torch.as_tensor(self.means, device=d)))

    def apply_with_params(self, params, x):
        W, means = params
        return (x - means) @ W

    def apply(self, x):
        return self.apply_with_params(self.apply_params(x.device), x)

    def apply_batch(self, X):
        return self.apply(X)


class ZCAWhitenerEstimator(Estimator):
    """Fit W = V diag((s^2/(n-1) + eps)^-1/2) V^T on the (sampled) input
    matrix (reference ZCAWhitenerEstimator.scala:30-76, which runs LAPACK
    sgesvd on one host; here the SVD runs on the device in float32)."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import identity_fit

        return identity_fit(dep_specs)

    def __init__(self, eps: float = 0.1):
        self.eps = eps

    def fit_single(self, mat, device=DEFAULT_DEVICE) -> ZCAWhitener:
        """Fit on one matrix (a host array is staged on ``device``; a
        tensor is fitted where it lies)."""
        if not isinstance(mat, torch.Tensor):
            mat = torch.as_tensor(np.asarray(mat), device=resolve_device(device))
        W, means = fit_zca(mat.to(torch.float32), self.eps)
        return ZCAWhitener(W.cpu().numpy(), means.cpu().numpy())

    def _fit(self, ds: Dataset) -> ZCAWhitener:
        assert isinstance(ds, ArrayDataset)
        return self.fit_single(ds.data[: ds.n])


def fit_zca(mat: torch.Tensor, eps: float):
    """(W, means) of the ZCA whitener of ``mat``'s rows. ``W`` does not
    depend on the signs the SVD picks for its singular vectors."""
    n = mat.shape[0]
    means = mat.mean(dim=0)
    _, s, vt = torch.linalg.svd(mat - means, full_matrices=False)
    scale = (s * s / (n - 1.0) + eps) ** -0.5
    return (vt.T * scale) @ vt, means
