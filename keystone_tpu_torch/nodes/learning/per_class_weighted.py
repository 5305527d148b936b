"""Per-class weighted least squares, on one device.

Counterpart of ``keystone_tpu/nodes/learning/per_class_weighted.py``
(reference ``nodes/learning/PerClassWeightedLeastSquares.scala`` and
``internal/ReWeightedLeastSquares.scala``). For every class c a separate
weighted ridge problem is solved by block coordinate descent:

    W_c = (X_zm^T diag(B_c) X_zm + lambda I) \\ X_zm^T (B_c .* y_c)

where B_c gives every example (1-w)/n baseline weight plus w/n_c for the
example's own class, X is centered by the class's joint feature mean
(w * class_mean + (1-w) * pop_mean), and y_c is the label column
centered by the joint label mean. The classes are solved one after the
other, each block's factor through ``ops.linalg.cholesky_health`` and
its breakdown recovery (``finite_or_eigh_solve``), in the inputs' type.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...observability.numerics import record_block_health
from ...ops import linalg
from ...ops.device import DEFAULT_DEVICE, resolve_device
from ...parallel.dataset import Dataset, ensure_array
from ...workflow.label_estimator import LabelEstimator
from .linear import BlockLinearMapper


class PerClassWeightedLeastSquaresEstimator(LabelEstimator):
    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    def __init__(self, block_size: int, num_iter: int, lam: float,
                 mixture_weight: float, num_features: Optional[int] = None):
        self.block_size = block_size
        self.num_iter = num_iter
        self.lam = lam
        self.mixture_weight = mixture_weight
        self.num_features = num_features

    def _fit(self, ds: Dataset, labels: Dataset) -> BlockLinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        return self._solve(ds.data, labels.data, ds.n)

    def fit_arrays(self, X, L, device=DEFAULT_DEVICE) -> BlockLinearMapper:
        """Fit on (n, d) features and (n, k) +-1 indicators; tensors stay
        where they lie, host arrays go to ``device`` (floating types
        kept, others float32)."""
        def stage(a):
            t = a if isinstance(a, torch.Tensor) else torch.as_tensor(
                np.asarray(a), device=resolve_device(device))
            return t if t.is_floating_point() else t.to(torch.float32)

        X, L = stage(X), stage(L)
        return self._solve(X, L.to(X.device, X.dtype), X.shape[0])

    def _solve(self, X, L, n) -> BlockLinearMapper:
        X, L = X[:n], L[:n]
        d, k = X.shape[1], L.shape[1]
        w, lam, bs = float(self.mixture_weight), float(self.lam), \
            self.block_size
        bounds = [(i, min(d, i + bs)) for i in range(0, d, bs)]
        cls = torch.argmax(L, dim=1)
        counts = torch.clamp_min(torch.bincount(cls, minlength=k).to(
            X.dtype), 1.0)
        onehot = torch.nn.functional.one_hot(cls, k).to(X.dtype)
        pop_mean = X.sum(dim=0) / n
        class_means = (onehot.T @ X) / counts[:, None]
        jfm = w * class_means + (1 - w) * pop_mean                 # (k, d)
        joint_label_mean = (counts / n) * 2.0 * (1 - w) - 1.0 + 2.0 * w

        models = torch.empty((d, k), dtype=X.dtype, device=X.device)
        for c in range(k):
            b = (1.0 - w) / n + onehot[:, c] * (w / counts[c])
            y = L[:, c] - joint_label_mean[c]
            models[:, c] = _solve_single_class(X, b, y, jfm[c], lam, bounds,
                                               self.num_iter)
        final_b = joint_label_mean - (jfm.T * models).sum(dim=0)
        return BlockLinearMapper([models[lo:hi] for lo, hi in bounds], bs,
                                 intercept=final_b)


def _solve_single_class(X, b, y, mu, lam, bounds, num_iter):
    """BCD for one class (reference ReWeightedLeastSquares.scala:37-135):
    each block's weighted Gram factored once, then ``num_iter`` passes
    over the blocks with the weighted residual r = B .* (X_zm W)."""
    by = b * y
    Ws = [torch.zeros(hi - lo, dtype=X.dtype, device=X.device)
          for lo, hi in bounds]
    factors, ratios = [], []
    for lo, hi in bounds:
        Xzm = X[:, lo:hi] - mu[lo:hi]
        reg = Xzm.T @ (Xzm * b[:, None]) + lam * torch.eye(
            hi - lo, dtype=X.dtype, device=X.device)
        L, ok, ratio = linalg.cholesky_health(reg)
        factors.append((reg, L, ok))
        ratios.append(ratio)
    record_block_health("per_class_bcd", [f[2] for f in factors], ratios)
    r = torch.zeros_like(y)
    for _ in range(num_iter):
        for i, (lo, hi) in enumerate(bounds):
            Xzm = X[:, lo:hi] - mu[lo:hi]
            r_minus = r - b * (Xzm @ Ws[i])
            aTb = Xzm.T @ (by - r_minus)
            reg, L, ok = factors[i]
            W_new = linalg.finite_or_eigh_solve(
                torch.cholesky_solve(aTb[:, None], L)[:, 0],
                lambda reg=reg: reg, aTb, ok)
            r = r + b * (Xzm @ (W_new - Ws[i]))
            Ws[i] = W_new
    return torch.cat(Ws)
