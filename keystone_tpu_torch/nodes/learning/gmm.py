"""Diagonal-covariance Gaussian mixtures.

Counterpart of ``keystone_tpu/nodes/learning/gmm.py`` (reference
``nodes/learning/GaussianMixtureModel.scala`` and
``GaussianMixtureModelEstimator.scala``), trained per Sanchez et al.'s
Fisher-vector guidelines. The posteriors keep the "Mahalanobis via GEMM"
+ max-shifted softmax + thresholding structure the Fisher-vector encoder
depends on. EM runs on the data's device in true float32; only the
(cost, unbalanced) pair of each iteration crosses to the host for the
stopping decisions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...parallel.dataset import Dataset
from ...workflow.estimator import Estimator
from ...workflow.transformer import Transformer
from .kmeans import KMeansPlusPlusEstimator, _as_matrix

KMEANS_PLUS_PLUS_INITIALIZATION = "kmeans++"
RANDOM_INITIALIZATION = "random"

_LOG_2PI = math.log(2.0 * math.pi)


def _llh(X, XSq, means, variances, weights):
    """Per-sample, per-component log-likelihoods (n, k) of a diagonal GMM;
    means and variances (k, d), weights (k,)."""
    d = X.shape[-1]
    sq_mahl = (XSq @ (0.5 / variances).T - X @ (means / variances).T
               + 0.5 * torch.sum(means * means / variances, dim=1))
    return (-0.5 * d * _LOG_2PI - 0.5 * torch.sum(torch.log(variances), dim=1)
            + torch.log(weights) - sq_mahl)


def _threshold_softmax(llh, weight_threshold):
    """Max-shifted softmax over the last axis, zeroed at or below the
    threshold, then renormalized."""
    q = torch.exp(llh - torch.max(llh, dim=-1, keepdim=True).values)
    q = q / torch.sum(q, dim=-1, keepdim=True)
    q = torch.where(q > weight_threshold, q, 0.0)
    return q / torch.sum(q, dim=-1, keepdim=True)


def _posteriors(X, means, variances, weights, weight_threshold):
    """Thresholded posterior responsibilities of a batch X (n, d) (reference
    GaussianMixtureModel.scala:46-82); means and variances (k, d), weights
    (k,)."""
    return _threshold_softmax(
        _llh(X, X * X, means, variances, weights), weight_threshold)


class GaussianMixtureModel(Transformer):
    """Thresholded posterior assignment transformer. Stored column-major
    like the reference: means and variances (d, k), weights (k,), float32
    numpy arrays on the host; ``apply_params(device)`` stages them."""

    def __init__(self, means, variances, weights,
                 weight_threshold: float = 1e-4):
        self.means = np.asarray(means, dtype=np.float32)
        self.variances = np.asarray(variances, dtype=np.float32)
        self.weights = np.asarray(weights, dtype=np.float32)
        self.weight_threshold = weight_threshold
        assert self.means.shape == self.variances.shape
        assert self.weights.shape[0] == self.means.shape[1]

    @property
    def k(self) -> int:
        return self.means.shape[1]

    @property
    def dim(self) -> int:
        return self.means.shape[0]

    def apply_params(self, device):
        """(means (d, k), variances (d, k), weights (k,)) on ``device``."""
        return self._params_on(device, lambda d: tuple(
            torch.as_tensor(a, device=d)
            for a in (self.means, self.variances, self.weights)))

    def apply_with_params(self, params, x):
        means, variances, weights = params
        return _posteriors(x[None, :], means.T, variances.T, weights,
                           self.weight_threshold)[0]

    def apply(self, x):
        return self.apply_with_params(self.apply_params(x.device), x)

    def apply_batch(self, X):
        means, variances, weights = self.apply_params(X.device)
        return _posteriors(X, means.T, variances.T, weights,
                           self.weight_threshold)

    @staticmethod
    def load(mean_file: str, vars_file: str,
             weights_file: str) -> "GaussianMixtureModel":
        """CSV artifact loading (reference
        GaussianMixtureModel.scala:97-105)."""
        means = np.loadtxt(mean_file, delimiter=",", ndmin=2)
        variances = np.loadtxt(vars_file, delimiter=",", ndmin=2)
        weights = np.loadtxt(weights_file, delimiter=",").ravel()
        return GaussianMixtureModel(means, variances, weights)

    def save(self, mean_file: str, vars_file: str, weights_file: str) -> None:
        """Write the CSV artifacts ``load`` reads: (d, k) means and
        variances, a k-vector of weights."""
        np.savetxt(mean_file, self.means, delimiter=",")
        np.savetxt(vars_file, self.variances, delimiter=",")
        np.savetxt(weights_file, self.weights, delimiter=",")


class GaussianMixtureModelEstimator(Estimator):
    """EM for diagonal GMMs (reference GaussianMixtureModelEstimator.scala:
    25-190): k-means++ (1 round) or range-uniform random init, variance
    floor max(small_var_thresh * global_var, abs_var_thresh), incremental
    LSE log-likelihood stopping, min-cluster-size abort."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import map_last_dim

        return map_last_dim(self.k)

    def __init__(
        self,
        k: int,
        max_iterations: int = 100,
        min_cluster_size: int = 40,
        stop_tolerance: float = 1e-4,
        weight_threshold: float = 1e-4,
        small_variance_threshold: float = 1e-2,
        absolute_variance_threshold: float = 1e-9,
        initialization_method: str = KMEANS_PLUS_PLUS_INITIALIZATION,
        seed: int = 0,
    ):
        assert min_cluster_size > 0 and max_iterations > 0
        self.k = k
        self.max_iterations = max_iterations
        self.min_cluster_size = min_cluster_size
        self.stop_tolerance = stop_tolerance
        self.weight_threshold = weight_threshold
        self.small_variance_threshold = small_variance_threshold
        self.absolute_variance_threshold = absolute_variance_threshold
        self.initialization_method = initialization_method
        self.seed = seed

    def _fit(self, ds: Dataset) -> GaussianMixtureModel:
        return self.fit_matrix(_as_matrix(ds))

    def fit_matrix(self, X) -> GaussianMixtureModel:
        """Fit on an (n, d) matrix: a tensor (fitted on its device) or a
        host array (fitted on the CPU)."""
        X = torch.as_tensor(X).to(torch.float32)
        n, d = X.shape
        k = self.k
        XSq = X * X
        # global moments on the host in float32, as the JAX package takes
        # them with numpy
        Xh = X.cpu().numpy()
        mean_global = Xh.mean(axis=0)
        var_global = (Xh * Xh).mean(axis=0) - mean_global ** 2

        if self.initialization_method == KMEANS_PLUS_PLUS_INITIALIZATION:
            km = KMeansPlusPlusEstimator(k, 1, seed=self.seed).fit_matrix(X)
            assign = km.apply_batch(X)                  # (n, k) one-hot
            mass = torch.clamp_min(torch.sum(assign, dim=0), 1e-12)
            weights = mass / n
            means = (assign.T @ X) / mass[:, None]
            variances = (assign.T @ XSq) / mass[:, None] - means ** 2
        else:
            rng = np.random.RandomState(self.seed)
            col_min, col_max = Xh.min(axis=0), Xh.max(axis=0)
            col_range = col_max - col_min
            means = rng.rand(k, d).astype(np.float32) * col_range + col_min
            variances = np.full((k, d), 0.1, np.float32) * (col_range ** 2)
            weights = np.full(k, 1.0 / k, np.float32)

        var_lb = torch.as_tensor(
            np.maximum(self.small_variance_threshold * var_global,
                       self.absolute_variance_threshold),
            dtype=torch.float32, device=X.device)
        means = torch.as_tensor(means, dtype=torch.float32, device=X.device)
        variances = torch.maximum(
            torch.as_tensor(variances, dtype=torch.float32, device=X.device),
            var_lb)
        weights = torch.as_tensor(weights, dtype=torch.float32,
                                  device=X.device)

        prev_cost = None
        for _ in range(self.max_iterations):
            new_means, new_vars, new_weights, llh_mean, unbalanced = _em_iter(
                X, XSq, means, variances, weights, var_lb,
                self.weight_threshold, float(self.min_cluster_size))
            cost, unbalanced = torch.stack(
                [llh_mean, unbalanced.to(llh_mean.dtype)]).cpu().tolist()
            if prev_cost is not None:
                if (cost - prev_cost) < self.stop_tolerance * abs(prev_cost):
                    break
            if unbalanced:
                # unbalanced clustering: stop updating (reference :176-178)
                break
            means, variances, weights = new_means, new_vars, new_weights
            prev_cost = cost

        return GaussianMixtureModel(
            means.T.cpu().numpy(), variances.T.cpu().numpy(),
            weights.cpu().numpy(), self.weight_threshold)


def _em_iter(X, XSq, means, variances, weights, var_lb, weight_threshold,
             min_cluster_size):
    """One EM iteration on the device. Returns the UPDATED parameters plus
    (mean log-likelihood of the CURRENT parameters, unbalanced flag); the
    caller adopts the update only if neither stopping rule fires. The
    products run in true float32 (TF32 off, ``ops.device``): E[x^2] -
    mean^2 is cancellation-prone."""
    n = X.shape[0]
    llh = _llh(X, XSq, means, variances, weights)
    llh_mean = torch.mean(torch.logsumexp(llh, dim=1))
    q = _threshold_softmax(llh, weight_threshold)
    del llh
    q_sum = torch.sum(q, dim=0)
    unbalanced = torch.any(q_sum < min_cluster_size)
    safe = torch.clamp_min(q_sum, 1e-12)
    new_weights = q_sum / n
    new_means = (q.T @ X) / safe[:, None]
    new_vars = torch.maximum((q.T @ XSq) / safe[:, None] - new_means ** 2,
                             var_lb)
    return new_means, new_vars, new_weights, llh_mean, unbalanced

