"""KMeans++.

Counterpart of ``keystone_tpu/nodes/learning/kmeans.py`` (reference
``nodes/learning/KMeansPlusPlus.scala``). The k-means++ choices stay on
the host with ``np.random.RandomState(seed).choice``, as the JAX package
makes them, so a seed picks the same centers in both packages; the
distances behind each choice are computed on the data's device and only
the probabilities are copied back. Lloyd's iterations run on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from ...parallel.dataset import ArrayDataset, Dataset, HostDataset
from ...workflow.estimator import Estimator
from ...workflow.transformer import Transformer


def _as_matrix(ds: Dataset) -> torch.Tensor:
    """The (n, d) rows of a dataset as one tensor on its device."""
    if isinstance(ds, ArrayDataset):
        return ds.data[:ds.n]
    items = ds.items if isinstance(ds, HostDataset) else ds.collect()
    return torch.stack([torch.as_tensor(x) for x in items])


def _sq_dist(X, means):
    """Half squared distances (n, k) by the GEMM form."""
    return (0.5 * torch.sum(X * X, dim=1, keepdim=True) - X @ means.T
            + 0.5 * torch.sum(means * means, dim=1))


class KMeansModel(Transformer):
    """Nearest-center one-hot assignment (reference
    KMeansPlusPlus.scala:16-70). ``means`` (k, d) float32 on the host."""

    def __init__(self, means):
        self.means = np.asarray(means, dtype=np.float32)

    def apply_params(self, device):
        return self._params_on(device, lambda d: torch.as_tensor(
            self.means, device=d))

    def apply_batch(self, X):
        means = self.apply_params(X.device)
        idx = torch.argmin(_sq_dist(X, means), dim=1)
        return torch.nn.functional.one_hot(idx, means.shape[0]).to(X.dtype)

    def apply(self, x):
        return self.apply_batch(x[None, :])[0]


class KMeansPlusPlusEstimator(Estimator):
    """k-means++ initialization + Lloyd's iterations (reference
    KMeansPlusPlus.scala:82-181). One round is pure k-means++ init.
    Deterministic under ``seed``."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import map_last_dim

        return map_last_dim(self.num_means)

    def __init__(self, num_means: int, max_iterations: int,
                 stop_tolerance: float = 1e-3, seed: int = 0):
        self.num_means = num_means
        self.max_iterations = max_iterations
        self.stop_tolerance = stop_tolerance
        self.seed = seed

    def _fit(self, ds: Dataset) -> KMeansModel:
        return self.fit_matrix(_as_matrix(ds))

    def fit_matrix(self, X) -> KMeansModel:
        """Fit on an (n, d) matrix: a tensor (on its device) or a host
        array (on the CPU)."""
        X = torch.as_tensor(X).to(torch.float32)
        n = X.shape[0]
        k = self.num_means
        rng = np.random.RandomState(self.seed)
        x_sq_half = 0.5 * torch.sum(X * X, dim=1)

        # k-means++ seeding (reference :100-123): distances on the device,
        # each choice on the host
        centers = np.zeros(k, dtype=np.int64)
        centers[0] = rng.randint(n)
        cur_sq_dist = None
        for i in range(k - 1):
            c = X[int(centers[i])]
            sq_to_new = x_sq_half - X @ c + 0.5 * torch.dot(c, c)
            cur_sq_dist = (sq_to_new if cur_sq_dist is None
                           else torch.minimum(sq_to_new, cur_sq_dist))
            probs = torch.clamp_min(cur_sq_dist, 0.0).cpu().numpy()
            total = probs.sum()
            if total <= 0:
                centers[i + 1] = rng.randint(n)
            else:
                centers[i + 1] = rng.choice(n, p=probs / total)

        means = X[torch.as_tensor(centers, device=X.device)].clone()

        # Lloyd's iterations with cost-improvement stopping (reference
        # :125-178); only the cost crosses to the host per iteration
        prev_cost = None
        for _ in range(self.max_iterations):
            new_means, cost = _lloyd_step(X, means)
            cost = float(cost)
            if prev_cost is not None:
                improving = (prev_cost - cost) >= \
                    self.stop_tolerance * abs(prev_cost)
                if not improving:
                    break
            means = new_means
            prev_cost = cost
        return KMeansModel(means.cpu().numpy())


def _lloyd_step(X, means):
    sq_dist = _sq_dist(X, means)
    cost = torch.mean(torch.min(sq_dist, dim=1).values)
    assign = torch.nn.functional.one_hot(
        torch.argmin(sq_dist, dim=1), means.shape[0]).to(X.dtype)
    mass = torch.sum(assign, dim=0)
    # an emptied cluster keeps its previous center instead of going NaN
    safe = torch.clamp_min(mass, 1e-12)[:, None]
    new_means = torch.where((mass > 0)[:, None], (assign.T @ X) / safe, means)
    return new_means, cost
