"""Probabilistic classifiers, discriminant analysis, and the linear model
over sparse inputs.

Counterpart of ``keystone_tpu/nodes/learning/classifiers.py`` (reference
``NaiveBayesModel.scala``, ``LogisticRegressionModel.scala``,
``LinearDiscriminantAnalysis.scala``, ``LocalLeastSquaresEstimator.scala``,
``SparseLinearMapper.scala``). Where the reference wraps Spark MLlib
trainers, the models are trained directly: multinomial naive Bayes from
per-class sums, multinomial logistic regression by the port's L-BFGS.

The sparse fits run on the labels' device (the default device when the
labels are host items) and reduce in a fixed order, so a fit gives the
same bits every time (ROADMAP ground rules): naive Bayes sums each
class's features in float64 as the row sums of Xᵀ times a one-hot of the
labels, and logistic regression takes its gradient Xᵀ G through the
transposed ``CSRMatrix``, formed once a fit. Neither scatters: the JAX
package's ``.at[].add`` has no counterpart here, since ``index_add_`` on
a card sums in the order of its atomics. Sparse scoring goes through
``SparseLinearMapper``, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ...ops import linalg
from ...ops.device import resolve_device
from ...ops.lbfgs import lbfgs
from ...parallel.dataset import ArrayDataset, Dataset, HostDataset, ensure_array
from ...workflow.label_estimator import LabelEstimator
from ...workflow.operators import tensor_token
from ...workflow.transformer import Transformer
from ..stats import StandardScalerModel
from ..util.sparse import (
    CSRMatrix,
    SparseVector,
    is_sparse_host,
    pack_sparse_fit_inputs,
    sparse_batch,
)
from .linear import LinearMapper


def _host(v):
    return v.cpu() if isinstance(v, torch.Tensor) else v


def _device_of(weights) -> torch.device:
    """Where a model's sparse scoring runs: its weights' device, or the
    default device for host weights."""
    if isinstance(weights, torch.Tensor):
        return weights.device
    return resolve_device()


def _fit_device(labels) -> torch.device:
    """Where a sparse fit runs: the labels' device, or the default
    device when the labels are host items."""
    if isinstance(labels, ArrayDataset):
        return labels.device
    return resolve_device()


def _class_ids(y: np.ndarray, k: int) -> np.ndarray:
    y = np.asarray(y).astype(np.int64).ravel()
    if y.size and (y.min() < 0 or y.max() >= k):
        raise ValueError(f"labels must lie in [0, {k}), found "
                         f"[{y.min()}, {y.max()}]")
    return y


class SparseLinearMapper(Transformer):
    """out = x W (+ b) for a SparseVector or a dense x (reference
    ``SparseLinearMapper.scala:22-48``). A SparseVector gathers its
    active weight rows; a batch of SparseVectors packs to padded COO
    (``sparse_batch``) and is one gather and one contraction on the
    weights' device; a dense batch is one GEMM on its own."""

    fusable = False

    def __init__(self, weights, intercept: Optional[np.ndarray] = None):
        self.weights = weights
        self.intercept = intercept

    def eq_key(self):
        return (SparseLinearMapper, tensor_token(self.weights),
                tensor_token(self.intercept))

    def _device(self) -> torch.device:
        return _device_of(self.weights)

    def apply_params(self, device):
        def build(d):
            W = torch.as_tensor(self.weights, dtype=torch.float32, device=d)
            b = (torch.zeros(W.shape[1], device=d) if self.intercept is None
                 else torch.as_tensor(self.intercept, dtype=torch.float32,
                                      device=d))
            return W, b
        return self._params_on(device, build)

    def _check_size(self, size: int) -> None:
        d = self.weights.shape[0]
        if size != d:
            raise ValueError(f"sparse input size {size} != model dim {d}")

    def apply(self, x):
        if isinstance(x, SparseVector):
            self._check_size(x.size)
            W, b = self.apply_params(self._device())
            idx = torch.as_tensor(x.indices.astype(np.int64), device=W.device)
            vals = torch.as_tensor(x.values, device=W.device)
            return vals @ W[idx] + b
        W, b = self.apply_params(x.device)
        return x @ W + b

    def apply_batch(self, X):
        W, b = self.apply_params(X.device)
        return X @ W + b

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if is_sparse_host(ds):
            indices, values, size = sparse_batch(ds.items)
            self._check_size(size)
            W, b = self.apply_params(self._device())
            idx = torch.as_tensor(indices.astype(np.int64), device=W.device)
            vals = torch.as_tensor(values, device=W.device)
            out = torch.einsum("rs,rsk->rk", vals, W[idx]) + b
            return ArrayDataset(out, len(ds.items))
        return super().apply_dataset(ds)

    def __getstate__(self):
        # device tensors pickle as host copies
        d = super().__getstate__()
        d["weights"] = _host(d["weights"])
        d["intercept"] = _host(d["intercept"])
        return d


# -- naive Bayes --------------------------------------------------------------

class NaiveBayesModel(Transformer):
    """Log-posterior scores pi + theta x (reference
    ``NaiveBayesModel.scala:49-53``). A host dataset of SparseVectors
    scores through ``SparseLinearMapper(theta.T, intercept=pi)``, never
    a densified (n, d) matrix; a dense batch is one GEMM."""

    fusable = False

    def __init__(self, pi, theta):
        self.pi = pi        # (k,)
        self.theta = theta  # (k, d)

    def eq_key(self):
        return (NaiveBayesModel, tensor_token(self.pi),
                tensor_token(self.theta))

    def apply_params(self, device):
        def build(d):
            return (torch.as_tensor(self.pi, dtype=torch.float32, device=d),
                    torch.as_tensor(self.theta, dtype=torch.float32,
                                    device=d))
        return self._params_on(device, build)

    def _sparse_mapper(self) -> SparseLinearMapper:
        pi, theta = self.apply_params(_device_of(self.theta))
        return SparseLinearMapper(theta.T, intercept=pi)

    def apply(self, x):
        if isinstance(x, SparseVector):
            return self._sparse_mapper().apply(x)
        pi, theta = self.apply_params(x.device)
        return pi + theta @ x

    def apply_batch(self, X):
        pi, theta = self.apply_params(X.device)
        return X @ theta.T + pi

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if is_sparse_host(ds):
            return self._sparse_mapper().apply_dataset(ds)
        return super().apply_dataset(ds)

    def __getstate__(self):
        d = super().__getstate__()
        d["pi"] = _host(d["pi"])
        d["theta"] = _host(d["theta"])
        return d


def sparse_class_sums(indices: np.ndarray, values: np.ndarray, d: int,
                      y: np.ndarray, k: int, device) -> torch.Tensor:
    """(k, d) float64 sums of each class's sparse rows, on ``device``:
    Xᵀ (a float64 ``CSRMatrix``, each feature's terms in row order)
    times the (n, k) one-hot of ``y``, transposed. A fixed-order sum of
    row products; no scatter."""
    dev = torch.device(device)
    Xt = CSRMatrix.from_padded(indices, values, d, dev,
                               torch.float64).transpose()
    onehot = torch.zeros((len(y), k), dtype=torch.float64, device=dev)
    onehot[torch.arange(len(y), device=dev),
           torch.as_tensor(y, device=dev)] = 1.0
    return Xt.matmul(onehot).T


class NaiveBayesEstimator(LabelEstimator):
    """Multinomial naive Bayes with additive smoothing, the model MLlib's
    ``NaiveBayes.train`` gives (reference ``NaiveBayesModel.scala:56-68``):

        pi_c = log((n_c + lam) / (n + k lam)),
        theta_cj = log((sum_cj + lam) / (sum_c + d lam)).

    Labels are int class ids. A host dataset of SparseVectors (the text
    path; the reference feeds MLlib sparse vectors,
    ``NewsgroupsPipeline.scala:24-31``) is summed by
    ``sparse_class_sums`` in float64 on the labels' device, never
    densified; dense array features are summed by one one-hot product
    on their device, in float32 as the JAX package sums them."""

    def __init__(self, num_classes: int, lam: float = 1.0):
        self.num_classes = num_classes
        self.lam = lam

    def _fit(self, ds: Dataset, labels: Dataset) -> NaiveBayesModel:
        k = self.num_classes
        if isinstance(ds, HostDataset):
            if not is_sparse_host(ds):
                raise TypeError(
                    "NaiveBayesEstimator host path needs SparseVector items")
            indices, values, d, y = pack_sparse_fit_inputs(ds, labels)
            y = _class_ids(y, k)
            dev = _fit_device(labels)
            sums = sparse_class_sums(indices, values, d, y, k, dev)
            counts = torch.as_tensor(np.bincount(y, minlength=k),
                                     dtype=torch.float64, device=dev)
        else:
            ds = ensure_array(ds)
            labels = ensure_array(labels, ds.device)
            X = ds.data.to(torch.float32)
            y = labels.data.reshape(-1).to(torch.int64)
            onehot = torch.nn.functional.one_hot(y, k).to(X.dtype)
            onehot = onehot * ds.mask[:, None].to(X.dtype)
            sums = (onehot.T @ X).to(torch.float64)
            counts = onehot.sum(dim=0).to(torch.float64)
        n = counts.sum()
        pi = torch.log(counts + self.lam) - torch.log(n + k * self.lam)
        theta = torch.log(sums + self.lam) - torch.log(
            sums.sum(dim=1, keepdim=True) + sums.shape[1] * self.lam)
        return NaiveBayesModel(pi.to(torch.float32), theta.to(torch.float32))


# -- logistic regression -------------------------------------------------------

class LogisticRegressionModel(Transformer):
    """argmax-class prediction from a multinomial logistic model
    (reference ``LogisticRegressionModel.scala``, MLlib's
    ``model.predict``). A host dataset of SparseVectors scores through
    ``SparseLinearMapper``, as the JAX model does."""

    fusable = False

    def __init__(self, weights):
        self.weights = weights  # (d, k)

    def eq_key(self):
        return (LogisticRegressionModel, tensor_token(self.weights))

    def apply_params(self, device):
        return self._params_on(device, lambda d: torch.as_tensor(
            self.weights, dtype=torch.float32, device=d))

    def apply(self, x):
        if isinstance(x, SparseVector):
            scores = SparseLinearMapper(
                self.apply_params(_device_of(self.weights))).apply(x)
        else:
            scores = x @ self.apply_params(x.device)
        return torch.argmax(scores, dim=-1).to(torch.int32)

    def apply_batch(self, X):
        return torch.argmax(X @ self.apply_params(X.device),
                            dim=-1).to(torch.int32)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        if is_sparse_host(ds):
            scores = SparseLinearMapper(
                self.apply_params(_device_of(self.weights))).apply_dataset(ds)
            return scores.map_batch(
                lambda s: torch.argmax(s, dim=-1).to(torch.int32))
        return super().apply_dataset(ds)

    def __getstate__(self):
        d = super().__getstate__()
        d["weights"] = _host(d["weights"])
        return d


def _solve_stats(res) -> dict:
    return {"iterations": res.num_iters,
            "line_search_steps": res.line_search_steps,
            "evaluations": res.evaluations, "loss": res.f}


def sparse_logistic_objective(A: CSRMatrix, At: CSRMatrix, y: np.ndarray,
                              num_classes: int, lam: float):
    """``value_and_grad`` of the mean softmax cross-entropy plus
    (lam / 2) ||W||² over the sparse rows of A (the JAX package's
    ``_run_sparse_logistic`` objective): logits A W and gradient
    Aᵀ (softmax - onehot) / n + lam W, both fixed-order row sums, in
    A's dtype."""
    n = A.shape[0]
    dev = A.device
    onehot = torch.zeros((n, num_classes), dtype=A.dtype, device=dev)
    onehot[torch.arange(n, device=dev),
           torch.as_tensor(y, device=dev)] = 1.0

    def value_and_grad(W):
        logp = torch.log_softmax(A.matmul(W), dim=-1)
        loss = -torch.sum(onehot * logp) / n + 0.5 * lam * torch.sum(W * W)
        G = torch.exp(logp) - onehot
        return loss, At.matmul(G) / n + lam * W

    return value_and_grad


class LogisticRegressionEstimator(LabelEstimator):
    """Multinomial logistic regression by L-BFGS with an L2 penalty
    (reference ``LogisticRegressionModel.scala:56-93``, which defers to
    MLlib's ``LogisticRegressionWithLBFGS``). A host dataset of
    SparseVectors fits on the labels' device through
    ``sparse_logistic_objective`` (the reference fed MLlib sparse
    vectors, ``AmazonReviewsPipeline.scala:25-33``); dense array
    features fit on their device. The model carries the solve's counts
    in ``_solve_stats``."""

    def __init__(self, num_classes: int, reg_param: float = 0.0,
                 num_iters: int = 100, convergence_tol: float = 1e-4):
        self.num_classes = num_classes
        self.reg_param = reg_param
        self.num_iters = num_iters
        self.convergence_tol = convergence_tol

    def _fit(self, ds: Dataset, labels: Dataset) -> LogisticRegressionModel:
        if isinstance(ds, HostDataset):
            return self._fit_sparse(ds, labels)
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        X = ds.data.to(torch.float32)
        y = labels.data.reshape(-1).to(torch.int64)
        k, n, lam = self.num_classes, ds.n, float(self.reg_param)
        m = ds.mask.to(X.dtype)[:, None]
        onehot = torch.nn.functional.one_hot(y, k).to(X.dtype)

        def value_and_grad(W):
            logp = torch.log_softmax(X @ W, dim=-1)
            loss = (-torch.sum(onehot * logp * m) / n
                    + 0.5 * lam * torch.sum(W * W))
            G = (torch.exp(logp) - onehot) * m
            return loss, X.T @ G / n + lam * W

        res = lbfgs(value_and_grad,
                    torch.zeros((X.shape[1], k), device=X.device),
                    max_iters=self.num_iters, tol=self.convergence_tol)
        model = LogisticRegressionModel(res.x)
        model._solve_stats = _solve_stats(res)
        return model

    def _fit_sparse(self, ds, labels) -> LogisticRegressionModel:
        indices, values, d, y = pack_sparse_fit_inputs(ds, labels)
        y = _class_ids(y, self.num_classes)
        A = CSRMatrix.from_padded(indices, values, d, _fit_device(labels))
        value_and_grad = sparse_logistic_objective(
            A, A.transpose(), y, self.num_classes, float(self.reg_param))
        res = lbfgs(value_and_grad,
                    torch.zeros((d, self.num_classes), device=A.device),
                    max_iters=self.num_iters, tol=self.convergence_tol)
        model = LogisticRegressionModel(res.x)
        model._solve_stats = _solve_stats(res)
        return model


# -- discriminant analysis, dual ridge ----------------------------------------

class LinearDiscriminantAnalysis(LabelEstimator):
    """Multi-class LDA by the eigenvectors of inv(Sw) Sb (reference
    ``LinearDiscriminantAnalysis.scala:34-66``): the within- and
    between-class scatter matrices in float64 on the data's device, a
    non-symmetric eigendecomposition, the ``num_dimensions`` directions
    of largest |eigenvalue|. Eigenvectors are free in sign and scale, so
    two fits agree as subspaces."""

    def __init__(self, num_dimensions: int):
        self.num_dimensions = num_dimensions

    def _fit(self, ds: Dataset, labels: Dataset) -> LinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        X = ds.data[: ds.n].to(torch.float64)
        y = labels.data[: ds.n].reshape(-1).to(torch.int64)
        total_mean = X.mean(dim=0)
        d = X.shape[1]
        sw = torch.zeros((d, d), dtype=torch.float64, device=X.device)
        sb = torch.zeros_like(sw)
        for c in torch.unique(y).tolist():
            Xc = X[y == c]
            mu = Xc.mean(dim=0)
            dev = Xc - mu
            sw += dev.T @ dev
            md = (mu - total_mean)[None, :]
            sb += Xc.shape[0] * (md.T @ md)
        evals, evecs = torch.linalg.eig(torch.linalg.inv(sw) @ sb)
        order = torch.argsort(-evals.abs(), stable=True)[: self.num_dimensions]
        return LinearMapper(evecs[:, order].real.to(torch.float32))


class LocalLeastSquaresEstimator(LabelEstimator):
    """Dual-form ridge for d >> n (reference
    ``LocalLeastSquaresEstimator.scala:26-60``): center features and
    labels, W = A_zmᵀ ((A_zm A_zmᵀ + lam I) \\ b_zm) on the data's device
    (``ops.linalg.local_least_squares_dual``)."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    def __init__(self, lam: float):
        self.lam = lam

    def _fit(self, ds: Dataset, labels: Dataset) -> LinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        A = ds.data[: ds.n].to(torch.float32)
        b = labels.data[: ds.n].to(torch.float32)
        a_mean, b_mean = A.mean(dim=0), b.mean(dim=0)
        W = linalg.local_least_squares_dual(A - a_mean, b - b_mean,
                                            float(self.lam))
        return LinearMapper(W, intercept=b_mean,
                            feature_scaler=StandardScalerModel(
                                a_mean.cpu().numpy()))
