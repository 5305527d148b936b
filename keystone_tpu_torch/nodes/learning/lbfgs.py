"""L-BFGS least-squares solvers, dense and sparse.

Counterpart of ``keystone_tpu/nodes/learning/lbfgs.py`` (reference
``nodes/learning/LBFGS.scala`` and ``Gradient.scala``). Objective
(reference CostFun, LBFGS.scala:79-121):

    loss(W) = ||A W - B||^2 / (2 n) + (lambda/2) ||W||^2

minimized by ``ops.lbfgs.lbfgs`` in true float32. The dense solver works
on mean-centered features and labels. The sparse solver takes a host
dataset of SparseVectors, stages it once per fit as a row-compressed
matrix A and its transpose Aᵀ (``nodes.util.sparse.CSRMatrix``), so both
products of the gradient, A W and Aᵀ R, are fixed-order row sums with no
scatter; an intercept is the reference's ones column, left out of the
penalty.

Each fitted model carries its solve's counts in ``_solve_stats``
(iterations, backtracking steps, objective evaluations, final loss).
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops import linalg
from ...ops.device import resolve_device
from ...ops.lbfgs import LBFGSResult, lbfgs
from ...parallel.dataset import ArrayDataset, Dataset, ensure_array
from ...workflow.label_estimator import LabelEstimator
from ..stats import StandardScalerModel
from ..util.sparse import CSRMatrix, pack_sparse_fit_inputs
from .classifiers import SparseLinearMapper
from .linear import LinearMapper


def _stats(res: LBFGSResult) -> dict:
    return {"iterations": res.num_iters,
            "line_search_steps": res.line_search_steps,
            "evaluations": res.evaluations, "loss": res.f}


class DenseLBFGSwithL2(LabelEstimator):
    """Dense least squares by L-BFGS (reference LBFGS.scala:127-193).
    ``fit_intercept`` mean-centers features and labels and stores the
    means on the returned LinearMapper, as the reference does."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    def __init__(self, fit_intercept: bool = True, num_corrections: int = 10,
                 convergence_tol: float = 1e-4, num_iterations: int = 100,
                 lam: float = 0.0):
        self.fit_intercept = fit_intercept
        self.num_corrections = num_corrections
        self.convergence_tol = convergence_tol
        self.num_iterations = num_iterations
        self.lam = lam

    @property
    def weight(self) -> int:
        """Passes over the input a fit makes, for auto-caching's run
        counts (the JAX package's weight)."""
        return self.num_iterations + 1

    def _fit(self, ds: Dataset, labels: Dataset) -> LinearMapper:
        ds = ensure_array(ds)
        labels = ensure_array(labels, ds.device)
        n = ds.n
        X = ds.data.to(torch.float32)
        Y = labels.data.to(torch.float32)
        if self.fit_intercept:
            x_mean = linalg.distributed_mean(X, n)
            y_mean = linalg.distributed_mean(Y, n)
        else:
            x_mean = torch.zeros(X.shape[1], device=X.device)
            y_mean = torch.zeros(Y.shape[1], device=X.device)
        m = ds.mask[:, None].to(X.dtype)
        Xc = (X - x_mean) * m
        Yc = (Y - y_mean) * m
        lam = float(self.lam)

        def value_and_grad(W):
            R = Xc @ W - Yc  # padded rows contribute 0
            loss = 0.5 * torch.sum(R * R) / n + 0.5 * lam * torch.sum(W * W)
            grad = linalg.cross(Xc, R) / n + lam * W
            return loss, grad

        res = lbfgs(value_and_grad,
                    torch.zeros((X.shape[1], Y.shape[1]), device=X.device),
                    max_iters=self.num_iterations,
                    num_corrections=self.num_corrections,
                    tol=self.convergence_tol)
        if self.fit_intercept:
            model = LinearMapper(res.x, intercept=y_mean,
                                 feature_scaler=StandardScalerModel(
                                     x_mean.cpu().numpy()))
        else:
            model = LinearMapper(res.x)
        model._solve_stats = _stats(res)
        return model

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w,
             lat_w=0.0) -> float:
        """Reference cost model (LBFGS.scala:175-191), with the JAX
        package's term of ``lat_w`` seconds per serial device round, one
        a iteration (``lat_w = 0`` is the reference surface)."""
        flops = n * d * k / num_machines
        bytes_scanned = n * d / num_machines
        network = 2.0 * d * k * np.log2(max(num_machines, 1))
        return self.num_iterations * (
            max(cpu_w * flops, mem_w * bytes_scanned) + net_w * network
            + lat_w
        )


class SparseLBFGSwithL2(LabelEstimator):
    """Sparse-input least squares by L-BFGS (reference
    ``LBFGS.scala:209-262`` and ``Gradient.scala:58-119``). Fits a host
    dataset of SparseVectors on the labels' device (the default device
    when the labels are host items) and returns a SparseLinearMapper."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import labels_width_fit

        return labels_width_fit(dep_specs)

    def __init__(self, fit_intercept: bool = True, num_corrections: int = 10,
                 convergence_tol: float = 1e-4, num_iterations: int = 100,
                 lam: float = 0.0, sparse_overhead: float = 8.0):
        self.fit_intercept = fit_intercept
        self.num_corrections = num_corrections
        self.convergence_tol = convergence_tol
        self.num_iterations = num_iterations
        self.lam = lam
        self.sparse_overhead = sparse_overhead

    @property
    def weight(self) -> int:
        """Passes over the input a fit makes, for auto-caching's run
        counts (the JAX package's weight)."""
        return self.num_iterations + 1

    def _fit(self, ds: Dataset, labels: Dataset) -> SparseLinearMapper:
        if isinstance(ds, ArrayDataset):
            raise TypeError(
                "SparseLBFGSwithL2 expects a host dataset of SparseVectors; "
                "dense arrays should use DenseLBFGSwithL2")
        indices, values, d, y = pack_sparse_fit_inputs(ds, labels)
        dev = (labels.device if isinstance(labels, ArrayDataset)
               else resolve_device())
        n = len(y)
        if self.fit_intercept:
            # the ones column: index d, value 1 in an extra slot per row
            indices = np.concatenate(
                [indices, np.full((n, 1), d, np.int32)], axis=1)
            values = np.concatenate(
                [values, np.ones((n, 1), np.float32)], axis=1)
            d_aug = d + 1
        else:
            d_aug = d
        A = CSRMatrix.from_padded(indices, values, d_aug, dev)
        At = A.transpose()
        Y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        k = Y.shape[1]
        # with an intercept the bias row is not regularized (as in
        # DenseLBFGSwithL2, whose intercept is the label mean)
        pen = torch.ones((d_aug, 1), device=dev)
        if self.fit_intercept:
            pen[-1, 0] = 0.0
        lam = float(self.lam)

        def value_and_grad(W):
            R = A.matmul(W) - Y
            Wp = W * pen
            loss = 0.5 * torch.sum(R * R) / n + 0.5 * lam * torch.sum(Wp * Wp)
            grad = At.matmul(R) / n + lam * Wp
            return loss, grad

        res = lbfgs(value_and_grad, torch.zeros((d_aug, k), device=dev),
                    max_iters=self.num_iterations,
                    num_corrections=self.num_corrections,
                    tol=self.convergence_tol)
        W = res.x
        if self.fit_intercept:
            model = SparseLinearMapper(W[:-1].clone(), intercept=W[-1].clone())
        else:
            model = SparseLinearMapper(W)
        model._solve_stats = _stats(res)
        return model

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w,
             lat_w=0.0) -> float:
        """Reference cost model (LBFGS.scala:264-280), with the serial
        device round a iteration of ``DenseLBFGSwithL2.cost``."""
        flops = n * sparsity * d * k / num_machines
        bytes_scanned = n * d * sparsity / num_machines
        network = 2.0 * d * k * np.log2(max(num_machines, 1))
        return self.num_iterations * (
            self.sparse_overhead * max(cpu_w * flops, mem_w * bytes_scanned)
            + net_w * network
            + lat_w
        )
