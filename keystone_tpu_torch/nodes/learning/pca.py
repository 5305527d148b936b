"""PCA family.

Counterpart of ``keystone_tpu/nodes/learning/pca.py`` (reference
``nodes/learning/PCA.scala`` and ``DistributedPCA.scala``): the local PCA
is a centered SVD on the data's device; the distributed one keeps the
TSQR structure (center, R factor of the QR, SVD of the small R on the
host), which on one device is a single QR. The approximate PCA is the
randomized sketch (Gaussian sketch drawn on the host from
``RandomState(seed)`` as the JAX package draws it, power iterations with
QRs, SVD of the projection) on the data's device. All run in true
float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops import linalg
from ...parallel.dataset import ArrayDataset, Dataset, HostDataset
from ...workflow.estimator import Estimator
from ...workflow.optimizable import NodeChoice, OptimizableEstimator
from ...workflow.transformer import Transformer
from .kmeans import _as_matrix


def enforce_matlab_sign_convention(pca: np.ndarray) -> np.ndarray:
    """Largest-magnitude element of each column becomes positive
    (reference PCA.scala:238-247)."""
    col_max = pca.max(axis=0)
    abs_max = np.abs(pca).max(axis=0)
    signs = np.where(col_max == abs_max, 1.0, -1.0).astype(pca.dtype)
    return pca * signs


class _PcaProjection(Transformer):
    """x -> pca_mat^T x for a fitted (d, k) basis, float32 on the host,
    staged per device by ``apply_params``."""

    def __init__(self, pca_mat):
        self.pca_mat = np.asarray(pca_mat, dtype=np.float32)

    def apply_params(self, device):
        return self._params_on(device, lambda d: torch.as_tensor(
            self.pca_mat, device=d))

    def apply_with_params(self, params, x):
        return params.T @ x

    def apply(self, x):
        return self.apply_with_params(self.apply_params(x.device), x)


class PCATransformer(_PcaProjection):
    """x -> pca_mat^T x (reference PCA.scala:19-30). pca_mat is (d, k)."""

    def apply_batch(self, X):
        return X @ self.apply_params(X.device)


class BatchPCATransformer(_PcaProjection):
    """Per-item matrix projection: (d, cols) -> (k, cols)
    (reference PCA.scala:38-43)."""


class _PcaAbstractFitMixin:
    """The static semantics shared by the PCA estimators: the fitted
    projection replaces the leading (descriptor) axis with ``dims``."""

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import ShapeDtype, Unknown

        dims = self.dims

        def apply_element(element):
            if isinstance(element, ShapeDtype) and element.shape:
                return ShapeDtype((dims,) + tuple(element.shape[1:]),
                                  element.dtype)
            return Unknown("pca input not an array element")

        return apply_element

    # -- static HBM planning (analysis.resources) --------------------------
    def fitted_nbytes(self, dep_specs):
        """The fitted projection: (d, dims) float32, d the input
        element's leading (descriptor) axis."""
        from ...analysis.spec import ShapeDtype

        element = getattr(dep_specs[0], "element", None) if dep_specs \
            else None
        if not (isinstance(element, ShapeDtype) and element.shape):
            return None
        return 4.0 * float(element.shape[0]) * self.dims


def _svd_pca(X: torch.Tensor, dims: int) -> np.ndarray:
    """Centered SVD of the rows of X on its device, sign-fixed basis (d,
    dims) on the host."""
    X = X.to(torch.float32)
    _, _, vt = torch.linalg.svd(X - X.mean(dim=0), full_matrices=False)
    pca = enforce_matlab_sign_convention(vt.T.cpu().numpy())
    return pca[:, :dims]


class PCAEstimator(_PcaAbstractFitMixin, Estimator):
    """Local PCA: collect the (sampled) data, center, SVD
    (reference PCA.scala:163-210)."""

    def __init__(self, dims: int):
        self.dims = dims

    def _fit(self, ds: Dataset) -> PCATransformer:
        return PCATransformer(self.compute_pca(_as_matrix(ds)))

    def compute_pca(self, X) -> np.ndarray:
        return _svd_pca(torch.as_tensor(X), self.dims)

    #: gather + one SVD: two serial rounds in the JAX package's program
    #: (its structure, read only with a nonzero ``lat_w``).
    DISPATCH_ROUNDS = 2

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w,
             lat_w=0.0) -> float:
        """Reference cost model (PCA.scala:~213-226): all data moves to
        one machine; ``lat_w`` seconds per serial device round, as in
        ``LinearMapEstimator.cost`` (0 is the reference surface)."""
        flops = n * d * d
        bytes_scanned = n * d
        network = n * d
        return (max(cpu_w * flops, mem_w * bytes_scanned) + net_w * network
                + lat_w * self.DISPATCH_ROUNDS)


class DistributedPCAEstimator(_PcaAbstractFitMixin, Estimator):
    """PCA via TSQR: center by the column means, R factor of the QR, SVD
    of R on the host (reference DistributedPCA.scala:34-57)."""

    def __init__(self, dims: int):
        self.dims = dims

    def _fit(self, ds: Dataset) -> PCATransformer:
        return PCATransformer(self.compute_pca(_as_matrix(ds)))

    def compute_pca(self, X) -> np.ndarray:
        X = torch.as_tensor(X).to(torch.float32)
        R = linalg.tsqr_r(X - linalg.distributed_mean(X, X.shape[0]))
        _, _, vt = np.linalg.svd(R.cpu().numpy())
        pca = enforce_matlab_sign_convention(vt.T.astype(np.float32))
        return pca[:, : self.dims]

    #: mean + center + TSQR + small host SVD: four serial rounds in the
    #: JAX package's program (its structure, read only with a nonzero
    #: ``lat_w``).
    DISPATCH_ROUNDS = 4

    def cost(self, n, d, k, sparsity, num_machines, cpu_w, mem_w, net_w,
             lat_w=0.0) -> float:
        """Reference cost model (DistributedPCA.scala:59-73), with the
        serial-round term of ``PCAEstimator.cost``."""
        log2m = np.log2(max(num_machines, 1))
        flops = n * d * d / num_machines + d * d * d * log2m
        bytes_scanned = n * d
        network = d * d * log2m
        return (max(cpu_w * flops, mem_w * bytes_scanned) + net_w * network
                + lat_w * self.DISPATCH_ROUNDS)


def _randomized_svd_vt(X: torch.Tensor, omega: torch.Tensor,
                       q: int) -> torch.Tensor:
    """Right singular vectors (ell, d) of the centered rows of X seen
    through the sketch ``omega`` (d, ell), after ``q`` power iterations,
    each with two QRs (Halko, Martinsson and Tropp, algorithms 4.4 and
    5.1)."""
    A = X - X.mean(dim=0)
    Q, _ = torch.linalg.qr(A @ omega)
    for _ in range(q):
        Q, _ = torch.linalg.qr(A.T @ Q)
        Q, _ = torch.linalg.qr(A @ Q)
    _, _, vt = torch.linalg.svd(Q.T @ A, full_matrices=False)
    return vt


class ApproximatePCAEstimator(_PcaAbstractFitMixin, Estimator):
    """Randomized-sketch PCA (reference ApproximatePCA.scala:38-86): a
    Gaussian sketch of ``dims + p`` columns, ``q`` power iterations,
    then the SVD of the projected matrix, on the data's device. The same
    ``seed`` gives the JAX package's sketch."""

    def __init__(self, dims: int, q: int = 10, p: int = 5, seed: int = 0):
        self.dims = dims
        self.q = q
        self.p = p
        self.seed = seed

    def _fit(self, ds: Dataset) -> PCATransformer:
        return PCATransformer(self.approximate_pca(_as_matrix(ds)))

    def approximate_pca(self, X) -> np.ndarray:
        """The sign-fixed (d, dims) basis of the rows of X, on the host."""
        X = torch.as_tensor(X).to(torch.float32)
        rng = np.random.RandomState(self.seed)
        omega = rng.randn(X.shape[1], self.dims + self.p).astype(np.float32)
        vt = _randomized_svd_vt(X, torch.as_tensor(omega, device=X.device),
                                 self.q)
        pca = enforce_matlab_sign_convention(vt.T.cpu().numpy())
        return pca[:, : self.dims]


class LocalColumnPCAEstimator(_PcaAbstractFitMixin, Estimator):
    """Fits PCA treating each column of per-item matrices as a sample
    (reference PCA.scala:51-76); emits BatchPCATransformer."""

    def __init__(self, dims: int):
        self.dims = dims

    def _fit(self, ds: Dataset) -> BatchPCATransformer:
        return BatchPCATransformer(
            PCAEstimator(self.dims).compute_pca(_stack_item_columns(ds)))


class DistributedColumnPCAEstimator(_PcaAbstractFitMixin, Estimator):
    """The TSQR variant of the column PCA (reference PCA.scala:78-102)."""

    def __init__(self, dims: int):
        self.dims = dims

    def _fit(self, ds: Dataset) -> BatchPCATransformer:
        return BatchPCATransformer(DistributedPCAEstimator(
            self.dims).compute_pca(_stack_item_columns(ds)))


class ColumnPCAEstimator(_PcaAbstractFitMixin, OptimizableEstimator):
    """Optimizable column PCA (reference PCA.scala:118-156): the
    node-level rule picks the local or the distributed PCA by the
    reference's cost models at the sampled item geometry; without the
    rule it fits through its ``default``, the distributed PCA. Both are
    exact PCAs of the same sample. The weights default to the
    reference's EC2 calibration (``least_squares.REFERENCE_EC2_WEIGHTS``).
    """

    def __init__(self, dims: int, cpu_weight: float = None,
                 mem_weight: float = None, network_weight: float = None,
                 lat_weight: float = None):
        from .least_squares import REFERENCE_EC2_WEIGHTS as ec2

        self.dims = dims
        self.cpu_weight = ec2["cpu_weight"] if cpu_weight is None \
            else cpu_weight
        self.mem_weight = ec2["mem_weight"] if mem_weight is None \
            else mem_weight
        self.network_weight = (ec2["network_weight"] if network_weight is None
                               else network_weight)
        self.lat_weight = ec2["lat_weight"] if lat_weight is None \
            else lat_weight

    @property
    def options(self):
        return [LocalColumnPCAEstimator(self.dims),
                DistributedColumnPCAEstimator(self.dims)]

    @property
    def default(self):
        return DistributedColumnPCAEstimator(self.dims)

    def optimize(self, sample: Dataset, n: int,
                 num_machines: int) -> NodeChoice:
        """The column PCA's sample unit is a (d, cols) matrix; the cost
        models see the total column count as n (reference
        PCA.scala:134-151)."""
        items = sample.collect()
        cols_per_item = int(items[0].shape[-1]) if items else 1
        d = int(items[0].shape[0]) if items else 1
        return self._choose(d, cols_per_item, n, num_machines)

    def optimize_static(self, spec, n: int, num_machines: int):
        """Static form: the (d, cols) item geometry comes from the
        analyzer's element spec instead of a sampled matrix."""
        from ...analysis.spec import ShapeDtype

        element = getattr(spec, "element", None)
        if not (isinstance(element, ShapeDtype) and len(element.shape) == 2):
            return None
        d, cols_per_item = int(element.shape[0]), int(element.shape[1])
        return self._choose(d, cols_per_item, n, num_machines)

    def _choose(self, d: int, cols_per_item: int, n: int,
                num_machines: int) -> NodeChoice:
        total_cols = n * cols_per_item
        local = PCAEstimator(self.dims)
        dist = DistributedPCAEstimator(self.dims)
        costs = [
            (local.cost(total_cols, d, self.dims, 1.0, num_machines,
                        self.cpu_weight, self.mem_weight,
                        self.network_weight, lat_w=self.lat_weight), 0),
            (dist.cost(total_cols, d, self.dims, 1.0, num_machines,
                       self.cpu_weight, self.mem_weight,
                       self.network_weight, lat_w=self.lat_weight), 1),
        ]
        _, best = min(costs)
        return NodeChoice(self.options[best])


def _stack_item_columns(ds: Dataset) -> torch.Tensor:
    """Items are (d, cols) matrices; all their columns stacked as the rows
    of one (total cols, d) tensor on the items' device (the reference's
    matrixToColArray flatMap)."""
    if isinstance(ds, ArrayDataset):
        arr = ds.data[:ds.n]                          # (n, d, cols)
        return arr.permute(0, 2, 1).reshape(-1, arr.shape[1])
    items = ds.items if isinstance(ds, HostDataset) else ds.collect()
    return torch.cat([torch.as_tensor(m).T for m in items], dim=0)
