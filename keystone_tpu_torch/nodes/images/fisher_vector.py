"""Fisher vector encoding.

Counterpart of ``keystone_tpu/nodes/images/fisher_vector.py`` (reference
``nodes/images/FisherVector.scala`` and the enceval variant
``nodes/images/external/FisherVector.scala``). The FV of a (D, nDesc)
descriptor matrix under a diagonal GMM, in the s0/s1/s2 moment form of
the Sanchez et al. survey:

    q  = GMM posteriors               (nDesc, K)
    s0 = mean(q)                      (K,)
    s1 = X q / nDesc                  (D, K)
    s2 = (X*X) q / nDesc              (D, K)
    fv1 = (s1 - means s0) / (sqrt(vars) sqrt(w))
    fv2 = (s2 - 2 means s1 + (means^2 - vars) s0) / (vars sqrt(2 w))

The moment sums go through ``ops.kernels.fv_moments``: on a CUDA matrix
the kernel, which never writes q to device memory; on a CPU matrix its
plain version, the posterior form. The kernel's GMM terms
(``ops.kernels.fv_terms``) are computed once per fitted model and device,
with the GMM's tensors, by ``FisherVector.apply_params``.
"""
from __future__ import annotations

import functools

import torch

from ...ops.kernels import fv_moments, fv_terms
from ...parallel.dataset import Dataset
from ...workflow.estimator import Estimator
from ...workflow.optimizable import NodeChoice, OptimizableEstimator
from ...workflow.transformer import Transformer
from ..learning.gmm import GaussianMixtureModel, GaussianMixtureModelEstimator
from ..learning.pca import _stack_item_columns


def _fisher_vector(X, means, variances, weights, weight_threshold,
                   moments=fv_moments):
    """X is (D, nDesc); means/variances (D, K); weights (K,). Returns the
    (D, 2K) Fisher vector. ``moments`` computes the raw posterior moment
    sums ``(sum q, X q, (X*X) q)``: the kernel's wrapper (its plain
    version on a CPU matrix), with the GMM's ``fv_terms`` bound or not,
    or ``ops.kernels.fv_moments_plain`` to run the posterior form on any
    device."""
    n_desc = X.shape[1]
    q_sum, s1_sum, s2_sum = moments(X, means, variances, weights,
                                    weight_threshold)
    s0 = q_sum / n_desc                           # (K,)
    s1 = s1_sum / n_desc                          # (D, K)
    s2 = s2_sum / n_desc                          # (D, K)
    sqrt_w = torch.sqrt(weights)
    fv1 = (s1 - means * s0[None, :]) / (torch.sqrt(variances)
                                        * sqrt_w[None, :])
    fv2 = (s2 - 2.0 * means * s1 + (means * means - variances) * s0[None, :]) \
        / (variances * torch.sqrt(2.0 * weights)[None, :])
    return torch.cat([fv1, fv2], dim=1)           # (D, 2K)


class FisherVector(Transformer):
    """FV transformer: (D, nDesc) descriptor matrix -> (D, 2K) matrix
    (reference ``FisherVector.scala:22-54``)."""

    def __init__(self, gmm: GaussianMixtureModel):
        self.gmm = gmm
        self.weight_threshold = gmm.weight_threshold

    def apply_params(self, device):
        """(means, variances, weights, their ``fv_terms``) on ``device``,
        the terms computed once per device."""
        def build(d):
            params = self.gmm.apply_params(d)
            return (*params, fv_terms(*params))

        return self._params_on(device, build)

    def apply_with_params(self, params, x):
        means, variances, weights, terms = params
        return _fisher_vector(x.to(torch.float32), means, variances, weights,
                              self.weight_threshold,
                              functools.partial(fv_moments, terms=terms))

    def apply(self, x):
        return self.apply_with_params(self.apply_params(x.device), x)

    # -- static HBM planning (analysis.resources) --------------------------
    def resource_effect(self, dep_specs, out_spec, data_shards=1):
        """A fitted FV node charges the workspace the estimator's
        Delegate node would."""
        from ...analysis.resources import transform_workspace_effect

        return transform_workspace_effect(
            _fisher_apply_transient(self.gmm.k), dep_specs, out_spec,
            data_shards)


def _fisher_abstract_fit(k: int):
    """The FV's static semantics: a (D, nDesc) descriptor matrix becomes
    a (D, 2K) float32 matrix."""
    from ...analysis.spec import ShapeDtype, Unknown

    def apply_element(element):
        if isinstance(element, ShapeDtype) and len(element.shape) == 2:
            return ShapeDtype((int(element.shape[0]), 2 * k), torch.float32)
        return Unknown("fisher-vector input not a (D, nDesc) matrix")

    return apply_element


def _fisher_fitted_nbytes(k: int, dep_specs):
    """The fitted GMM: means and variances (D, K) float32 each and
    weights (K,), D the input element's descriptor axis."""
    from ...analysis.spec import ShapeDtype

    element = getattr(dep_specs[0], "element", None) if dep_specs else None
    if not (isinstance(element, ShapeDtype) and len(element.shape) == 2):
        return None
    return 4.0 * (2.0 * float(element.shape[0]) * k + k)


def _fisher_apply_transient(k: int):
    """The apply's per-item workspace for the planner: the
    ``fv_moments`` kernel's moment sums
    (``analysis.resources.fv_apply_transient_nbytes``)."""
    from ...analysis.resources import fv_apply_transient_nbytes
    from ...analysis.spec import ShapeDtype

    def workspace(element):
        if not (isinstance(element, ShapeDtype) and len(element.shape) == 2):
            return None
        return fv_apply_transient_nbytes(
            int(element.shape[0]), k, int(element.shape[1]))

    return workspace


def _gmm_from_columns(ds: Dataset, k: int, seed: int = 0
                      ) -> GaussianMixtureModel:
    """Fit the GMM treating every column of every item as a sample, on
    the items' device (reference ``ScalaGMMFisherVectorEstimator``,
    ``FisherVector.scala:67-73``)."""
    return GaussianMixtureModelEstimator(k, seed=seed).fit_matrix(
        _stack_item_columns(ds))


class ScalaGMMFisherVectorEstimator(Estimator):
    """FV estimator (reference ``FisherVector.scala:67-73``; the name
    mirrors the reference's scala implementation)."""

    def abstract_fit(self, dep_specs):
        return _fisher_abstract_fit(self.k)

    # -- static HBM planning (analysis.resources) --------------------------
    def fitted_nbytes(self, dep_specs):
        return _fisher_fitted_nbytes(self.k, dep_specs)

    def abstract_apply_transient(self, dep_specs):
        return _fisher_apply_transient(self.k)

    def __init__(self, k: int):
        self.k = k

    def _fit(self, ds: Dataset) -> FisherVector:
        return FisherVector(_gmm_from_columns(ds, self.k))


class EncEvalGMMFisherVectorEstimator(ScalaGMMFisherVectorEstimator):
    """Counterpart of the reference's native enceval estimator
    (``external/FisherVector.scala:17-55``): the same GMM fit and FV
    math under the reference's native name."""


class GMMFisherVectorEstimator(OptimizableEstimator):
    """Optimizable FV estimator (reference ``FisherVector.scala:85-94``,
    which picks the native implementation when k >= 32). Both choices fit
    and apply identically; without the node-level rule it fits through
    its ``default``."""

    def abstract_fit(self, dep_specs):
        return _fisher_abstract_fit(self.k)

    # -- static HBM planning (analysis.resources) --------------------------
    def fitted_nbytes(self, dep_specs):
        return _fisher_fitted_nbytes(self.k, dep_specs)

    def abstract_apply_transient(self, dep_specs):
        return _fisher_apply_transient(self.k)

    def __init__(self, k: int):
        self.k = k

    @property
    def default(self) -> Estimator:
        return ScalaGMMFisherVectorEstimator(self.k)

    def optimize(self, sample: Dataset, n: int,
                 num_machines: int) -> NodeChoice:
        if self.k >= 32:
            return NodeChoice(EncEvalGMMFisherVectorEstimator(self.k))
        return NodeChoice(ScalaGMMFisherVectorEstimator(self.k))

    def optimize_static(self, spec, n: int, num_machines: int):
        # the choice depends only on k: always statically resolvable
        return self.optimize(None, n, num_machines)
