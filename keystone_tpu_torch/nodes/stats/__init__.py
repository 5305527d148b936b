"""Statistical feature nodes.

Counterpart of the scaler, the row normalizer, the signed Hellinger
maps, the random-FFT nodes and the random cosine features of
``keystone_tpu/nodes/stats/__init__.py`` (reference
``stats/StandardScaler.scala``, ``NormalizeRows.scala``,
``SignedHellingerMapper.scala``, ``RandomSignNode.scala``,
``PaddedFFT.scala``, ``LinearRectifier.scala``,
``CosineRandomFeatures.scala``), and the text path's host stage
``TermFrequency`` (``stats/TermFrequency.scala``). Each numeric node's
batch form is one tensor function over the batch on its device.
"""
from __future__ import annotations

import numpy as np
import torch

from ...parallel.dataset import ArrayDataset, Dataset
from ...utils.donation import donates_carry
from ...workflow.estimator import Estimator
from ...workflow.operators import tensor_token
from ...workflow.transformer import HostTransformer, Transformer

EPS = 2.2e-16  # the reference's floor on a row norm


class RandomSignNode(Transformer):
    """Elementwise multiply by a fixed +-1 vector
    (reference ``stats/RandomSignNode.scala:11-23``)."""

    def __init__(self, signs: np.ndarray):
        self.signs = np.asarray(signs, dtype=np.float32)

    @staticmethod
    def create(size: int, seed: int = 0) -> "RandomSignNode":
        rng = np.random.RandomState(seed)
        return RandomSignNode(2.0 * rng.randint(0, 2, size=size) - 1.0)

    def apply_params(self, device):
        return self._params_on(device, lambda d: torch.as_tensor(
            self.signs, device=d))

    def apply(self, x):
        return x * self.apply_params(x.device)

    def apply_batch(self, X):
        return self.apply(X)


class PaddedFFT(Transformer):
    """Zero-pad to the next power of two, FFT, keep the real part of the
    first half (reference ``stats/PaddedFFT.scala:13-20``), through
    ``torch.fft.rfft``, whose bins 0 .. N/2 are the full FFT's."""

    def apply(self, x):
        n = x.shape[-1]
        padded = 1 << (n - 1).bit_length()
        return torch.fft.rfft(x, n=padded).real[..., :padded // 2].to(
            x.dtype)

    def apply_batch(self, X):
        return self.apply(X)


class LinearRectifier(Transformer):
    """f(x) = max(max_val, x - alpha)
    (reference ``stats/LinearRectifier.scala:12-17``)."""

    def __init__(self, max_val: float = 0.0, alpha: float = 0.0):
        self.max_val = float(max_val)
        self.alpha = float(alpha)

    def apply(self, x):
        return torch.clamp_min(x - self.alpha, self.max_val)

    def apply_batch(self, X):
        return self.apply(X)


class CosineRandomFeatures(Transformer):
    """Random Fourier features cos(x W^T + b) (reference
    ``stats/CosineRandomFeatures.scala:19-60``): W (out, in), b (out,),
    float32. Both paths are one ``torch.matmul`` and a cosine on the
    input's device, the params staged there once."""

    def __init__(self, W: np.ndarray, b: np.ndarray):
        self.W = np.asarray(W, dtype=np.float32)
        self.b = np.asarray(b, dtype=np.float32)
        assert self.b.shape[0] == self.W.shape[0]

    @staticmethod
    def create(num_input_features: int, num_output_features: int,
               gamma: float, w_dist: str = "gaussian",
               b_dist: str = "uniform",
               seed: int = 0) -> "CosineRandomFeatures":
        """W from ``w_dist`` scaled by ``gamma``, b from ``b_dist`` scaled
        by 2 pi: the JAX package's ``RandomState(seed)`` draws, in its
        order."""
        rng = np.random.RandomState(seed)
        if w_dist == "gaussian":
            W = rng.randn(num_output_features, num_input_features)
        elif w_dist == "cauchy":
            W = rng.standard_cauchy((num_output_features, num_input_features))
        elif w_dist == "uniform":
            W = rng.rand(num_output_features, num_input_features)
        else:
            raise ValueError(w_dist)
        W = W * gamma
        if b_dist == "uniform":
            b = rng.rand(num_output_features) * 2 * np.pi
        elif b_dist == "gaussian":
            b = rng.randn(num_output_features) * 2 * np.pi
        else:
            raise ValueError(b_dist)
        return CosineRandomFeatures(W, b)

    def eq_key(self):
        return (CosineRandomFeatures, tensor_token(self.W),
                tensor_token(self.b))

    def apply_params(self, device):
        return self._params_on(device, lambda d: (
            torch.as_tensor(self.W, device=d),
            torch.as_tensor(self.b, device=d)))

    def apply_with_params(self, params, x):
        W, b = params
        return torch.cos(torch.matmul(x, W.T) + b)

    def apply(self, x):
        return self.apply_with_params(self.apply_params(x.device), x)

    def apply_batch(self, X):
        return self.apply(X)


class NormalizeRows(Transformer):
    """L2-normalize each vector, flooring the norm at machine epsilon
    (reference ``stats/NormalizeRows.scala:8-14``)."""

    def apply(self, x):
        return x / torch.clamp_min(torch.linalg.vector_norm(x), EPS)

    def apply_batch(self, X):
        norms = torch.linalg.vector_norm(X, dim=1, keepdim=True)
        return X / torch.clamp_min(norms, EPS)


class SignedHellingerMapper(Transformer):
    """sign(x) * sqrt(|x|) (reference
    ``stats/SignedHellingerMapper.scala``)."""

    def apply(self, x):
        return torch.sign(x) * torch.sqrt(torch.abs(x))

    def apply_batch(self, X):
        return self.apply(X)


class BatchSignedHellingerMapper(SignedHellingerMapper):
    """Matrix-input variant (applied to per-image descriptor matrices)."""


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

    The column sums and sums of squares are reductions on the device,
    folded chunk by chunk into a carry by ``accumulate`` (a streamed
    fit), of which the resident ``_fit`` is the one-chunk case. The
    moments are finished on the host in float64 by ``finalize``, as in
    the JAX package. Degenerate stds (NaN/inf/<eps) are replaced by 1.0,
    as in the reference.
    """

    def abstract_fit(self, dep_specs):
        from ...analysis.spec import identity_fit

        return identity_fit(dep_specs)

    # -- static HBM planning (analysis.resources) --------------------------
    def carry_nbytes(self, dep_specs):
        from ...analysis.resources import moments_carry_nbytes

        return moments_carry_nbytes(dep_specs)

    def fitted_nbytes(self, dep_specs):
        from ...analysis.resources import moments_carry_nbytes

        # the fitted model (mean + std) has the moment carry's footprint
        return moments_carry_nbytes(dep_specs)

    def __init__(self, normalize_std_dev: bool = True, eps: float = 1e-12):
        self.normalize_std_dev = normalize_std_dev
        self.eps = eps

    def _fit(self, ds: Dataset) -> StandardScalerModel:
        carry = self.accumulate(None, ds)
        mesh = getattr(ds, "mesh", None)
        if mesh is not None:
            # rank-sharded rows: the sums and the count add over the data
            # group, in rank order
            from ...parallel.distributed import world_scalar_sum, world_sum

            S, SQ, n = carry
            carry = (world_sum(S, mesh), world_sum(SQ, mesh),
                     int(world_scalar_sum(n, mesh)))
        return self.finalize(carry)

    # -- streaming fit (accumulate/finalize protocol) ----------------------
    @donates_carry(1, probe=lambda: _moments_carry_probe())
    def accumulate(self, carry, chunk):
        """Fold one chunk's column sums and sums of squares into the
        ``(S, SQ, n)`` carry, in place. Padded rows are zero, so the
        moments stay exact; integer chunks are promoted to float32 so a
        uint8 chunk's squares do not wrap."""
        if not isinstance(chunk, ArrayDataset):
            raise TypeError("StandardScaler needs array data or array "
                            "chunks")
        X = chunk.data
        if not torch.is_floating_point(X):
            X = X.to(torch.float32)
        if carry is None:
            zeros = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
            carry = (zeros, zeros.clone(), 0)
        S, SQ, n = carry
        S += X.sum(dim=0)
        SQ += (X * X).sum(dim=0)
        return (S, SQ, n + chunk.n)

    def finalize(self, carry) -> StandardScalerModel:
        s, sq, n = carry
        mean = s.cpu().numpy().astype(np.float64) / n
        if not self.normalize_std_dev:
            return StandardScalerModel(mean.astype(np.float32))
        # unbiased sample variance, matching MultivariateOnlineSummarizer
        var = (sq.cpu().numpy().astype(np.float64) - n * mean * mean) / max(
            n - 1, 1)
        std = np.sqrt(np.maximum(var, 0.0))
        bad = ~np.isfinite(std) | (np.abs(std) < self.eps)
        std = np.where(bad, 1.0, std)
        return StandardScalerModel(mean.astype(np.float32),
                                   std.astype(np.float32))


def _moments_carry_probe():
    """``StandardScaler.accumulate``'s arguments on the meta device: the
    estimator, an ``(S, SQ, n)`` carry and a chunk."""
    n, d = 8, 6
    S = torch.empty(d, dtype=torch.float32, device="meta")
    chunk = ArrayDataset(torch.empty(n, d, dtype=torch.float32,
                                     device="meta"), n)
    return (StandardScaler(), (S, torch.empty_like(S), 0), chunk), {}


class TermFrequency(HostTransformer):
    """Sequence of terms -> (unique term, weighting(count)) pairs in
    order of first appearance (reference ``stats/TermFrequency.scala:20-22``).
    A host stage; list terms are keyed as tuples."""

    def __init__(self, fun=None):
        self.fun = fun or (lambda x: x)

    def eq_key(self):
        return (TermFrequency, self.fun)

    def apply(self, terms):
        counts = {}
        for t in terms:
            key = tuple(t) if isinstance(t, list) else t
            counts[key] = counts.get(key, 0) + 1
        return [(k, float(self.fun(c))) for k, c in counts.items()]
