"""Carry fitted parameters across from the JAX package.

``from_reference_arrays`` builds the port's fitted RandomPatchCifar
pipeline from parameters given as numpy arrays, as a model fitted by the
JAX package holds them:

* ``filters`` (K, S*S*C), the whitened filter bank, and optionally
  ``whitener_means`` (S*S*C,) and the ``whitener`` matrix;
* ``scaler_mean`` and ``scaler_std`` (D,), the StandardScaler's model;
* ``weights`` (D, k), ``feature_means`` (D,) and ``intercept`` (k,), the
  block least-squares model (split into ``block_size``-row blocks).

``quantized_mapper`` carries a quantized linear model across: the JAX
package's quantized params ``(Wq, scale, mean, inv_std, b)``, or a
JAX-fitted mapper with a ``weight_dtype``, become the port's mapper
holding the same ``Wq`` and ``scale`` bit for bit.

``solver_model`` carries the model a spliced least-squares solver fits:
a JAX ``LinearMapper`` (exact or dense L-BFGS: weights, intercept and
the feature scaler's mean and std), ``BlockLinearMapper`` (block
weights, block size, intercept, feature means) or ``SparseLinearMapper``
(weights, intercept) becomes the port's model of the same class, its
arrays copied as float32.

``cosine_random_features``, ``timit_pipeline`` and
``random_cifar_pipeline`` carry the random-feature apps across: a
cosine branch from its ``W`` (out, in) and ``b`` (out,); the fitted
TIMIT pipeline from its branches' ``(W, b)`` and its fitted JAX
``BlockLinearMapper``; the fitted RandomCifar pipeline from its filter
bank, its scaler's ``mean`` and ``std`` and its fitted JAX
``LinearMapper``.

``pca_transformer`` and ``fisher_vector`` carry VOCSIFTFisher's fitted
column PCA (``pca_mat`` (d, dims)) and GMM codebook (``means`` and
``variances`` (D, K), ``weights`` (K,), ``weight_threshold``) across as
numpy arrays into the port's ``BatchPCATransformer`` and
``FisherVector``.

``imagenet_pipeline`` carries a fitted ImageNetSiftLcsFV across: each
branch's ``pca_mat`` and GMM (an object with ``means``, ``variances``,
``weights`` and optionally ``weight_threshold``, such as the JAX
``GaussianMixtureModel``), and the fitted weighted solver's model, a JAX
``BlockLinearMapper`` (block weights and intercept, through
``solver_model``).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .nodes.images.core import (
    Convolver,
    GrayScaler,
    PixelScaler,
    FusedConvRectifyPool,
    ImageVectorizer,
    Pooler,
    SymmetricRectifier,
)
from .nodes.images.extractors import LCSExtractor, SIFTExtractor
from .nodes.images.fisher_vector import FisherVector
from .nodes.learning.gmm import GaussianMixtureModel
from .nodes.learning.classifiers import SparseLinearMapper
from .nodes.learning.linear import BlockLinearMapper, LinearMapper
from .nodes.learning.pca import BatchPCATransformer
from .nodes.learning.zca import ZCAWhitener
from .nodes.stats import (
    BatchSignedHellingerMapper,
    CosineRandomFeatures,
    NormalizeRows,
    SignedHellingerMapper,
    StandardScalerModel,
)
from .nodes.util import (
    FloatToDouble,
    MatrixVectorizer,
    MaxClassifier,
    TopKClassifier,
    VectorCombiner,
)
from .ops.device import DEFAULT_DEVICE, resolve_device
from .pipelines.images.cifar import random_cifar
from .pipelines.images.imagenet.sift_lcs_fv import ImageNetSiftLcsFVConfig
from .pipelines.images.cifar.random_patch_cifar import (
    IMAGE_SIZE,
    NUM_CHANNELS,
    RandomCifarConfig,
)
from .workflow.pipeline import FittedPipeline, Pipeline


def whitener_from_arrays(means: np.ndarray,
                         whitener: Optional[np.ndarray] = None) -> ZCAWhitener:
    """The port's ZCA whitener from a reference whitener's means (F,) and
    matrix (F, F), the identity when the matrix is absent. The fused
    featurizer reads only the means."""
    means = np.array(means, np.float32)
    if whitener is None:
        whitener = np.eye(means.shape[0], dtype=np.float32)
    return ZCAWhitener(np.array(whitener, np.float32), means)


def from_reference_arrays(d: Dict[str, np.ndarray], device=DEFAULT_DEVICE,
                          config: Optional[RandomCifarConfig] = None,
                          block_size: int = 4096) -> FittedPipeline:
    """The fitted RandomPatchCifar pipeline (featurize -> scale -> block
    linear model -> argmax) with its fitted tensors on ``device``."""
    dev = resolve_device(device)
    config = config or RandomCifarConfig()
    filters = np.asarray(d["filters"], np.float32)
    whitener = None
    if d.get("whitener_means") is not None:
        whitener = whitener_from_arrays(d["whitener_means"], d.get("whitener"))

    def on(key):
        v = d.get(key)
        return None if v is None else torch.as_tensor(
            np.array(v, np.float32), device=dev)

    weights = on("weights")
    blocks = list(torch.split(weights, block_size, dim=0))
    chain = (
        FusedConvRectifyPool(filters, IMAGE_SIZE, config.patch_size,
                             NUM_CHANNELS, config.pool_stride,
                             config.pool_size, config.alpha,
                             whitener=whitener)
        >> StandardScalerModel(np.asarray(d["scaler_mean"], np.float32),
                               None if d.get("scaler_std") is None else
                               np.asarray(d["scaler_std"], np.float32))
        >> BlockLinearMapper(blocks, block_size, intercept=on("intercept"),
                             feature_means=on("feature_means"))
        >> MaxClassifier()
    )
    return _as_fitted(chain)


def _as_fitted(chain: Pipeline) -> FittedPipeline:
    """The chain as a fitted pipeline of one node a stage, as a fit leaves
    the stages it fitted (each apply fuses the chain)."""
    return FittedPipeline(chain.graph, chain._source, chain._sink)


def _weight_bits(Wq) -> torch.Tensor:
    """A (d, k) bfloat16 or int8 weight array as a host tensor with the
    same bits. A bfloat16 numpy array (the ``ml_dtypes`` type that
    ``np.asarray`` of a JAX array gives) is read through its 16-bit
    pattern, so no conversion can round it."""
    if isinstance(Wq, torch.Tensor):
        return Wq.detach().cpu()
    a = np.asarray(Wq)
    if a.dtype == np.int8:
        return torch.from_numpy(a.copy())
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    raise ValueError(f"quantized weights are {a.dtype}; bfloat16 or int8 "
                     "are taken")


def quantized_mapper(source, device=DEFAULT_DEVICE):
    """The port's quantized mapper from the JAX package's quantized
    params ``(Wq, scale, mean, inv_std, b)`` (arrays), or from a JAX
    mapper fitted with a ``weight_dtype`` (its ``apply_params()``). The
    mapper applies exactly the given ``Wq`` and ``scale`` (its
    ``quantized`` pair) and stores their float32 dequantization as its
    weights. A BlockLinearMapper when ``inv_std`` is all ones (the JAX
    BlockLinearMapper's params), else a LinearMapper whose scaler
    reproduces ``inv_std``. Its params are staged on ``device``."""
    dev = resolve_device(device)
    if hasattr(source, "apply_params") and hasattr(source, "weight_dtype"):
        if source.weight_dtype is None:
            raise ValueError("the mapper has no weight_dtype: carry a "
                             "float32 model with from_reference_arrays")
        source = source.apply_params()
    Wq, scale, mean, inv_std, b = source
    Wq = _weight_bits(Wq)
    weight_dtype = "int8" if Wq.dtype == torch.int8 else "bf16"
    scale = torch.as_tensor(np.array(scale, np.float32))
    mean, inv_std, b = (np.array(v, np.float32) for v in (mean, inv_std, b))
    W = Wq.to(torch.float32) * scale[None, :]
    if np.all(inv_std == 1.0):
        mapper = BlockLinearMapper([W], W.shape[0], intercept=b,
                                   feature_means=mean,
                                   weight_dtype=weight_dtype,
                                   quantized=(Wq, scale))
    else:
        # the mapper takes inv_std = 1 / std; a float64 std makes that
        # reciprocal land back on the given float32 inv_std
        std = 1.0 / inv_std.astype(np.float64)
        mapper = LinearMapper(W, intercept=b,
                              feature_scaler=StandardScalerModel(mean, std),
                              weight_dtype=weight_dtype,
                              quantized=(Wq, scale))
    mapper.apply_params(dev)
    return mapper


def pca_transformer(pca_mat: np.ndarray) -> BatchPCATransformer:
    """The port's per-item column projection from a fitted (d, dims) PCA
    matrix (the JAX ``BatchPCATransformer.pca_mat``)."""
    return BatchPCATransformer(np.array(pca_mat, np.float32))


def fisher_vector(means: np.ndarray, variances: np.ndarray,
                  weights: np.ndarray,
                  weight_threshold: float = 1e-4) -> FisherVector:
    """The port's Fisher-vector encoder from a fitted diagonal GMM: means
    and variances (D, K), weights (K,), as the JAX package's
    ``GaussianMixtureModel`` stores them."""
    return FisherVector(GaussianMixtureModel(
        np.array(means, np.float32), np.array(variances, np.float32),
        np.array(weights, np.float32), float(weight_threshold)))


def solver_model(model, device=DEFAULT_DEVICE):
    """The port's counterpart of a fitted JAX least-squares model (read by
    its attributes, see the module docstring), its params staged on
    ``device``."""
    dev = resolve_device(device)

    def f32(v):
        return None if v is None else np.array(v, np.float32)

    kind = type(model).__name__
    if kind == "SparseLinearMapper":
        out = SparseLinearMapper(torch.as_tensor(f32(model.weights),
                                                 device=dev),
                                 f32(model.intercept))
    elif kind == "BlockLinearMapper":
        out = BlockLinearMapper([f32(w) for w in model.block_weights],
                                model.block_size,
                                intercept=f32(model.intercept),
                                feature_means=f32(model.feature_means))
    elif kind == "LinearMapper":
        s = model.feature_scaler
        scaler = None if s is None else StandardScalerModel(
            f32(s.mean), f32(getattr(s, "std", None)))
        out = LinearMapper(f32(model.weights), intercept=f32(model.intercept),
                           feature_scaler=scaler)
    else:
        raise TypeError(f"no port counterpart for a fitted {kind}")
    out.apply_params(dev)
    return out


def cosine_random_features(W: np.ndarray,
                           b: np.ndarray) -> CosineRandomFeatures:
    """The port's cosine branch with the given W (out, in) and b (out,)."""
    return CosineRandomFeatures(np.array(W, np.float32),
                                np.array(b, np.float32))


def timit_pipeline(branches: Sequence[Tuple[np.ndarray, np.ndarray]], model,
                   device=DEFAULT_DEVICE) -> FittedPipeline:
    """The fitted TIMIT pipeline (gathered cosine branches ->
    VectorCombiner -> block linear model -> argmax) from each branch's
    ``(W, b)`` and the fitted JAX ``BlockLinearMapper``, its params on
    ``device``."""
    feats = Pipeline.gather([cosine_random_features(W, b)
                             for W, b in branches])
    return _as_fitted(feats >> VectorCombiner()
                      >> solver_model(model, device) >> MaxClassifier())


def random_cifar_pipeline(filters: np.ndarray, scaler_mean: np.ndarray,
                          scaler_std: Optional[np.ndarray], model,
                          config: Optional[
                              random_cifar.RandomCifarConfig] = None,
                          device=DEFAULT_DEVICE) -> FittedPipeline:
    """The fitted RandomCifar pipeline (convolve, rectify, pool,
    vectorize -> scale -> linear model -> argmax) from its filter bank,
    its scaler's moments and the fitted JAX ``LinearMapper``, its params
    on ``device``."""
    config = config or random_cifar.RandomCifarConfig()
    size, chans = random_cifar.IMAGE_SIZE, random_cifar.NUM_CHANNELS
    chain = (
        Convolver(np.array(filters, np.float32), size, size, chans,
                  whitener=None, normalize_patches=True)
        >> SymmetricRectifier(alpha=config.alpha)
        >> Pooler(config.pool_stride, config.pool_size, "identity", "sum")
        >> ImageVectorizer()
        >> StandardScalerModel(np.array(scaler_mean, np.float32),
                               None if scaler_std is None
                               else np.array(scaler_std, np.float32))
        >> solver_model(model, device)
        >> MaxClassifier()
    )
    return _as_fitted(chain)


def imagenet_pipeline(sift_branch, lcs_branch, model,
                      config: Optional[ImageNetSiftLcsFVConfig] = None,
                      top_k: int = 5, sift_kwargs: Optional[dict] = None,
                      device=DEFAULT_DEVICE) -> FittedPipeline:
    """The fitted ImageNetSiftLcsFV predictor (the SIFT and LCS branches,
    each PCA -> Fisher vector -> normalizations, gathered and combined ->
    the weighted solver's linear model -> top-k) from each branch's
    ``(pca_mat, gmm)`` and the fitted JAX model, its params on
    ``device``."""
    config = config or ImageNetSiftLcsFVConfig()

    def suffix(pca_mat, gmm):
        return (pca_transformer(pca_mat)
                >> fisher_vector(gmm.means, gmm.variances, gmm.weights,
                                 getattr(gmm, "weight_threshold", 1e-4))
                >> FloatToDouble() >> MatrixVectorizer() >> NormalizeRows()
                >> SignedHellingerMapper() >> NormalizeRows())

    sift = (PixelScaler() >> GrayScaler()
            >> SIFTExtractor(scale_step=config.sift_scale_step,
                             **(sift_kwargs or {}))
            >> BatchSignedHellingerMapper() >> suffix(*sift_branch))
    lcs = LCSExtractor(config.lcs_stride, config.lcs_border,
                       config.lcs_patch) >> suffix(*lcs_branch)
    return _as_fitted(Pipeline.gather([sift, lcs]) >> VectorCombiner()
                      >> solver_model(model, device) >> TopKClassifier(top_k))
