"""Carry fitted RandomPatchCifar parameters across from the JAX package.

``from_reference_arrays`` builds the port's fitted RandomPatchCifar
pipeline from parameters given as numpy arrays, as a model fitted by the
JAX package holds them:

* ``filters`` (K, S*S*C), the whitened filter bank, and optionally
  ``whitener_means`` (S*S*C,) and the ``whitener`` matrix;
* ``scaler_mean`` and ``scaler_std`` (D,), the StandardScaler's model;
* ``weights`` (D, k), ``feature_means`` (D,) and ``intercept`` (k,), the
  block least-squares model (split into ``block_size``-row blocks).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .nodes.images.core import FusedConvRectifyPool
from .nodes.learning.linear import BlockLinearMapper
from .nodes.learning.zca import ZCAWhitener
from .nodes.stats import StandardScalerModel
from .nodes.util import MaxClassifier
from .ops.device import DEFAULT_DEVICE, resolve_device
from .pipelines.images.cifar.random_patch_cifar import (
    IMAGE_SIZE,
    NUM_CHANNELS,
    RandomCifarConfig,
)
from .workflow.pipeline import FittedPipeline


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
    return chain.fit()
