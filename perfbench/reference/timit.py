"""The TIMIT pipeline's fit and scores, in plain PyTorch and NumPy.

``TimitPipeline.scala:48-110``: ``num_cosines`` branches of random
cosine features ``cos(x W_i^T + b_i)``, each W_i (features, 440) of
standard normals times ``gamma`` and b_i uniform on [0, 2 pi), drawn
from ``numpy.random.RandomState(seed + i)`` in that order and held in
float32; the branches concatenated; ``BlockLeastSquaresEstimator`` with
one block per branch width, ``num_epochs`` passes, ``lam``; the class
the argmax of the scores. The (n, 204,800) feature matrix is never
held: each block is computed again from the frames when it is needed.
"""
from __future__ import annotations

import numpy as np
import torch

from . import block_ridge, indicators


def cosine_params(seed: int, num_cosines: int, width: int, dim: int,
                  gamma: float):
    """Each branch's (W, b) as float32 numpy arrays."""
    out = []
    for i in range(num_cosines):
        rng = np.random.RandomState(seed + i)
        W = (rng.randn(width, dim) * gamma).astype(np.float32)
        b = (rng.rand(width) * 2 * np.pi).astype(np.float32)
        out.append((W, b))
    return out


def _branch(X, params, i, dtype):
    W, b = params[i]
    W = torch.as_tensor(W, device=X.device).to(dtype)
    b = torch.as_tensor(b, device=X.device).to(dtype)
    return torch.cos(X @ W.T + b)


def fit(v, frames, labels, params, dtype):
    """``(x_means, Ws, y_mean)``: each block's feature means and weights,
    and the labels' means."""
    X = frames.to(dtype)
    Y = indicators(labels, v["num_classes"], dtype)
    y_mean = Y.mean(dim=0)
    Y -= y_mean
    x_means = [_branch(X, params, i, dtype).mean(dim=0)
               for i in range(len(params))]
    Ws = block_ridge(lambda i: _branch(X, params, i, dtype) - x_means[i],
                     [p[0].shape[0] for p in params], Y, float(v["lam"]),
                     v["num_epochs"])
    return x_means, Ws, y_mean


def scores(model, frames, params, dtype):
    """(n, classes) scores of ``frames`` under a model from :func:`fit`."""
    x_means, Ws, y_mean = model
    X = frames.to(dtype)
    out = y_mean.expand(X.shape[0], -1).clone()
    for i, W in enumerate(Ws):
        out += (_branch(X, params, i, dtype) - x_means[i]) @ W
    return out
