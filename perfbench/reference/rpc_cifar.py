"""RandomPatchCifar's fit and scores, in plain PyTorch.

The pipeline of ``RandomPatchCifar.scala:58-75`` after its filter
learning: featurize (``reference/featurize.py``), ``StandardScaler``
(column means and unbiased standard deviations, a degenerate one
replaced by 1), then ``BlockLeastSquaresEstimator(block, passes, lam)``
on the +-1 class indicators: features and labels centered by their
means, block coordinate descent (``reference.block_ridge``), and the
intercept the labels' means. Scores are ``((x - mean) / std - x_mean) W
+ y_mean``; the class is their argmax (``MaxClassifier``).
"""
from __future__ import annotations

import torch

from . import block_ridge, indicators
from .featurize import featurize_rows

#: images a featurize block holds: its (rows, 27, 27, 1024) float64
#: intermediates stay near 1.5 GB each
ROWS = 250


def _features(v, images, filters, means, dtype):
    return featurize_rows(images, filters, means, dtype, ROWS,
                          patch=v["patch_size"], pool_stride=v["pool_stride"],
                          pool_size=v["pool_size"], alpha=v["alpha"])


def fit(v, images, labels, filters, means, dtype):
    """The fitted model's tensors ``(mean, std, x_mean, W, y_mean)`` from
    the training ``images`` (n, 32, 32, 3) and int ``labels``; ``filters``
    and ``means`` are the filter bank and the whitener's means."""
    X = _features(v, images, filters, means, dtype)
    n = X.shape[0]
    mean = X.mean(dim=0)
    X -= mean
    std = torch.sqrt((X * X).sum(dim=0) / max(n - 1, 1))
    std = torch.where(torch.isfinite(std) & (std >= 1e-12), std,
                      torch.ones_like(std))
    X /= std
    x_mean = X.mean(dim=0)
    X -= x_mean
    Y = indicators(labels, v["num_classes"], dtype)
    y_mean = Y.mean(dim=0)
    Y -= y_mean
    d, bs = X.shape[1], v["block_size"]
    bounds = [(lo, min(d, lo + bs)) for lo in range(0, d, bs)]
    Ws = block_ridge(lambda b: X[:, bounds[b][0]:bounds[b][1]],
                     [hi - lo for lo, hi in bounds], Y, float(v["lam"]),
                     v["num_iter"])
    return mean, std, x_mean, torch.cat(Ws), y_mean


def scores(v, model, images, filters, means, dtype):
    """(n, classes) scores of ``images`` under a model from :func:`fit`."""
    mean, std, x_mean, W, y_mean = model
    X = _features(v, images, filters, means, dtype)
    return ((X - mean) / std - x_mean) @ W + y_mean
