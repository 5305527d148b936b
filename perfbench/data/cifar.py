"""Surrogate CIFAR-10 images and RandomPatchCifar's filter inputs.

``images`` is a frozen, vectorised copy of
``keystone_tpu_torch/loaders/surrogate.py::make_surrogate_cifar`` (itself
a copy of ``bench.py::make_surrogate_cifar``): the same construction,
drawn in torch on the device from the run's seed instead of one image at
a time from numpy, so 50,000 images cost milliseconds of set-up. Ten
classes in five pairs share a smooth base and differ in texture; an
image is a shifted 32 x 32 crop of its class's 48 x 48 base, with gain
jitter and heavy noise, clipped to [0, 255]. Training sets crop from
offsets 0-7 and the test set from 8-15.

``filters`` makes the whitener and the filter bank that
``random_patch_cifar.learn_filters`` would learn (the reference's
``RandomPatchCifar.scala:41-57``), by this benchmark's own plain ZCA:
random 6 x 6 x 3 windows of a training set, normalized per row, a ZCA
whitener (epsilon 0.1) from their covariance, and ``num_filters`` of
the normalized windows whitened, unit-normed and whitened back.
"""
from __future__ import annotations

import numpy as np
import torch

from . import generator

NUM_CLASSES = 10
STREAM_BASE, STREAM_TEST, STREAM_FILTERS = 0, 1, 2
STREAM_TRAIN0 = 16


def _base(seed: int, device) -> torch.Tensor:
    """The ten classes' 48 x 48 x 3 bases in [0, 255]."""
    g = generator(seed, STREAM_BASE, device)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=device,
                          dtype=torch.float32)

    def neighbours(t):
        return (torch.roll(t, 1, 1) + torch.roll(t, 1, 2)
                + torch.roll(t, -1, 1) + torch.roll(t, -1, 2))

    smooth = rand(5, 48, 48, 3)
    for _ in range(6):
        smooth = (smooth + neighbours(smooth)) / 5.0
    shared = rand(5, 48, 48, 3)
    shared = shared - neighbours(shared) / 4.0
    own = rand(10, 48, 48, 3)
    own = own - neighbours(own) / 4.0
    pair = torch.arange(10, device=device) // 2
    texture = shared[pair] + 0.45 * own
    base = smooth[pair] + 0.9 * texture
    return (base - base.min()) / (base.max() - base.min()) * 255.0


def _split(base: torch.Tensor, n: int, offset: int, g: torch.Generator):
    dev = base.device
    y = torch.randint(0, NUM_CLASSES, (n,), generator=g, device=dev)
    dx = offset + torch.randint(0, 8, (n,), generator=g, device=dev)
    dy = offset + torch.randint(0, 8, (n,), generator=g, device=dev)
    gain = 0.7 + 0.6 * torch.rand(n, generator=g, device=dev)
    ar = torch.arange(32, device=dev)
    rows = (dy[:, None] + ar)[:, :, None]
    cols = (dx[:, None] + ar)[:, None, :]
    crops = base[y[:, None, None], rows, cols]
    noise = torch.randn((n, 32, 32, 3), generator=g, device=dev)
    imgs = (crops * gain[:, None, None, None] + 24.0 * noise).clamp_(0, 255)
    return imgs.contiguous(), y.to(torch.int32)


def images(seed: int, n_train: int, n_test: int, train_sets: int, device):
    """``train_sets`` training sets of ``n_train`` images and one test set
    of ``n_test``: a list of ``(images, labels)`` and one pair, float32
    (n, 32, 32, 3) and int32 (n,) on ``device``."""
    base = _base(seed, device)
    train = [_split(base, n_train, 0, generator(seed, STREAM_TRAIN0 + j,
                                                device))
             for j in range(train_sets)]
    test = _split(base, n_test, 8, generator(seed, STREAM_TEST, device))
    return train, test


def filters(seed: int, imgs: torch.Tensor, num_filters: int, patch: int,
            epsilon: float, samples: int, var_constant: float = 10.0):
    """``(filters, whitener, means)`` as float32 numpy arrays: filters
    (num_filters, patch * patch * C) in (dy, dx, c) order, the (F, F) ZCA
    whitener and its (F,) means, made from ``samples`` random windows of
    ``imgs`` (computed in float64)."""
    dev = imgs.device
    g = generator(seed, STREAM_FILTERS, dev)
    n, H, W, C = imgs.shape
    nh, nw = H - patch + 1, W - patch + 1
    idx = torch.randint(0, n * nh * nw, (samples,), generator=g, device=dev)
    img, win = idx // (nh * nw), idx % (nh * nw)
    ar = torch.arange(patch, device=dev)
    rows = (win // nw)[:, None] + ar
    cols = (win % nw)[:, None] + ar
    rows_ = imgs[img[:, None, None], rows[:, :, None], cols[:, None, :]]
    X = rows_.reshape(samples, -1).to(torch.float64)
    F = X.shape[1]
    X = X - X.mean(dim=1, keepdim=True)
    X = X / torch.sqrt((X * X).sum(dim=1, keepdim=True) / (F - 1.0)
                       + var_constant)
    means = X.mean(dim=0)
    Xc = X - means
    cov = Xc.T @ Xc / (samples - 1.0)
    lam, V = torch.linalg.eigh(cov)
    whitener = (V * (lam.clamp_min(0.0) + epsilon) ** -0.5) @ V.T
    pick = torch.randperm(samples, generator=g, device=dev)[:num_filters]
    unnorm = (X[pick] - means) @ whitener
    unnorm = unnorm / (unnorm.norm(dim=1, keepdim=True) + 1e-10)
    bank = unnorm @ whitener.T

    def host(t):
        return np.ascontiguousarray(t.cpu().numpy().astype(np.float32))

    return host(bank), host(whitener), host(means)
