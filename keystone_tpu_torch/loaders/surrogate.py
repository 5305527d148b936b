"""Surrogate data made from a seed: CIFAR and MNIST shapes, and VOC
image sizes.

``make_surrogate_cifar`` is a copy of ``bench.py::make_surrogate_cifar``
in the repository root, so the port and its chip check have data without
importing ``bench.py``; a test holds the two bit-identical.
``make_surrogate_voc`` is the port's copy of the image generator of
``bench.py::voc_bench``, made at VOC2007's image sizes, and
``make_surrogate_mnist`` the copy of ``bench.py::mnist_bench``'s and
``make_surrogate_timit`` of ``bench.py::timit_bench``'s.
"""
from __future__ import annotations

import numpy as np

from ..parallel.dataset import HostDataset
from .image_loader_utils import MultiLabeledImage

#: VOC2007's two common image sizes, (height, width): landscape, portrait
VOC_SIZES = ((375, 500), (500, 375))


def make_surrogate_cifar(n_train, n_test, seed=0):
    """Discriminative surrogate at CIFAR shapes, the honest stand-in
    when the real dataset is absent (zero-egress image); flagged in the
    metric line.

    Built so featurization quality is what the accuracy measures: the
    10 classes come in 5 pairs SHARING a smooth low-frequency base (so
    raw-pixel linear models confuse the pair) and differing in
    high-frequency texture (what whitened random patch filters pick
    up). Images are shifted crops with gain jitter + heavy noise."""
    rng = np.random.RandomState(seed)
    smooth = rng.rand(5, 48, 48, 3).astype(np.float32)
    for _ in range(6):
        smooth = (smooth + np.roll(smooth, 1, 1) + np.roll(smooth, 1, 2)
                  + np.roll(smooth, -1, 1) + np.roll(smooth, -1, 2)) / 5.0
    def sharpen(t):
        return t - (np.roll(t, 1, 1) + np.roll(t, 1, 2)
                    + np.roll(t, -1, 1) + np.roll(t, -1, 2)) / 4.0

    # pair members share MOST of their texture too: only the 0.45-scaled
    # class-specific component separates them, so the task sits in an
    # informative error range (a numerics regression in featurization
    # visibly moves the metric) instead of saturating at 0
    shared = sharpen(rng.rand(5, 48, 48, 3).astype(np.float32))
    own = sharpen(rng.rand(10, 48, 48, 3).astype(np.float32))
    texture = shared[np.arange(10) // 2] + 0.45 * own
    base = smooth[np.arange(10) // 2] + 0.9 * texture
    base = (base - base.min()) / (base.max() - base.min()) * 255.0

    def split(n, r, off):
        # train and test crop from DISJOINT offset ranges, so test
        # accuracy requires the shift-invariance the conv+pool
        # featurizer provides (and raw pixels lack) — not memorization
        # of a finite crop set
        y = r.randint(0, 10, n)
        dx, dy = off + r.randint(0, 8, n), off + r.randint(0, 8, n)
        imgs = np.empty((n, 32, 32, 3), np.float32)
        for i in range(n):
            crop = base[y[i], dy[i]:dy[i] + 32, dx[i]:dx[i] + 32]
            gain = 0.7 + 0.6 * r.rand()
            imgs[i] = np.clip(
                crop * gain + 24.0 * r.randn(32, 32, 3), 0, 255)
        return imgs, y

    tr = split(n_train, np.random.RandomState(seed + 1), 0)
    te = split(n_test, np.random.RandomState(seed + 2), 8)
    return tr, te


def make_surrogate_voc(n_train, n_test, seed=0, num_classes=20,
                       sizes=VOC_SIZES):
    """Multi-label surrogate at VOC image sizes, the stand-in while VOC2007
    is absent: each image codes 1-2 of ``num_classes`` classes as oriented
    sinusoidal stripes (class c at angle pi c / num_classes) over uniform
    noise, in [0, 255], as ``bench.py::voc_bench`` makes them. In each
    split a seeded half of the images is ``sizes[0]`` and the rest
    ``sizes[1]``, so the images are ragged and both orientations of the
    band operators are used. Returns two HostDatasets of
    MultiLabeledImage (float32 (H, W, 3) images)."""
    grids = {hw: np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
             for hw in sizes}

    def split(n, r):
        second = np.zeros(n, bool)
        second[r.permutation(n)[:n - n // 2]] = True
        items = []
        for i in range(n):
            h, w = sizes[int(second[i])]
            yy, xx = grids[(h, w)]
            labels = sorted(set(r.randint(0, num_classes, r.randint(1, 3))))
            img = r.rand(h, w, 3).astype(np.float32) * 160
            for c in labels:
                ang = np.pi * c / num_classes
                stripes = np.sin((np.cos(ang) * xx + np.sin(ang) * yy)
                                 / 2.5)
                img += 45.0 * stripes[:, :, None]
            items.append(MultiLabeledImage(
                np.clip(img, 0, 255), [int(c) for c in labels],
                f"im{i}.jpg"))
        return HostDataset(items)

    return (split(n_train, np.random.RandomState(seed + 1)),
            split(n_test, np.random.RandomState(seed + 2)))


def make_surrogate_mnist(n_train, n_test):
    """MNIST-shaped surrogate, as ``bench.py::mnist_bench`` makes it: 10
    class prototypes at 0.5 + 0.05 N(0, 1) per pixel (seed 0), each image
    its class's prototype plus 0.35 N(0, 1) noise, clipped to [0, 1];
    train from seed 1, test from seed 2. Returns ``((X_train, y_train),
    (X_test, y_test))``: float32 (n, 784) images and int labels."""
    rng = np.random.RandomState(0)
    protos = (0.5 + 0.05 * rng.randn(10, 784)).astype(np.float32)

    def split(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, 10, n)
        X = np.clip(protos[y] + 0.35 * r.randn(n, 784), 0, 1).astype(
            np.float32)
        return X, y.astype(np.int32)

    return split(n_train, 1), split(n_test, 2)


def make_surrogate_timit(n_train, n_test):
    """TIMIT-shaped surrogate, as ``bench.py::timit_bench`` makes it: 147
    class prototypes ``RandomState(0).randn(147, 440)``, each frame its
    class's prototype plus 4.0 N(0, 1) noise (genuine class overlap, so
    the test error cannot saturate at 0); train from seed 1, test from
    seed 2. Returns ``((X_train, y_train), (X_test, y_test))``: float32
    (n, 440) frames and int labels."""
    k, d = 147, 440
    rng = np.random.RandomState(0)
    protos = rng.randn(k, d).astype(np.float32)

    def split(n, seed):
        r = np.random.RandomState(seed)
        y = r.randint(0, k, n)
        X = (protos[y] + 4.0 * r.randn(n, d)).astype(np.float32)
        return X, y.astype(np.int32)

    return split(n_train, 1), split(n_test, 2)
