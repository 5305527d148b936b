"""Surrogate data made from a seed: CIFAR and MNIST shapes, and VOC
image sizes.

``make_surrogate_cifar`` is a copy of ``bench.py::make_surrogate_cifar``
in the repository root, so the port and its chip check have data without
importing ``bench.py``; a test holds the two bit-identical.
``make_surrogate_voc`` is the port's copy of the image generator of
``bench.py::voc_bench``, made at VOC2007's image sizes, and
``make_surrogate_mnist`` the copy of ``bench.py::mnist_bench``'s and
``make_surrogate_timit`` of ``bench.py::timit_bench``'s.
``make_surrogate_imagenet`` makes ImageNet-sized images with a class
signal both of the ImageNet app's branches (SIFT and LCS) can see.
"""
from __future__ import annotations

import numpy as np

from ..parallel.dataset import HostDataset
from .image_loader_utils import LabeledImage, MultiLabeledImage

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


def make_surrogate_imagenet(n_train, n_test, seed=0, num_classes=1000,
                            h=480, w=640):
    """Single-label surrogate at ImageNet image sizes, the stand-in while
    the ImageNet tars are absent. Each class has a mean color (uniform
    in [40, 215] per channel) and an oriented sinusoidal texture (an
    angle in [0, pi) and a period of 7-25 pixels), drawn from
    ``RandomState(seed)``; an image is its class's color, jittered by up
    to 8 levels per channel, plus the texture at amplitude 30-45 and a
    random phase (both rounded to whole levels), plus uniform integer
    noise in [-64, 63] per pixel and channel (a random byte halved),
    clipped to [0, 255]. Gray-level orientation is what dense
    SIFT sees, local color and contrast what LCS sees. Labels are
    balanced (each class ``n // num_classes`` or one more times, in a
    seeded order); train from ``seed + 1``, test from ``seed + 2``.
    Returns two HostDatasets of LabeledImage with uint8 (h, w, 3)
    images."""
    rng = np.random.RandomState(seed)
    colors = rng.uniform(40.0, 215.0, (num_classes, 3)).astype(np.float32)
    angles = rng.uniform(0.0, np.pi, num_classes)
    freqs = 2 * np.pi / rng.uniform(7.0, 25.0, num_classes)
    yy = np.arange(h, dtype=np.float32)
    xx = np.arange(w, dtype=np.float32)

    def split(n, r):
        labels = r.permutation(np.arange(n) % num_classes)
        items = []
        for i, c in enumerate(labels):
            # sin(fx x + fy y + phase), separated into two outer products
            fx = freqs[c] * np.cos(angles[c])
            fy = freqs[c] * np.sin(angles[c])
            a = (fx * xx + r.uniform(0.0, 2 * np.pi)).astype(np.float32)
            b = (fy * yy).astype(np.float32)
            tex = np.outer(np.cos(b), np.sin(a))
            tex += np.outer(np.sin(b), np.cos(a))
            tex *= r.uniform(30.0, 45.0)
            base = np.rint(colors[c] + r.uniform(-8.0, 8.0, 3))
            noise = np.frombuffer(r.bytes(h * w * 3), np.uint8)
            img = (noise >> 1).astype(np.int16).reshape(h, w, 3) - 64
            img += np.rint(tex).astype(np.int16)[:, :, None]
            img += base.astype(np.int16)
            np.clip(img, 0, 255, out=img)
            items.append(LabeledImage(img.astype(np.uint8), int(c),
                                      f"n{c:05d}/im{i}.JPEG"))
        return HostDataset(items)

    return (split(n_train, np.random.RandomState(seed + 1)),
            split(n_test, np.random.RandomState(seed + 2)))
