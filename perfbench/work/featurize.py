"""Work of RandomPatchCifar's featurizer (convolve, rectify, pool).

A frozen copy of ``keystone_tpu_torch/ops/work.py::featurize_work``.
"""
from __future__ import annotations

from typing import Tuple


def regions(dim: int, stride: int, size: int):
    half = size // 2
    return [(x - half, min(x + half, dim)) for x in range(half, dim, stride)]


def featurize_work(B: int, K: int, image: int = 32, channels: int = 3,
                   patch: int = 6, pool_stride: int = 13,
                   pool_size: int = 14) -> Tuple[int, int]:
    """(operations, bytes) of featurizing B images with K filters: the
    patch-by-filter products (2 P F K an image), the patch sums and sums
    of squares (3 P F), normalize and rectify (9 P K) and the pooled adds
    (2 K a region membership); the images, the filters, their means and
    the features read or written once."""
    side = image - patch + 1
    P, F = side * side, patch * patch * channels
    spans = [hi - lo for lo, hi in regions(side, pool_stride, pool_size)]
    R = len(spans) ** 2
    hits = sum(spans) ** 2
    ops = B * (2 * P * F * K + 3 * P * F + 9 * P * K + 2 * K * hits)
    nbytes = 4 * (B * image * image * channels + K * F + F + B * R * 2 * K)
    return ops, nbytes
