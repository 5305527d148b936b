"""DAISY dense descriptors.

Counterpart of ``keystone_tpu/nodes/images/daisy.py`` (reference
``nodes/images/DaisyExtractor.scala``; Tola, Lepetit and Fua, PAMI
2010): H rectified oriented gradient maps, blurred in Q stacked Gaussian
levels (each level blurs the one before, so level l carries the
cumulative sigma), then each keypoint's histograms at its center and at
T ring points a level, each L2-normalized. The convolutions are
separable 'same' true convolutions (``conv2d_same``), batched over the
H maps of a level; the histograms are gathers at integer offsets.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch
import torch.nn.functional as F

from ...workflow.transformer import Transformer

FEATURE_THRESHOLD = 1e-8
CONV_THRESHOLD = 1e-6


def conv2d_same(img: torch.Tensor, fx: np.ndarray,
                fy: np.ndarray) -> torch.Tensor:
    """Zero-padded separable 'same' true convolution of (..., H, W) planes
    with ``fx`` along H and ``fy`` along W, as ``ImageUtils.conv2D``
    computes it (reference ImageUtils.scala:226-344): each side padded
    ``floor((L - 1) / 2)`` at its low end and the rest at its high end.
    ``torch.conv2d`` cross-correlates, so the kernels are flipped."""
    kx = torch.as_tensor(np.asarray(fx, np.float32)[::-1].copy(),
                         device=img.device)
    ky = torch.as_tensor(np.asarray(fy, np.float32)[::-1].copy(),
                         device=img.device)
    lx, ly = len(fx), len(fy)
    plx, ply = (lx - 1) // 2, (ly - 1) // 2
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    x = F.pad(x, (ply, ly - 1 - ply, plx, lx - 1 - plx))
    x = F.conv2d(x, kx.reshape(1, 1, -1, 1))
    x = F.conv2d(x, ky.reshape(1, 1, 1, -1))
    return x.reshape(lead + tuple(x.shape[-2:]))


def _daisy_kernels(daisy_q: int, daisy_r: int) -> List[np.ndarray]:
    """Incremental Gaussian kernels (reference DaisyExtractor.scala:50-64):
    the sigma^2 ladder (R n / 2Q)^2, each kernel covering one step."""
    sigma_sq = [(daisy_r * n / (2.0 * daisy_q)) ** 2
                for n in range(daisy_q + 1)]
    diffs = [b - a for a, b in zip(sigma_sq, sigma_sq[1:])]
    kernels = []
    for t in diffs:
        radius = int(math.ceil(math.sqrt(
            -2 * t * math.log(CONV_THRESHOLD)
            - t * math.log(2 * math.pi * t))))
        n = np.arange(-radius, radius + 1, dtype=np.float64)
        kernels.append(np.exp(-(n ** 2) / (2 * t))
                       / math.sqrt(2 * math.pi * t))
    return kernels


def _ring(T: int, Q: int, R: int) -> np.ndarray:
    """(Q, T, 2) integer offsets of the ring points of each level."""
    ring = np.zeros((Q, T, 2), np.int64)
    for level in range(Q):
        rad = R * (1.0 + level) / Q
        for t in range(T):
            theta = 2.0 * np.pi * (t - 1) / T
            ring[level, t, 0] = int(round(rad * math.sin(theta)))
            ring[level, t, 1] = int(round(rad * math.cos(theta)))
    return ring


def _daisy(img: torch.Tensor, T: int, Q: int, R: int, H: int, border: int,
           stride: int) -> torch.Tensor:
    height, width = img.shape
    dev = img.device
    # oriented gradient maps (reference :108-136)
    f1 = np.array([1.0, 0.0, -1.0])
    f2 = np.array([1.0, 2.0, 1.0])
    ix = conv2d_same(img, f1, f2)
    iy = conv2d_same(img, f2, f1)
    angles = 2.0 * np.pi * np.arange(H) / H
    cos = torch.as_tensor(np.cos(angles).astype(np.float32), device=dev)
    sin = torch.as_tensor(np.sin(angles).astype(np.float32), device=dev)
    level = torch.clamp_min(cos[:, None, None] * ix + sin[:, None, None] * iy,
                            0.0)                       # (H, height, width)
    levels = []
    for k in _daisy_kernels(Q, R):
        level = conv2d_same(level, k, k)
        levels.append(level)

    xs = np.arange(border, height - border, stride)
    ys = np.arange(border, width - border, stride)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    xx, yy = xx.ravel(), yy.ravel()    # keypoints, x-major as the reference

    def hist(level, px, py):
        """(N, H) histograms at the points, L2-normalized, zero where the
        norm is below the feature threshold."""
        h = level[:, torch.as_tensor(px, device=dev),
                  torch.as_tensor(py, device=dev)].T
        n = torch.linalg.vector_norm(h, dim=1, keepdim=True)
        return torch.where(n > FEATURE_THRESHOLD,
                           h / torch.clamp_min(n, 1e-30), 0.0)

    # layout (reference :160-186): the center histogram (level 0 at the
    # keypoint), then angle t, level l at H + t*Q*H + l*H
    feats = [hist(levels[0], xx, yy)]
    ring = _ring(T, Q, R)
    for t in range(T):
        for lv in range(Q):
            px = np.clip(xx + ring[lv, t, 0], 0, height - 1)
            py = np.clip(yy + ring[lv, t, 1], 0, width - 1)
            feats.append(hist(levels[lv], px, py))
    return torch.cat(feats, dim=1).T               # (H(TQ + 1), N)


class DaisyExtractor(Transformer):
    """DAISY on a regular grid of a grayscale (H, W) or (H, W, C) image
    (channel 0 read); output (H(TQ + 1), keypoints) float32 (reference
    ``DaisyExtractor.scala:28-201``)."""

    def __init__(self, daisy_t: int = 8, daisy_q: int = 3, daisy_r: int = 7,
                 daisy_h: int = 8, pixel_border: int = 16, stride: int = 4):
        self.daisy_t = daisy_t
        self.daisy_q = daisy_q
        self.daisy_r = daisy_r
        self.daisy_h = daisy_h
        self.pixel_border = pixel_border
        self.stride = stride

    @property
    def feature_size(self) -> int:
        return self.daisy_h * (self.daisy_t * self.daisy_q + 1)

    def apply(self, img):
        if img.dim() == 3:
            img = img[..., 0]
        return _daisy(img.to(torch.float32), self.daisy_t, self.daisy_q,
                      self.daisy_r, self.daisy_h, self.pixel_border,
                      self.stride)
