"""Histogram of Oriented Gradients.

Counterpart of ``keystone_tpu/nodes/images/hog.py`` (reference
``nodes/images/HogExtractor.scala``, a port of Felzenszwalb and
Girshick's voc-release ``features.cc``): per-pixel channel selection,
18-way orientation snapping, the bilinear cell histograms, block
normalization and the 32 features a cell (18 contrast-sensitive, 9
insensitive, 4 texture and 1 truncation), as whole-image tensor
operations on the image's device.

The JAX package builds the (18, ny, nx) histograms with a scatter-add.
On CUDA a scatter-add reduces through atomics, in an order that changes
from launch to launch, so here each pixel's bilinear weights factor into
two interpolation matrices, one a side (its two cells and their
weights), and the histograms are two batched matrix products: the same
inputs give the same bits on every launch.
"""
from __future__ import annotations

import numpy as np
import torch

from ...workflow.transformer import Transformer

EPSILON = 1e-4
UU = np.array([1.0, 0.9397, 0.7660, 0.5, 0.1736,
               -0.1736, -0.5, -0.7660, -0.9397], np.float32)
VV = np.array([0.0, 0.3420, 0.6428, 0.8660, 0.9848,
               0.9848, 0.8660, 0.6428, 0.3420], np.float32)


def _interpolation(n_pixels: int, bin_size: int, n_cells: int) -> np.ndarray:
    """(n_cells, n_pixels - 2) float32: row c holds the weight with which
    each interior pixel 1 .. n_pixels - 2 reaches cell c, the low cell
    ``floor((p + 0.5) / bin_size - 0.5)`` taking ``1 - v`` and the next
    one ``v`` (cells outside the image take nothing)."""
    p = np.arange(1, n_pixels - 1)
    pos = (p + 0.5) / bin_size - 0.5
    low = np.floor(pos).astype(np.int64)
    v = (pos - low).astype(np.float32)
    out = np.zeros((n_cells, p.size), np.float32)
    cols = np.arange(p.size)
    for cell, w in ((low, np.float32(1.0) - v), (low + 1, v)):
        ok = (cell >= 0) & (cell < n_cells)
        out[cell[ok], cols[ok]] = w[ok]
    return out


def _hog(img: torch.Tensor, bin_size: int, nx: int, ny: int) -> torch.Tensor:
    H, W, C = img.shape
    dev = img.device
    nvx, nvy = nx * bin_size, ny * bin_size

    # gradients of the interior pixels 1 .. nv - 2, reads clamped to the
    # image (reference HogExtractor.scala:88-91)
    xs = torch.arange(1, nvx - 1, device=dev)
    ys = torch.arange(1, nvy - 1, device=dev)

    def px(x_idx, y_idx):
        return img[x_idx.clamp(0, H - 1)][:, y_idx.clamp(0, W - 1)]

    dx = px(xs + 1, ys) - px(xs - 1, ys)           # (nvx-2, nvy-2, C)
    dy = px(xs, ys + 1) - px(xs, ys - 1)
    mag2 = dx * dx + dy * dy
    # the largest magnitude's channel; the reference scans channels from
    # the last and keeps strictly greater, so ties go to the lowest
    best = (C - 1) - torch.argmax(mag2.flip(-1), dim=-1, keepdim=True)
    dx = torch.gather(dx, -1, best)[..., 0]
    dy = torch.gather(dy, -1, best)[..., 0]
    mag = torch.sqrt(torch.gather(mag2, -1, best)[..., 0])

    # orientation: [d0, -d0, d1, -d1, ...] interleaved, so the first
    # maximum is the reference's first strictly greater one
    uu = torch.as_tensor(UU, device=dev)
    vv = torch.as_tensor(VV, device=dev)
    dots = dy[..., None] * uu + dx[..., None] * vv
    inter = torch.stack([dots, -dots], dim=-1).reshape(
        dots.shape[:-1] + (18,))
    am = torch.argmax(inter, dim=-1)
    orient = torch.where(inter.amax(dim=-1) > 0.0, am // 2 + 9 * (am % 2),
                         torch.zeros_like(am))

    # the (18, ny, nx) cell histograms: per orientation, the magnitudes
    # interpolated along x and y by two matrix products
    onehot = orient[None] == torch.arange(18, device=dev)[:, None, None]
    votes = torch.where(onehot, mag[None], 0.0)    # (18, nvx-2, nvy-2)
    ax = torch.as_tensor(_interpolation(nvx, bin_size, nx), device=dev)
    ay = torch.as_tensor(_interpolation(nvy, bin_size, ny), device=dev)
    hist = ay @ (ax @ votes).transpose(1, 2)       # (18, ny, nx)

    # cell energies over combined opposite orientations
    comb = hist[:9] + hist[9:]
    norm = torch.sum(comb * comb, dim=0)           # (ny, nx)
    nxf, nyf = max(nx - 2, 0), max(ny - 2, 0)
    # 2 x 2 block sums S[y, x] = norm[y:y+2, x:x+2].sum()
    S = norm[:-1, :-1] + norm[:-1, 1:] + norm[1:, :-1] + norm[1:, 1:]

    def inv(block):
        return 1.0 / torch.sqrt(block + EPSILON)

    n1 = inv(S[1:1 + nyf, 1:1 + nxf])
    n2 = inv(S[1:1 + nyf, 0:nxf])
    n3 = inv(S[0:nyf, 1:1 + nxf])
    n4 = inv(S[0:nyf, 0:nxf])

    ch = hist[:, 1:1 + nyf, 1:1 + nxf]             # (18, nyf, nxf)
    h1, h2, h3, h4 = (torch.clamp_max(ch * n, 0.2) for n in (n1, n2, n3, n4))
    sensitive = 0.5 * (h1 + h2 + h3 + h4)
    t1, t2, t3, t4 = (h.sum(dim=0) for h in (h1, h2, h3, h4))
    cs = ch[:9] + ch[9:]
    insensitive = 0.5 * (
        torch.clamp_max(cs * n1, 0.2) + torch.clamp_max(cs * n2, 0.2)
        + torch.clamp_max(cs * n3, 0.2) + torch.clamp_max(cs * n4, 0.2))
    texture = 0.2357 * torch.stack([t1, t2, t3, t4])
    trunc = torch.zeros((1, nyf, nxf), dtype=torch.float32, device=dev)
    feats = torch.cat([sensitive, insensitive, texture, trunc], dim=0)
    # rows ordered y + x * nyf (reference computeFeaturesFromHist)
    return feats.permute(2, 1, 0).reshape(nxf * nyf, 32)


class HogExtractor(Transformer):
    """32-dim HOG cell features of an (H, W, C) image in [0, 255]; output
    (cells, 32) float32, cells ``(round(H / bin) - 2) x (round(W / bin) -
    2)`` (reference ``HogExtractor.scala:33-70``)."""

    def __init__(self, bin_size: int = 8):
        self.bin_size = bin_size

    def apply(self, img):
        H, W = int(img.shape[0]), int(img.shape[1])
        nx = int(round(H / self.bin_size))
        ny = int(round(W / self.bin_size))
        return _hog(img.to(torch.float32), self.bin_size, nx, ny)
