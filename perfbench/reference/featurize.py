"""The plain featurizer of RandomPatchCifar, step by step.

A frozen copy of the plain version of the port's fused kernel
(``keystone_tpu_torch/ops/kernels.py::fused_cifar_featurize_plain``,
with ``ops/image_ops.py``'s ``patch_matrix``, ``patch_stats``,
``pool_regions`` and ``pool_image``): the stride-1 patches in (dy, dx,
c) order, each normalized by its mean and ``sqrt(var + var_constant)``
(unbiased variance), the whitener's means subtracted after the
normalization, the filter product, the symmetric rectifier at
``alpha``, and sum pooling over square regions. The reference's
``Convolver``, ``SymmetricRectifier`` and ``Pooler`` compute the same.
"""
from __future__ import annotations

import torch


def pool_regions(dim: int, stride: int, size: int):
    """[lo, hi) ranges of the pooling regions along one axis: centers from
    size // 2 in steps of ``stride``."""
    half = size // 2
    return [(x - half, min(x + half, dim)) for x in range(half, dim, stride)]


def featurize(imgs: torch.Tensor, filters: torch.Tensor, means: torch.Tensor,
              patch: int, pool_stride: int, pool_size: int, alpha: float,
              var_constant: float = 10.0) -> torch.Tensor:
    """(B, H, W, C) images -> (B, R * 2K) features, region-major, the K
    positive then the K negative parts in each region; computed in the
    dtype of ``imgs`` (filters and means are cast to it)."""
    dt = imgs.dtype
    filters, means = filters.to(dt), means.to(dt)
    B, H, W, C = imgs.shape
    p = imgs.unfold(1, patch, 1).unfold(2, patch, 1)     # (B, OH, OW, C, dy, dx)
    p = p.permute(0, 1, 2, 4, 5, 3).reshape(B, H - patch + 1, W - patch + 1, -1)
    F = p.shape[-1]
    m = p.sum(dim=-1) / F
    var = ((p * p).sum(dim=-1) - F * m * m) / (F - 1.0)
    sd = torch.sqrt(var + var_constant)
    raw = p @ filters.T
    conv = (raw - m[..., None] * filters.sum(dim=1)) / sd[..., None]
    conv -= filters @ means
    del raw, p
    rect = torch.cat([torch.clamp_min(conv - alpha, 0.0),
                      torch.clamp_min(-conv - alpha, 0.0)], dim=-1)
    del conv
    OH, OW = rect.shape[1], rect.shape[2]
    pooled = torch.stack([
        torch.stack([rect[:, x0:x1, y0:y1].sum(dim=(1, 2))
                     for y0, y1 in pool_regions(OW, pool_stride, pool_size)],
                    dim=1)
        for x0, x1 in pool_regions(OH, pool_stride, pool_size)], dim=1)
    return pooled.reshape(B, -1)


def featurize_rows(imgs: torch.Tensor, filters, means, dtype, rows: int,
                   **geometry) -> torch.Tensor:
    """:func:`featurize` over ``imgs`` in blocks of ``rows`` images, in
    ``dtype``."""
    return torch.cat([featurize(imgs[i:i + rows].to(dtype), filters, means,
                                **geometry)
                      for i in range(0, imgs.shape[0], rows)])
