"""Image tensor ops: window extraction, patch-normalized filter-bank
convolution, pooling, row normalization, grayscale.

Counterpart of ``keystone_tpu/ops/image_ops.py``. Images are ``(H, W,
C)`` float tensors, optionally with leading batch dimensions. Patch
feature vectors are flattened in ``(dy, dx, c)`` order, the packing of
the reference's ``Windower`` and ``Convolver.makePatches``, so whiteners
and filters are interchangeable between the two.

The filter-bank convolution builds each image's patch matrix (im2col by
``unfold``) and multiplies it by the filter bank, as the reference's
Convolver does (Convolver.scala:120-190); the per-patch normalization
uses the same sum / sum-of-squares statistics as the JAX package:

    out[y,x,k] = (raw[y,x,k] - m[y,x] * fsum[k]) / sd[y,x] - (mu . f_k)
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def extract_windows(img: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """All (size x size) windows of an (..., H, W, C) image with the given
    stride; returns (..., nH, nW, size, size, C)."""
    w = img.unfold(-3, size, stride).unfold(-3, size, stride)
    # (..., nH, nW, C, size_h, size_w) -> (..., nH, nW, size_h, size_w, C)
    return w.movedim(-3, -1)


def patch_matrix(img: torch.Tensor, size: int) -> torch.Tensor:
    """Stride-1 patches of (..., H, W, C) images as (..., H', W', F) rows
    in (dy, dx, c) feature order."""
    w = extract_windows(img, size, 1)
    return w.reshape(w.shape[:-3] + (-1,))


def normalize_rows(mat: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    """Per-row mean-centering and variance normalization
    (reference ``utils/Stats.scala:112-123``): subtract the row mean
    (NaN -> 0) and divide by sqrt(row variance + alpha), ddof=1."""
    d = mat.shape[-1]
    means = mat.mean(dim=-1, keepdim=True)
    means = torch.where(torch.isnan(means), torch.zeros_like(means), means)
    var = ((mat - means) ** 2).sum(dim=-1, keepdim=True) / (d - 1.0)
    sds = torch.sqrt(var + alpha)
    sds = torch.where(torch.isnan(sds), torch.full_like(sds, math.sqrt(alpha)),
                      sds)
    return (mat - means) / sds


def patch_stats(patches: torch.Tensor, var_constant: float):
    """Per-patch mean and ``sqrt(var + var_constant)`` of (..., F) rows,
    with the unbiased variance written as ``(sum p^2 - F m^2) / (F - 1)``
    and a NaN guard — the formula the fused kernel uses too."""
    F = patches.shape[-1]
    m = patches.sum(dim=-1) / F
    var = ((patches * patches).sum(dim=-1) - F * m * m) / (F - 1.0)
    sd = torch.sqrt(var + var_constant)
    sd = torch.where(torch.isnan(sd),
                     torch.full_like(sd, math.sqrt(var_constant)), sd)
    return m, sd


def filter_bank_convolve(
    img: torch.Tensor,
    filters: torch.Tensor,
    conv_size: int,
    channels: int,
    normalize_patches: bool = True,
    whitener_means: Optional[torch.Tensor] = None,
    var_constant: float = 10.0,
) -> torch.Tensor:
    """Patch-normalized filter-bank convolution of (..., H, W, C) images.

    ``filters`` is (num_filters, conv_size*conv_size*channels) in
    (dy, dx, c) feature order (already whitened/normalized by the caller,
    Convolver.scala:20-45). Per-patch normalization with
    ``var_constant``, optional whitener mean subtraction after it, then
    the filter GEMM. Returns (..., H', W', K).
    """
    assert img.shape[-1] == channels, (img.shape, channels)
    patches = patch_matrix(img, conv_size)           # (..., H', W', F)
    raw = patches @ filters.T                        # (..., H', W', K)
    if normalize_patches:
        m, sd = patch_stats(patches, var_constant)
        fsum = filters.sum(dim=1)
        out = (raw - m[..., None] * fsum) / sd[..., None]
    else:
        out = raw
    if whitener_means is not None:
        out = out - filters @ whitener_means
    return out


def pool_regions(dim: int, stride: int, pool_size: int):
    """[lo, hi) index ranges of the pooling regions along one axis:
    centers start at pool_size/2 and step by ``stride``; each region
    spans [x - pool_size/2, min(x + pool_size/2, dim))."""
    half = pool_size // 2
    return [(x - half, min(x + half, dim)) for x in range(half, dim, stride)]


def pool_image(
    img: torch.Tensor,
    stride: int,
    pool_size: int,
    pixel_fn: str = "identity",
    pool_fn: str = "sum",
) -> torch.Tensor:
    """Strided spatial pooling (reference ``images/Pooler.scala:20-68``)
    of (..., H, W, C) images; returns (..., nPoolsX, nPoolsY, C)."""
    H, W = img.shape[-3], img.shape[-2]
    px = {"identity": lambda v: v, "abs": torch.abs,
          "square": torch.square}[pixel_fn]
    img = px(img)
    reduce = {"sum": torch.sum, "max": torch.amax, "mean": torch.mean}
    if pool_fn not in reduce:
        raise ValueError(pool_fn)
    rows = []
    for x0, x1 in pool_regions(H, stride, pool_size):
        row = [reduce[pool_fn](img[..., x0:x1, y0:y1, :], dim=(-3, -2))
               for y0, y1 in pool_regions(W, stride, pool_size)]
        rows.append(torch.stack(row, dim=-2))
    return torch.stack(rows, dim=-3)


# MATLAB rgb2gray weights (reference ``utils/images/ImageUtils.scala:73-105``)
NTSC_RED, NTSC_GREEN, NTSC_BLUE = 0.2989, 0.5870, 0.1140


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """Grayscale with a single kept channel. 3-channel images use the
    MATLAB luma weights; otherwise the RMS over channels. Integer images
    are promoted to float32 first."""
    if not torch.is_floating_point(img):
        img = img.to(torch.float32)
    if img.shape[-1] == 1:
        return img
    if img.shape[-1] == 3:
        w = torch.tensor([NTSC_RED, NTSC_GREEN, NTSC_BLUE], dtype=img.dtype,
                         device=img.device)
        return (img @ w)[..., None]
    return torch.sqrt((img * img).mean(dim=-1, keepdim=True))
