"""Dense feature extractors: SIFT and LCS.

Counterpart of ``keystone_tpu/nodes/images/extractors.py`` (reference
``nodes/images/external/SIFTExtractor.scala``,
``nodes/images/LCSExtractor.scala``): a per-image (D, numDesc) float
matrix, the reference's column-per-descriptor layout. On a CUDA image
every SIFT band contraction runs in the banded kernel
(``ops.kernels.banded_matmul``, 2 launches a scale); LCS is two
separable box filters (``conv2d``) and one gather.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.sift import dense_sift, sift_descriptor_count
from ...workflow.transformer import Transformer


class SIFTExtractor(Transformer):
    """Multi-scale dense SIFT (reference ``SIFTExtractor.scala:27-34`` /
    ``VLFeat.cxx``): a grayscale (H, W) or (H, W, 1) image scaled to
    [0, 1] in, (128, numDesc) out."""

    def __init__(self, step: int = 4, bin_size: int = 6,
                 num_scales: int = 5, scale_step: int = 0):
        self.step = step
        self.bin_size = bin_size
        self.num_scales = num_scales
        self.scale_step = scale_step

    def apply(self, img):
        if img.dim() == 3:
            img = img[..., 0]
        return dense_sift(
            img, self.step, self.bin_size, self.num_scales, self.scale_step)

    def descriptor_count(self, height: int, width: int) -> int:
        return sift_descriptor_count(
            height, width, self.step, self.bin_size,
            self.num_scales, self.scale_step)

    # -- static HBM planning (analysis.resources) --------------------------
    def resource_effect(self, dep_specs, out_spec, data_shards=1):
        """A SIFT node charges its configuration's band operators, held on
        the card by the banded kernel's cache across every image of the
        configuration, once, as a transient of the node."""
        import dataclasses

        from ...analysis.resources import (
            sift_band_operator_nbytes,
            spec_effect,
        )
        from ...analysis.spec import ShapeDtype

        element = (getattr(dep_specs[0], "element", None)
                   if dep_specs else None)
        if not (isinstance(element, ShapeDtype) and len(element.shape) >= 2):
            return None
        base = spec_effect(out_spec, data_shards)
        extra = sift_band_operator_nbytes(
            int(element.shape[0]), int(element.shape[1]), self.step,
            self.bin_size, self.num_scales, self.scale_step)
        return dataclasses.replace(
            base, transient_nbytes=base.transient_nbytes + extra,
            note=(base.note + "; " if base.note else "")
            + "SIFT band-operator constants")


class BatchSIFTExtractor(SIFTExtractor):
    """SIFT over a dataset of images, one image at a time."""

    fusable = False

    def apply_dataset(self, ds):
        return ds.map(self.apply)


def _box_filter(x: torch.Tensor, size: int) -> torch.Tensor:
    """'same' separable box filter of (C, H, W) planes with zero padding
    (``(size - 1) // 2`` before, the rest after, as ImageUtils.conv2D
    pads): a row pass and a column pass of ``1 / size`` weights."""
    r0 = (size - 1) // 2
    r1 = size - 1 - r0
    k = torch.full((1, 1, size, 1), 1.0 / size, dtype=x.dtype,
                   device=x.device)
    y = F.pad(x[:, None], (r0, r1, r0, r1))
    y = F.conv2d(y, k)
    y = F.conv2d(y, k.transpose(2, 3))
    return y[:, 0]


def _lcs(img: torch.Tensor, stride: int, stride_start: int,
         sub_patch_size: int) -> torch.Tensor:
    """Local color statistics (reference ``LCSExtractor.scala:50-130``):
    per-channel box-filter means and standard deviations
    ``sqrt(max(box(x^2) - box(x)^2, 0))``, sampled on a keypoint grid at
    a 4 x 4 neighborhood of sub-patch offsets. Rows in the JAX package's
    order: channel, x-offset, y-offset, (mean, std); keypoints x-major.
    Returns (C * 16 * 2, numKeypoints) float32."""
    H, W, C = img.shape
    x = img.to(torch.float32).permute(2, 0, 1)          # (C, H, W)
    means = _box_filter(x, sub_patch_size)
    stds = torch.sqrt(torch.clamp_min(
        _box_filter(x * x, sub_patch_size) - means * means, 0.0))

    xs = np.arange(stride_start, H - stride_start, stride)
    ys = np.arange(stride_start, W - stride_start, stride)
    # sub-patch offsets: start = -2s + s//2 - 1, end = s + s//2 - 1, step s
    start = -2 * sub_patch_size + sub_patch_size // 2 - 1
    end = sub_patch_size + sub_patch_size // 2 - 1
    offs = np.arange(start, end + 1, sub_patch_size)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")           # x-major
    px = np.clip(xx.ravel()[None, :] + offs[:, None], 0, H - 1)
    py = np.clip(yy.ravel()[None, :] + offs[:, None], 0, W - 1)
    px = torch.as_tensor(px, device=img.device)[:, None, :]   # (4, 1, K)
    py = torch.as_tensor(py, device=img.device)[None, :, :]   # (1, 4, K)
    stats = torch.stack([means[:, px, py], stds[:, px, py]], dim=3)
    return stats.reshape(-1, stats.shape[-1])              # (C*4*4*2, K)


class LCSExtractor(Transformer):
    """Local Color Statistics on a regular grid (reference
    ``LCSExtractor.scala:26-130``; Clinchant et al. 2007): 4 x 4
    sub-region means and standard deviations of each channel, 96-dim
    descriptors for 3 channels. Input an (H, W, C) image in [0, 255]
    (any real or integer type); output (96, numKeypoints) float32."""

    def __init__(self, stride: int = 4, stride_start: int = 16,
                 sub_patch_size: int = 6):
        self.stride = stride
        self.stride_start = stride_start
        self.sub_patch_size = sub_patch_size

    def apply(self, img):
        return _lcs(img, self.stride, self.stride_start, self.sub_patch_size)
