"""Dense SIFT feature extractors.

Counterpart of the SIFT extractors of
``keystone_tpu/nodes/images/extractors.py`` (reference
``nodes/images/external/SIFTExtractor.scala``): a per-image (128,
numDesc) float matrix, the reference's column-per-descriptor layout. On
a CUDA image every band contraction runs in the banded kernel
(``ops.kernels.banded_matmul``, 2 launches a scale). ``LCSExtractor``
is not ported yet.
"""
from __future__ import annotations

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


class BatchSIFTExtractor(SIFTExtractor):
    """SIFT over a dataset of images, one image at a time."""

    fusable = False

    def apply_dataset(self, ds):
        return ds.map(self.apply)
