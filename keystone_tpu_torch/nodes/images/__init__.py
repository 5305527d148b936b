"""Image nodes (reference ``nodes/images``), the counterpart of
``keystone_tpu/nodes/images``."""
from .core import (
    CenterCornerPatcher,
    Convolver,
    Cropper,
    FusedConvRectifyPool,
    GrayScaler,
    ImageExtractor,
    ImageVectorizer,
    LabelExtractor,
    PixelScaler,
    Pooler,
    RandomFlipper,
    RandomImageTransformer,
    RandomPatcher,
    SymmetricRectifier,
    Windower,
)
from .daisy import DaisyExtractor
from .extractors import BatchSIFTExtractor, LCSExtractor, SIFTExtractor
from .fisher_vector import (
    EncEvalGMMFisherVectorEstimator,
    FisherVector,
    GMMFisherVectorEstimator,
    ScalaGMMFisherVectorEstimator,
)
from .hog import HogExtractor
from .multilabel import MultiLabeledImageExtractor, MultiLabelExtractor

__all__ = [
    "BatchSIFTExtractor",
    "CenterCornerPatcher",
    "Convolver",
    "Cropper",
    "DaisyExtractor",
    "EncEvalGMMFisherVectorEstimator",
    "FisherVector",
    "FusedConvRectifyPool",
    "GMMFisherVectorEstimator",
    "GrayScaler",
    "HogExtractor",
    "ImageExtractor",
    "ImageVectorizer",
    "LCSExtractor",
    "LabelExtractor",
    "MultiLabelExtractor",
    "MultiLabeledImageExtractor",
    "PixelScaler",
    "Pooler",
    "RandomFlipper",
    "RandomImageTransformer",
    "RandomPatcher",
    "ScalaGMMFisherVectorEstimator",
    "SIFTExtractor",
    "SymmetricRectifier",
    "Windower",
]
