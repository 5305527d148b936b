"""Multi-label image extractors.

Counterpart of ``keystone_tpu/nodes/images/multilabel.py`` (reference
``nodes/images/LabeledImageExtractors.scala``). Items are
``loaders.image_loader_utils.MultiLabeledImage`` host objects. Label sets
are ragged, so ``MultiLabelExtractor`` pads them to a fixed width with -1
(the layout ``ClassLabelIndicatorsFromIntArrayLabels`` reads); images are
ragged too, so ``MultiLabeledImageExtractor`` gives a HostDataset of
float32 image tensors. Both stage their output on ``device``.
"""
from __future__ import annotations

import numpy as np
import torch

from ...ops.device import DEFAULT_DEVICE, resolve_device
from ...parallel.dataset import ArrayDataset, Dataset, HostDataset
from ...workflow.transformer import Transformer


class MultiLabelExtractor(Transformer):
    """MultiLabeledImage -> padded int label array."""

    fusable = False

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = str(resolve_device(device))

    def apply(self, item):
        return torch.as_tensor(np.asarray(item.labels, dtype=np.int32),
                               device=self.device)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        items = ds.collect()
        width = max((len(it.labels) for it in items), default=1) or 1
        padded = np.full((len(items), width), -1, dtype=np.int32)
        for i, it in enumerate(items):
            padded[i, : len(it.labels)] = np.asarray(it.labels, np.int32)
        return ArrayDataset.from_numpy(padded, self.device)


class MultiLabeledImageExtractor(Transformer):
    """MultiLabeledImage -> float32 image tensor on ``device`` (a host
    dataset: the images are ragged)."""

    fusable = False

    def __init__(self, device=DEFAULT_DEVICE):
        self.device = str(resolve_device(device))

    def apply(self, item):
        return torch.as_tensor(np.asarray(item.image, np.float32),
                               device=self.device)

    def apply_dataset(self, ds: Dataset) -> Dataset:
        return HostDataset([self.apply(it) for it in ds.collect()])
