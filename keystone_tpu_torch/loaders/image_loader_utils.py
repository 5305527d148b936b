"""Labeled image items.

Counterpart of the item types of
``keystone_tpu/loaders/image_loader_utils.py`` (reference
``utils/images/Image.scala:371-394``): an image as a float32 (H, W, C)
array in [0, 255] with its label or labels. The tar loader (PIL decode,
retry and quarantine) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class LabeledImage:
    """Image + single int label (reference ``Image.scala:371-380``)."""

    image: np.ndarray
    label: int
    filename: Optional[str] = None


@dataclass
class MultiLabeledImage:
    """Image + multiple labels (reference ``Image.scala:383-394``)."""

    image: np.ndarray
    labels: List[int] = field(default_factory=list)
    filename: Optional[str] = None
