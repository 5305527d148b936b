"""ImageNet labels.

Counterpart of the label parsing of ``keystone_tpu/loaders/imagenet.py``
(reference ``loaders/ImageNetLoader.scala``): ``labels_path`` maps class
names to numeric labels, one ``class_name label`` pair a line. The tar
loader, ``imagenet_loader``, waits for the port's tar image loaders.
"""
from __future__ import annotations

from typing import Dict

NUM_CLASSES = 1000  # constant of the ImageNet (ILSVRC 2012) dataset


def parse_imagenet_labels(labels_path: str) -> Dict[str, int]:
    """class name -> label (reference ``ImageNetLoader.scala:20-26``)."""
    labels: Dict[str, int] = {}
    with open(labels_path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                labels[parts[0]] = int(parts[1])
    return labels
