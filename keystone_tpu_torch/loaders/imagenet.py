"""ImageNet loader.

Counterpart of ``keystone_tpu/loaders/imagenet.py`` (reference
``loaders/ImageNetLoader.scala``): ``data_path`` holds tar archives whose
members live under a directory per class (``class_name/img.JPEG``);
``labels_path`` maps class names to numeric labels, one ``class_name
label`` pair a line.
"""
from __future__ import annotations

from typing import Dict

from ..parallel.dataset import HostDataset
from .image_loader_utils import (
    LabeledImage,
    list_archive_paths,
    load_tar_files,
)

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


def imagenet_loader(data_path: str, labels_path: str) -> HostDataset:
    """A HostDataset of LabeledImage, float32 images on the host
    (reference ``ImageNetLoader.scala:27-39``): a member's top-level
    directory is its class name; a class missing from the labels file
    raises ``KeyError``."""
    labels_map = parse_imagenet_labels(labels_path)

    def lookup(entry_name: str) -> int:
        return labels_map[entry_name.split("/")[0]]

    return load_tar_files(
        list_archive_paths(data_path),
        lookup,
        lambda img, label, name: LabeledImage(img, label, name),
    )
