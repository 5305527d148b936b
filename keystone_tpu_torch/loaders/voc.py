"""VOC 2007 loader.

Counterpart of ``keystone_tpu/loaders/voc.py`` (reference
``loaders/VOCLoader.scala``): images come from tar archives, their
members under ``VOCdevkit/VOC2007/JPEGImages/``; the labels CSV has a
header row, column 1 the 1-based class id and column 4 the quoted image
filename, one row per (image, label) pair, so images accumulate several
labels. A member's labels are keyed on its basename.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from ..parallel.dataset import HostDataset
from .image_loader_utils import (
    MultiLabeledImage,
    list_archive_paths,
    load_tar_files,
)

NUM_CLASSES = 20  # constant of the VOC 2007 dataset


@dataclass
class VOCDataPath:
    images_dir_name: str
    name_prefix: str = "VOCdevkit"
    num_parts: Optional[int] = None


@dataclass
class VOCLabelPath:
    labels_file_name: str


def parse_voc_labels(labels_path: str) -> Dict[str, List[int]]:
    """filename -> 0-based label list (reference ``VOCLoader.scala:33-48``)."""
    labels_map: Dict[str, List[int]] = {}
    with open(labels_path) as f:
        lines = f.read().splitlines()
    for line in lines[1:]:  # drop header
        if not line.strip():
            continue
        parts = line.split(",")
        fname = parts[4].replace('"', "")
        label = int(parts[1]) - 1
        labels_map.setdefault(fname, []).append(label)
    return labels_map


def voc_loader(data_path: VOCDataPath,
               labels_path: VOCLabelPath) -> HostDataset:
    """A HostDataset of MultiLabeledImage, float32 images on the host
    (reference ``VOCLoader.scala:29-52``); members outside
    ``data_path.name_prefix`` are skipped, a member missing from the CSV
    gets no labels."""
    labels_map = parse_voc_labels(labels_path.labels_file_name)

    def lookup(entry_name: str) -> List[int]:
        return labels_map.get(entry_name.split("/")[-1], [])

    return load_tar_files(
        list_archive_paths(data_path.images_dir_name),
        lookup,
        lambda img, labels, name: MultiLabeledImage(img, labels, name),
        name_prefix=data_path.name_prefix or None,
    )
