"""VOC 2007 labels.

Counterpart of the label parsing of ``keystone_tpu/loaders/voc.py``
(reference ``loaders/VOCLoader.scala``): the labels CSV has a header row;
column 1 is the 1-based class id and column 4 the quoted image filename,
one row per (image, label) pair, so images accumulate several labels.
The tar loader waits for the port's image decoding.
"""
from __future__ import annotations

from typing import Dict, List

NUM_CLASSES = 20  # constant of the VOC 2007 dataset


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
