"""Amazon product reviews loader (reference
``loaders/AmazonReviewsDataLoader.scala``).

Counterpart of ``keystone_tpu/loaders/amazon.py``. Reviews are JSON
objects, one a line, with at least ``reviewText`` and ``overall`` (the
reference reads the same fields through Spark SQL's ``jsonFile``);
``overall >= threshold`` is the positive class. ``data_path`` is a file,
a glob, or a directory whose ``*.json`` files are read in name order.
Texts stay host items; the labels are staged on ``device``.
"""
from __future__ import annotations

import glob
import json
import os
from typing import List

import numpy as np

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import ArrayDataset, HostDataset
from .csv_loader import LabeledData


def amazon_reviews_loader(data_path: str, threshold: float = 3.5,
                          device=DEFAULT_DEVICE) -> LabeledData:
    if os.path.isdir(data_path):
        files = sorted(glob.glob(os.path.join(data_path, "*.json")))
    else:
        files = sorted(glob.glob(data_path)) or [data_path]
    texts: List[str] = []
    labels: List[int] = []
    for path in files:
        with open(path, "r", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                texts.append(obj["reviewText"])
                labels.append(1 if float(obj["overall"]) >= threshold else 0)
    return LabeledData(
        data=HostDataset(texts),
        labels=ArrayDataset.from_numpy(np.asarray(labels, np.int32), device),
    )
