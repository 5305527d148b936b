"""CSV loading and the LabeledData wrapper.

Counterpart of ``load_csv`` and ``LabeledData`` in
``keystone_tpu/loaders/csv_loader.py`` (reference
``loaders/CsvDataLoader.scala:10-30`` and ``loaders/LabeledData.scala``).
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

from ..parallel.dataset import ArrayDataset


def load_csv(path: str, dtype=np.float32) -> np.ndarray:
    """One CSV file, a directory of CSV files or a glob, as one row
    matrix on the host (files in sorted order)."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*")))
    else:
        files = sorted(glob.glob(path)) or [path]
    parts = [np.loadtxt(f, delimiter=",", dtype=dtype, ndmin=2) for f in files]
    return np.concatenate(parts, axis=0)


@dataclass
class LabeledData:
    """Bundles a data dataset and its labels (reference
    ``loaders/LabeledData.scala:8-15``)."""

    data: ArrayDataset
    labels: ArrayDataset

    def to(self, device) -> "LabeledData":
        """Both datasets on ``device``."""
        return LabeledData(self.data.to(device), self.labels.to(device))
