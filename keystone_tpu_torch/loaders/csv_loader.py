"""CSV loading and the LabeledData wrapper.

Counterpart of ``keystone_tpu/loaders/csv_loader.py`` (reference
``loaders/CsvDataLoader.scala:10-30`` and ``loaders/LabeledData.scala``):
the files are parsed on the host and the datasets staged on ``device``.
"""
from __future__ import annotations

import glob
import os
from dataclasses import dataclass

import numpy as np

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import ArrayDataset, HostDataset


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
        """Both datasets on ``device``; host items (texts, SparseVectors)
        stay on the host."""
        data = (self.data if isinstance(self.data, HostDataset)
                else self.data.to(device))
        return LabeledData(data, self.labels.to(device))


def csv_data_loader(path: str, device=DEFAULT_DEVICE) -> ArrayDataset:
    """The rows of one CSV file, a directory or a glob, on ``device``."""
    return ArrayDataset.from_numpy(load_csv(path), device)


def csv_labeled_loader(path: str, label_col: int = 0, label_offset: int = 0,
                       device=DEFAULT_DEVICE) -> LabeledData:
    """Rows of ``[label, features...]`` (the label in ``label_col``):
    float32 features and int32 labels less ``label_offset`` (MNIST's CSVs
    count from 1, reference ``MnistRandomFFT.scala:35-38``), both on
    ``device``."""
    raw = load_csv(path)
    labels = raw[:, label_col].astype(np.int32) - label_offset
    feats = np.delete(raw, label_col, axis=1)
    return LabeledData(ArrayDataset.from_numpy(feats, device),
                       ArrayDataset.from_numpy(labels, device))
