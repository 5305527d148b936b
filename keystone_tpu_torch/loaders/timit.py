"""TIMIT pre-featurized data loader.

Counterpart of ``keystone_tpu/loaders/timit.py`` (reference
``loaders/TimitFeaturesDataLoader.scala``). Features are CSV rows of 440
numbers; a labels file holds ``row label`` lines, both 1-based, over 147
phone classes. The datasets are staged on ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import ArrayDataset
from .csv_loader import LabeledData, load_csv

TIMIT_DIMENSION = 440
NUM_CLASSES = 147


def _parse_sparse_labels(path: str, n: int) -> np.ndarray:
    """``row label`` lines, both 1-based; the stored label less one
    (reference ``TimitFeaturesDataLoader.scala:22-44``). Every row must
    have a label."""
    labels = np.zeros(n, dtype=np.int32)
    seen = np.zeros(n, dtype=bool)
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            row = int(parts[0]) - 1
            labels[row] = int(parts[1]) - 1
            seen[row] = True
    if not seen.all():
        raise ValueError(f"labels file {path} is missing rows")
    return labels


@dataclass
class TimitFeaturesData:
    train: LabeledData
    test: LabeledData


def timit_features_loader(train_data_path: str, train_labels_path: str,
                          test_data_path: str, test_labels_path: str,
                          device=DEFAULT_DEVICE) -> TimitFeaturesData:
    def split(data_path, labels_path):
        feats = load_csv(data_path)
        labels = _parse_sparse_labels(labels_path, feats.shape[0])
        return LabeledData(ArrayDataset.from_numpy(feats, device),
                           ArrayDataset.from_numpy(labels, device))

    return TimitFeaturesData(
        train=split(train_data_path, train_labels_path),
        test=split(test_data_path, test_labels_path))
