"""The LabeledData wrapper (reference ``loaders/LabeledData.scala``).

Counterpart of ``LabeledData`` in ``keystone_tpu/loaders/csv_loader.py``;
the CSV loaders there are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..parallel.dataset import ArrayDataset


@dataclass
class LabeledData:
    """Bundles a data dataset and its labels (reference
    ``loaders/LabeledData.scala:8-15``)."""

    data: ArrayDataset
    labels: ArrayDataset

    def to(self, device) -> "LabeledData":
        """Both datasets on ``device``."""
        return LabeledData(self.data.to(device), self.labels.to(device))
