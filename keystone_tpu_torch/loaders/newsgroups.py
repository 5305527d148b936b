"""20 Newsgroups loader (reference ``loaders/NewsgroupsDataLoader.scala``).

Counterpart of ``keystone_tpu/loaders/newsgroups.py``. A split directory
holds one directory a class, named as in :data:`CLASSES`, with one plain
text file a document; a class's integer label is its position in the
class list. Texts stay host items; the labels are staged on ``device``.
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import ArrayDataset, HostDataset
from .csv_loader import LabeledData

CLASSES = [
    "comp.graphics",
    "comp.os.ms-windows.misc",
    "comp.sys.ibm.pc.hardware",
    "comp.sys.mac.hardware",
    "comp.windows.x",
    "rec.autos",
    "rec.motorcycles",
    "rec.sport.baseball",
    "rec.sport.hockey",
    "sci.crypt",
    "sci.electronics",
    "sci.med",
    "sci.space",
    "misc.forsale",
    "talk.politics.misc",
    "talk.politics.guns",
    "talk.politics.mideast",
    "talk.religion.misc",
    "alt.atheism",
    "soc.religion.christian",
]


def newsgroups_loader(data_dir: str, classes: Optional[Sequence[str]] = None,
                      device=DEFAULT_DEVICE) -> LabeledData:
    """Load one split directory, class by class and file by file in name
    order; a missing class directory is skipped (the reference unions
    one ``wholeTextFiles`` set a class)."""
    classes = list(classes) if classes is not None else CLASSES
    texts: List[str] = []
    labels: List[int] = []
    for index, name in enumerate(classes):
        class_dir = os.path.join(data_dir, name)
        if not os.path.isdir(class_dir):
            continue
        for fname in sorted(os.listdir(class_dir)):
            path = os.path.join(class_dir, fname)
            if os.path.isfile(path):
                with open(path, "r", errors="replace") as f:
                    texts.append(f.read())
                labels.append(index)
    return LabeledData(
        data=HostDataset(texts),
        labels=ArrayDataset.from_numpy(np.asarray(labels, np.int32), device),
    )
