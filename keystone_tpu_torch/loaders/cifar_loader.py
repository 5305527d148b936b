"""CIFAR-10 binary loader (reference ``loaders/CifarLoader.scala:14-51``).

Counterpart of ``keystone_tpu/loaders/cifar_loader.py``, decoding with
numpy (the JAX package's pure-Python decode branch; its native C++ shim
is not used by the port). Record layout: 1 label byte + 3072 pixel bytes
(1024 R, 1024 G, 1024 B, each a row-major 32x32 plane). Pixels stay in
[0, 255] as float32, or uint8 with ``packed=True``.
"""
from __future__ import annotations

import glob
import os

import numpy as np

from ..ops.device import DEFAULT_DEVICE
from ..parallel.dataset import ArrayDataset
from .csv_loader import LabeledData

NROW, NCOL, NCHAN = 32, 32, 3
RECORD = 1 + NROW * NCOL * NCHAN


def cifar_decode(raw: bytes, rows: int = NROW, cols: int = NCOL,
                 chans: int = NCHAN, packed: bool = False):
    """CIFAR binary records -> (images (n, rows, cols, chans), labels
    int32 (n,)); images float32 in [0, 255], or uint8 when ``packed``."""
    rec = 1 + rows * cols * chans
    if len(raw) % rec:
        raise ValueError("corrupt CIFAR buffer")
    arr = np.frombuffer(raw, np.uint8).reshape(len(raw) // rec, rec)
    labels = arr[:, 0].astype(np.int32)
    planes = arr[:, 1:].reshape(-1, chans, rows, cols).transpose(0, 2, 3, 1)
    # row-major (n, rows, cols, chans): ``astype`` would keep the planes'
    # transposed strides, and the device kernels read rows in place
    images = np.ascontiguousarray(planes,
                                  dtype=np.uint8 if packed else np.float32)
    return images, labels


def load_cifar_numpy(path: str, packed: bool = False):
    """Returns (images (n,32,32,3), labels (n,) int32) from one file, a
    directory of ``*.bin`` files, or a glob."""
    if os.path.isdir(path):
        files = sorted(glob.glob(os.path.join(path, "*.bin")))
    else:
        files = sorted(glob.glob(path)) or [path]
    imgs, labels = [], []
    for f in files:
        with open(f, "rb") as fh:
            i, lab = cifar_decode(fh.read(), packed=packed)
        imgs.append(i)
        labels.append(lab)
    return np.concatenate(imgs), np.concatenate(labels)


def cifar_loader(path: str, packed: bool = False,
                 device=DEFAULT_DEVICE) -> LabeledData:
    images, labels = load_cifar_numpy(path, packed=packed)
    pk = ":u8" if packed else ""
    return LabeledData(
        data=ArrayDataset.from_numpy(images, device,
                                     tag=f"cifar:{path}{pk}:data"),
        labels=ArrayDataset.from_numpy(labels, device,
                                       tag=f"cifar:{path}:labels"),
    )
