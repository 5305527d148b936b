"""Data loaders (reference ``loaders/``).

Counterpart of ``keystone_tpu/loaders``: CIFAR binaries, CSV files,
TIMIT features and tar archives of images (VOC, ImageNet). The text
loaders (20 Newsgroups, Amazon reviews) come with ROADMAP A8.
"""
from .cifar_loader import cifar_loader, load_cifar_numpy
from .csv_loader import (
    LabeledData,
    csv_data_loader,
    csv_labeled_loader,
    load_csv,
)
from .image_loader_utils import (
    LabeledImage,
    MultiLabeledImage,
    decode_image,
    iter_tar_images,
    list_archive_paths,
    load_tar_files,
)
from .imagenet import imagenet_loader, parse_imagenet_labels
from .timit import TimitFeaturesData, timit_features_loader
from .voc import VOCDataPath, VOCLabelPath, parse_voc_labels, voc_loader

__all__ = [
    "cifar_loader",
    "load_cifar_numpy",
    "LabeledData",
    "csv_data_loader",
    "csv_labeled_loader",
    "load_csv",
    "LabeledImage",
    "MultiLabeledImage",
    "decode_image",
    "iter_tar_images",
    "list_archive_paths",
    "load_tar_files",
    "imagenet_loader",
    "parse_imagenet_labels",
    "TimitFeaturesData",
    "timit_features_loader",
    "VOCDataPath",
    "VOCLabelPath",
    "parse_voc_labels",
    "voc_loader",
]
