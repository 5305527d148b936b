"""Data loaders (reference ``loaders/``).

Counterpart of ``keystone_tpu/loaders``: CIFAR binaries, CSV files,
TIMIT features, tar archives of images (VOC, ImageNet), and text (20
Newsgroups directories, Amazon reviews as JSON lines).
"""
from .amazon import amazon_reviews_loader
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
from .newsgroups import CLASSES as NEWSGROUPS_CLASSES, newsgroups_loader
from .timit import TimitFeaturesData, timit_features_loader
from .voc import VOCDataPath, VOCLabelPath, parse_voc_labels, voc_loader

__all__ = [
    "amazon_reviews_loader",
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
    "NEWSGROUPS_CLASSES",
    "newsgroups_loader",
    "TimitFeaturesData",
    "timit_features_loader",
    "VOCDataPath",
    "VOCLabelPath",
    "parse_voc_labels",
    "voc_loader",
]
