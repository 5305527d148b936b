"""Datasets and the streamed fit of the port (counterpart of
``keystone_tpu/parallel``): resident datasets (:mod:`.dataset`) and
chunked streaming with ``fit_streaming`` (:mod:`.streaming`). The mesh
and the multi-process world are ROADMAP A11."""
from .dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    as_dataset,
    device_nbytes,
    ensure_array,
    to_numpy,
)
from .streaming import StreamingDataset, fit_streaming, is_streamable

__all__ = [
    "ArrayDataset",
    "Dataset",
    "HostDataset",
    "StreamingDataset",
    "as_dataset",
    "device_nbytes",
    "ensure_array",
    "fit_streaming",
    "is_streamable",
    "to_numpy",
]
