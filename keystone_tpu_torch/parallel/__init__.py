"""Datasets, the streamed fit and the multi-process world of the port
(counterpart of ``keystone_tpu/parallel``): resident datasets
(:mod:`.dataset`), chunked streaming with ``fit_streaming``
(:mod:`.streaming`), the mesh of ranks and the world's start-up
(:mod:`.mesh`), the coordination rounds, deterministic collectives and
the dryrun launcher (:mod:`.distributed`), and the sharded apply
(:mod:`.spmd_apply`)."""
from .dataset import (
    ArrayDataset,
    Dataset,
    HostDataset,
    as_dataset,
    device_nbytes,
    ensure_array,
    to_numpy,
)
from .distributed import (
    DryrunWorld,
    WorldCoordinator,
    is_distributed,
    process_count,
    process_index,
)
from .streaming import StreamingDataset, fit_streaming, is_streamable

__all__ = [
    "ArrayDataset",
    "Dataset",
    "DryrunWorld",
    "HostDataset",
    "StreamingDataset",
    "WorldCoordinator",
    "as_dataset",
    "device_nbytes",
    "ensure_array",
    "fit_streaming",
    "is_distributed",
    "is_streamable",
    "process_count",
    "process_index",
    "to_numpy",
]
