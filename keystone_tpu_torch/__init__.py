"""keystone_tpu_torch: the PyTorch / CUDA port of keystone_tpu.

The same pipeline framework as the JAX package ``keystone_tpu`` —
composable Transformer/Estimator pipelines over an optimizing DAG —
working on torch tensors on one NVIDIA Hopper GPU, with the JAX
package's Pallas TPU kernels rewritten by hand in CUDA C++. The port
never imports JAX or the JAX package. Entry points run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""
from .ops.device import resolve_device
from .parallel.dataset import ArrayDataset, Dataset, HostDataset, as_dataset
from .parallel.streaming import StreamingDataset, fit_streaming
from .workflow import (
    Cacher,
    Estimator,
    FittedPipeline,
    Identity,
    LabelEstimator,
    Pipeline,
    PipelineDataset,
    PipelineDatum,
    PipelineEnv,
    Transformer,
    transformer,
)

__all__ = [
    "resolve_device",
    "ArrayDataset",
    "Dataset",
    "HostDataset",
    "as_dataset",
    "StreamingDataset",
    "fit_streaming",
    "Cacher",
    "Estimator",
    "FittedPipeline",
    "Identity",
    "LabelEstimator",
    "Pipeline",
    "PipelineDataset",
    "PipelineDatum",
    "PipelineEnv",
    "Transformer",
    "transformer",
]
